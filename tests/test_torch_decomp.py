"""Port parity: corridor/decomp.py (batched over stage lanes) and
ops/corridor_kernel.py's plain version against the JAX decompose_segment
at f64 on generic random segments and clouds (the inputs of
tools/kernel_parity_debug.py): the two cap sets of that tool, the default
caps, and one obstacle-compaction case.  A, b and the ellipsoid within
1e-9 absolute on every row.  The CUDA kernel is held against the plain
version on the card (cuda-marked test, and chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cuda_emu
from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.corridor import decomp as jd
from forces_resilient_planner_tpu_torch.corridor import decomp as td
from forces_resilient_planner_tpu_torch.ops import corridor_kernel

TOL = 1e-9

CAPS = {
    "caps24_shrink6": dataclasses.replace(
        C.corridor, shrink_iters=6, max_obs_planes=24, max_active_obstacles=0),
    "caps12_shrink4": dataclasses.replace(
        C.corridor, shrink_iters=4, max_obs_planes=12, max_active_obstacles=0),
    "default": C.corridor,
    "compact16": dataclasses.replace(
        C.corridor, shrink_iters=6, max_active_obstacles=16),
}


def _inputs(B=2, N=3, M=96, seed=31, length=0.1):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform([-1, -1, 0.8], [1, 1, 1.6], (B, N, 3))
    yaw = rng.uniform(-np.pi, np.pi, (B, N))
    p2 = p1 + length * np.stack([np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)],
                                -1)
    obs = rng.uniform([-3, -3, -0.5], [3, 3, 3], (B, M, 3))
    mask = rng.uniform(size=(B, M)) < 0.9
    return p1, p2, obs, mask


def _jax_decomp(ccfg, p1, p2, obs, mask):
    f = jax.jit(jax.vmap(jax.vmap(
        lambda a, b, o, m: jd.decompose_segment(a, b, o, m, ccfg, 30),
        in_axes=(0, 0, None, None))))
    return f(p1, p2, obs, mask)


@pytest.mark.parametrize("caps", list(CAPS))
def test_decompose_stages_matches_jax(caps):
    ccfg = CAPS[caps]
    p1, p2, obs, mask = _inputs()
    ref = _jax_decomp(ccfg, p1, p2, obs, mask)
    t = torch.as_tensor
    A, b = corridor_kernel.decompose_stages_reference(
        t(p1), t(p2), t(obs), t(mask), ccfg, 30)
    assert A.shape == (2, 3, 30, 3) and A.dtype == torch.float64
    np.testing.assert_allclose(A.numpy(), np.asarray(ref.A), rtol=0, atol=TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref.b), rtol=0, atol=TOL)
    seg = td.decompose_segment(t(p1), t(p2), t(obs)[:, None], t(mask)[:, None],
                               ccfg, 30)
    np.testing.assert_allclose(seg.ellipsoid_C.numpy(),
                               np.asarray(ref.ellipsoid_C), rtol=0, atol=TOL)
    # rows: peel planes (some valid), 6 walls (all valid), zero padding
    P = ccfg.max_obs_planes
    walls = A[:, :, P:P + 6].norm(dim=-1)
    assert torch.allclose(walls, torch.ones_like(walls))
    assert (A[:, :, P + 6:] == 0).all() and (b[:, :, P + 6:] == 0).all()


def test_lane_helpers_match_jax():
    p1, p2, obs, mask = _inputs(B=1, N=8, seed=3)
    p1, p2 = p1[0], p2[0]
    t = torch.as_tensor
    R_j = jax.vmap(jd.seed_rotation)(p1, p2)
    np.testing.assert_allclose(td.seed_rotation(t(p1), t(p2)).numpy(),
                               np.asarray(R_j), rtol=0, atol=1e-14)
    A = np.random.default_rng(2).normal(0, 1, (8, 3, 3))
    np.testing.assert_allclose(td.inv3(t(A)).numpy(),
                               np.asarray(jd.inv3(jnp.asarray(A))),
                               rtol=1e-12, atol=1e-12)
    bbox = jnp.asarray(C.corridor.local_bbox)
    m_j = jax.vmap(lambda a, b: jd.bbox_filter_obstacles(
        a, b, bbox, obs[0], mask[0], C.corridor.epsilon))(p1, p2)
    m_t = td.bbox_filter_obstacles(t(p1), t(p2), C.corridor.local_bbox,
                                   t(obs[0]), t(mask[0]), C.corridor.epsilon)
    assert np.array_equal(m_t.numpy(), np.asarray(m_j))


def test_decompose_stages_lanes_routes_cpu_to_plain():
    p1, p2, obs, mask = (torch.as_tensor(a) for a in _inputs(seed=7))
    launches = dict(corridor_kernel.LAUNCHES)
    got = corridor_kernel.decompose_stages_lanes(p1, p2, obs, mask,
                                                 CAPS["caps12_shrink4"], 30)
    ref = corridor_kernel.decompose_stages_reference(
        p1, p2, obs, mask, CAPS["caps12_shrink4"], 30)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert corridor_kernel.LAUNCHES == launches
    with pytest.raises(ValueError, match="no route"):
        corridor_kernel.decompose_stages_lanes(
            p1.to("meta"), p2.to("meta"), obs.to("meta"), mask.to("meta"),
            C.corridor, 30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,M", [(torch.float64, 256),
                                     (torch.float64, 2048)])
def test_kernel_matches_plain_on_cuda(dtype, M):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p1, p2, obs, mask = _inputs(B=16, N=C.model.N, M=M, seed=11)
    args = [torch.as_tensor(a, device="cuda") for a in (p1, p2, obs, mask)]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    launches = corridor_kernel.LAUNCHES["corridor"]
    A, b = corridor_kernel.decompose_stages_lanes(*args, C.corridor, 30)
    Ar, br = corridor_kernel.decompose_stages_reference(*args, C.corridor, 30)
    torch.cuda.synchronize()
    assert corridor_kernel.LAUNCHES["corridor"] == launches + 1
    assert (A - Ar).abs().max().item() <= TOL
    assert (b - br).abs().max().item() <= TOL


def _hand_scene():
    """One stage, p1 (0, 0, 1) -> p2 (1, 0, 1), local bbox (2, 2, 1): the
    sphere has radius 0.5 about (0.5, 0, 1).  Obstacles: 0 and 1 in the
    box at ellipsoid distance 1.6 on either side (a tie), 2 on the sphere
    (distance 1), 3 outside the box, 4 masked out."""
    p1 = np.array([[[0.0, 0.0, 1.0]]])
    p2 = np.array([[[1.0, 0.0, 1.0]]])
    obs = np.array([[[0.5, 0.8, 1.0], [0.5, -0.8, 1.0], [1.0, 0.0, 1.0],
                     [10.0, 10.0, 10.0], [0.5, 0.5, 1.0]]])
    mask = np.array([[True, True, True, True, False]])
    return p1, p2, obs, mask


def test_work_count_matches_hand_count():
    """The sets of every executed round, counted by hand on _hand_scene: 4
    valid obstacles to bbox-test; the sphere test over the box set {0, 1,
    2}; the seed ellipsoid over the sphere set {2}; one phase-1 round over
    {2} (2 stays on the boundary and leaves); the reset ellipsoid over {2}
    and one phase-2 round over {2}; the peel's distances over {0, 1, 2}
    less {2}, which the last round took under the same ellipsoid; then
    rounds over {0, 1, 2} (plane at 2), {0, 1} (the tie goes to 0) and
    {1}."""
    t = torch.as_tensor
    args = [t(a) for a in _hand_scene()]
    work = corridor_kernel.decompose_stages_work(*args, C.corridor)
    assert work == {"stages": 1, "bbox": 4, "sphere": 3,
                    "dist": 1 + 1 + 1 + 1 + 2, "reset": 1, "shrink1": 1,
                    "shrink2": 1, "peel": 3, "halfspace": 3 + 2 + 1}
    ops = corridor_kernel.work_operations(work)
    per = corridor_kernel.OPS_PER
    assert ops == (per["stages"] + 4 * per["bbox"] + 3 * per["sphere"]
                   + 6 * per["dist"] + per["reset"] + per["shrink1"]
                   + per["shrink2"] + 3 * per["peel"] + 6 * per["halfspace"])
    assert ops == 227 + 4 * 19 + 3 * 12 + 6 * 21 + 62 + 134 + 85 + 3 * 35 + 6 * 8
    A, b = corridor_kernel.decompose_stages_reference(*args, C.corridor, 30)
    want_A = np.zeros((30, 3))
    want_b = np.zeros(30)
    want_A[:3] = [[1, 0, 0], [0, 1, 0], [0, -1, 0]]
    want_b[:3] = [1.0, 0.8, 0.8]
    np.testing.assert_allclose(A[0, 0, :24].numpy(), want_A[:24], atol=1e-15)
    np.testing.assert_allclose(b[0, 0, :24].numpy(), want_b[:24], atol=1e-15)


def _check_work_against_plain_rows(length):
    """On random inputs the counts agree with what the plain version
    returns: one peel round per peel row it wrote, bbox tests over the
    valid obstacles, and every set within its bound."""
    p1, p2, obs, mask = (torch.as_tensor(a) for a in _inputs(
        B=2, N=4, M=64, seed=5, length=length))
    ccfg = C.corridor
    work = corridor_kernel.decompose_stages_work(p1, p2, obs, mask, ccfg)
    A, _ = corridor_kernel.decompose_stages_reference(p1, p2, obs, mask, ccfg)
    P = ccfg.max_obs_planes
    stages = 2 * 4
    assert work["stages"] == stages
    assert work["bbox"] == 4 * int(mask.sum())
    assert work["peel"] == int((A[..., :P, :].norm(dim=-1) > 0).sum()) > 0
    assert work["peel"] <= work["halfspace"] <= work["peel"] * 64
    assert work["sphere"] <= work["bbox"]
    assert (work["shrink1"] > 0) == (work["reset"] > 0) == (length > 1)
    assert work["reset"] <= work["shrink1"] <= stages * ccfg.shrink_iters
    assert work["shrink2"] <= stages * ccfg.shrink_iters


def test_work_count_on_random_inputs_is_bounded_by_the_caps():
    """Segments of 0.1 m: no shrink round runs."""
    _check_work_against_plain_rows(0.1)


def test_work_count_when_both_shrink_phases_run():
    """Segments of 2 m run both shrink phases."""
    _check_work_against_plain_rows(2.0)


# ---- the CUDA source's arithmetic on the CPU (g++ and tests/cuda_emu) -----

@pytest.fixture(scope="module")
def emulated_corridor(tmp_path_factory):
    """csrc/corridor.cu built with g++ against the host stand-in of the
    CUDA runtime (a thread per CUDA thread, per-group masked shuffles,
    ballots and barriers)."""
    return _cuda_emu.build(corridor_kernel.SOURCE,
                           tmp_path_factory.mktemp("emu"),
                           corridor_kernel._bind)


def _emulated_rows(lib, args, group=0, ccfg=C.corridor):
    args = [a.contiguous() for a in args]
    return corridor_kernel.launch(lib, *args, ccfg, 30, None, group)[:2]


@pytest.mark.parametrize("M,group,length", [
    (64, 0, 0.1), (61, 0, 0.1), (64, 4, 0.1), (61, 16, 0.1), (61, 32, 0.1),
    (64, 0, 2.0), (61, 16, 2.0)])
def test_kernel_source_matches_plain_at_f64_on_cpu(emulated_corridor, M,
                                                   group, length):
    """A and b within 1e-9 on every row at B = 3, N = 4, default caps, with
    the default 8 lanes per stage and with 4, 16 and 32, at an M that is and
    one that is not a multiple of the group; segments of 2 m run both
    shrink phases."""
    args = [torch.as_tensor(a) for a in _inputs(B=3, N=4, M=M, seed=M,
                                                length=length)]
    work = corridor_kernel.decompose_stages_work(*args, C.corridor)
    assert (work["shrink1"] > 0 and work["shrink2"] > 0) == (length > 1)
    A, b = _emulated_rows(emulated_corridor, args, group)
    Ar, br = corridor_kernel.decompose_stages_reference(*args, C.corridor, 30)
    assert (A - Ar).abs().max().item() <= TOL
    assert (b - br).abs().max().item() <= TOL
    assert (Ar[..., :C.corridor.max_obs_planes, :].norm(dim=-1) > 0).any()


def test_kernel_source_matches_plain_in_its_wide_build(emulated_corridor):
    """32 lanes per stage at N = 10: a CTA of 10 warps, past the 8 of the
    build capped at 64 registers, runs the wide build; A and b within 1e-9
    on every row, both shrink phases run."""
    args = [torch.as_tensor(a) for a in _inputs(B=2, N=10, M=45, seed=12,
                                                length=2.0)]
    assert corridor_kernel.launch_geometry(emulated_corridor, 2, 10, 45,
                                           torch.float64,
                                           group=32).threads == 320
    A, b = _emulated_rows(emulated_corridor, args, 32)
    Ar, br = corridor_kernel.decompose_stages_reference(*args, C.corridor, 30)
    assert (A - Ar).abs().max().item() <= TOL
    assert (b - br).abs().max().item() <= TOL
    work = corridor_kernel.decompose_stages_work(*args, C.corridor)
    assert work["shrink1"] > 0 and work["shrink2"] > 0


def test_kernel_source_widens_its_groups_with_the_cloud(emulated_corridor):
    """At N = 20 every stage gets its own group of lanes in one CTA; the
    group widens as the cloud grows, so that an SM still holds 16 warps of
    such CTAs: 8 lanes per stage up to M = 512, 16 at 1024, 32 at 2048;
    every CTA fits 227 KB of shared memory."""
    f32, f64 = torch.float32, torch.float64
    for dtype, M, lanes, threads in ((f32, 256, 8, 160), (f32, 512, 8, 160),
                                     (f32, 1024, 16, 320),
                                     (f32, 2048, 32, 640),
                                     (f64, 256, 8, 160),
                                     (f64, 2048, 32, 640)):
        got = corridor_kernel.launch_geometry(emulated_corridor, 4096, 20, M,
                                              dtype)
        assert (got.route, got.lanes, got.threads) == (1, lanes, threads), (
            dtype, M, got)
        values = 4 * M * torch.empty((), dtype=dtype).element_size()
        assert got.smem == values + 20 * 4 * M <= 232448


def test_kernel_source_breaks_ties_to_the_lower_index(emulated_corridor):
    """_hand_scene's obstacles 0 and 1 lie at the same ellipsoid distance:
    the second peel row is obstacle 0's plane, the third obstacle 1's."""
    args = [torch.as_tensor(a) for a in _hand_scene()]
    A, b = _emulated_rows(emulated_corridor, args)
    assert A[0, 0, :3].tolist() == [[1, 0, 0], [0, 1, 0], [0, -1, 0]]
    assert b[0, 0, :3].tolist() == [1.0, 0.8, 0.8]
    assert (A[0, 0, 3:24] == 0).all() and (b[0, 0, 3:24] == 0).all()


def test_kernel_source_results_do_not_depend_on_their_slot(
        emulated_corridor):
    """Permuting the scenarios and the stages permutes the rows bit for
    bit."""
    p1, p2, obs, mask = (torch.as_tensor(a) for a in _inputs(B=3, N=5, M=40,
                                                            seed=9))
    A, b = _emulated_rows(emulated_corridor, (p1, p2, obs, mask))
    gen = torch.Generator().manual_seed(4)
    sb, sn = torch.randperm(3, generator=gen), torch.randperm(5, generator=gen)
    Ap, bp = _emulated_rows(emulated_corridor, (
        p1[sb][:, sn], p2[sb][:, sn], obs[sb], mask[sb]))
    assert torch.equal(Ap, A[sb][:, sn]) and torch.equal(bp, b[sb][:, sn])
