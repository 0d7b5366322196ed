"""The corridor decomposition's tie rules and K3's two routes, at f64.

(a) On voxel-centre clouds (mapping/occ_grid.py::occupied_cloud's points: a
25 x 25 x 9 grid at 0.1 m, 15% occupied, shuffled) with axis-aligned
0.1 m segments from grid points, many obstacles tie in exact arithmetic,
so rounding decides the argmins and the peel's signs: the port's
decompose_segment gives the jitted JAX function's rows (A, b within 1e-12,
the planes in the same order) with the compaction off and at k = 16 and
64.  (b) csrc/corridor.cu built for the CPU (tests/_cuda_emu.py), each
route forced by the launch's test hook or chosen by the kernel: rows equal
to the plain version's on a small cloud, on a voxel cloud, with the
compaction over exact distance ties and on a cloud of 70,000 obstacles
whose only in-bbox one lies past index 65,535.  (c) The route and the
scratch that the CPU build's launch_geometry gives for (M, dtype, k).
(d) The single-robot step (engine/pipeline.py::nmpc_step) with
max_active_obstacles = 16 on a 64-point voxel cloud equals JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cuda_emu
from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.corridor import decomp as jd
from forces_resilient_planner_tpu.engine import pipeline as jp
from forces_resilient_planner_tpu_torch.corridor import decomp as td
from forces_resilient_planner_tpu_torch.engine import pipeline as tp
from forces_resilient_planner_tpu_torch.engine import pipeline_batch as tpb
from forces_resilient_planner_tpu_torch.ops import corridor_kernel
from test_pipeline import make_inputs

ROW_TOL = 1e-12
KS = (0, 16, 64)
GRID, RES, ORIGIN = (25, 25, 9), 0.1, np.array([-1.25, -1.25, 0.0])


def voxel_cloud(seed, frac=0.15):
    """Occupied voxel centres (idx + 0.5) res + origin, shuffled."""
    rng = np.random.default_rng(seed)
    idx = np.stack(np.meshgrid(*[np.arange(s) for s in GRID], indexing="ij"),
                   -1).reshape(-1, 3)
    pts = (idx[rng.uniform(size=len(idx)) < frac] + 0.5) * RES + ORIGIN
    rng.shuffle(pts)
    return pts


def axis_segments(seed, n):
    """0.1 m segments along +-x, +-y or +-z from grid points."""
    rng = np.random.default_rng(seed + 1000)
    p1 = rng.integers(5, 20, (n, 3)) * RES + ORIGIN
    p1[:, 2] = rng.integers(2, 7, n) * RES + ORIGIN[2]
    step = np.zeros((n, 3))
    step[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-RES, RES], n)
    return p1, p1 + step


CLOUDS = [voxel_cloud(s) for s in (0, 1)]
N_SEG = 16


def _ccfg(k):
    return dataclasses.replace(C.corridor, max_active_obstacles=k)


@pytest.fixture(scope="module")
def jax_rows():
    """JAX's rows as build_corridors runs decompose_segment (jitted, vmapped
    over the segments, the cloud shared), one program per k, both clouds
    padded to one size."""
    M = max(len(c) for c in CLOUDS)
    out = {}
    for k in KS:
        f = jax.jit(jax.vmap(
            lambda a, b, o, m, k=k: jd.decompose_segment(a, b, o, m, _ccfg(k),
                                                         30),
            in_axes=(0, 0, None, None)))
        for s, cloud in enumerate(CLOUDS):
            obs = np.zeros((M, 3))
            obs[:len(cloud)] = cloud
            mask = np.arange(M) < len(cloud)
            p1, p2 = axis_segments(s, N_SEG)
            r = f(p1, p2, obs, mask)
            out[k, s] = (p1, p2, obs, mask, np.asarray(r.A), np.asarray(r.b))
    return out


@pytest.mark.parametrize("k", KS)
def test_voxel_cloud_rows_match_jax(jax_rows, k):
    for s in range(len(CLOUDS)):
        p1, p2, obs, mask, A, b = jax_rows[k, s]
        t = torch.as_tensor
        got = td.decompose_segment(t(p1), t(p2), t(obs)[None], t(mask)[None],
                                   _ccfg(k), 30)
        np.testing.assert_allclose(got.A.numpy(), A, rtol=0, atol=ROW_TOL)
        np.testing.assert_allclose(got.b.numpy(), b, rtol=0, atol=ROW_TOL)
        # the peel planes exist and are ordered alike (zero rows included)
        P = C.corridor.max_obs_planes
        assert np.array_equal(np.abs(got.A[:, :P].numpy()).sum(-1) > 0,
                              np.abs(A[:, :P]).sum(-1) > 0)
        assert (np.abs(A[:, :P]).sum(-1) > 0).sum() > 2 * N_SEG


def test_compaction_keeps_top_k_order_over_ties():
    """Six obstacles at squared distance 0.25 from the midpoint (exact in
    binary) and k = 4: the four of lowest index, in index order, as
    jax.lax.top_k orders equal scores; the nearer one first."""
    p1 = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    p2 = torch.tensor([[0.5, 0.0, 1.0]], dtype=torch.float64)
    obs = torch.tensor([[0.25, 0.0, 1.5], [0.25, 0.5, 1.0], [0.75, 0.0, 1.0],
                        [0.25, 0.0, 0.5], [0.25, 0.1, 1.0], [-0.25, 0.0, 1.0],
                        [0.25, -0.5, 1.0]], dtype=torch.float64)
    got, mask = td.compact_obstacles(p1, p2, C.corridor.local_bbox, obs,
                                     torch.ones(7, dtype=torch.bool), 4,
                                     C.corridor.epsilon)
    assert mask.all()
    assert torch.equal(got[0], obs[[4, 0, 1, 2]])
    ref, _ = jd.compact_obstacles(jnp.asarray(p1[0]), jnp.asarray(p2[0]),
                                  jnp.asarray(C.corridor.local_bbox),
                                  jnp.asarray(obs), jnp.ones(7, bool), 4,
                                  C.corridor.epsilon)
    assert np.array_equal(np.asarray(ref), got[0].numpy())


# ---- csrc/corridor.cu on the CPU (g++ and tests/cuda_emu) ------------------

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _cuda_emu.build(corridor_kernel.SOURCE,
                           tmp_path_factory.mktemp("emu_routes"),
                           corridor_kernel._bind)


def _random_inputs(B=3, N=4, M=64, seed=5, length=2.0):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform([-1, -1, 0.8], [1, 1, 1.6], (B, N, 3))
    yaw = rng.uniform(-np.pi, np.pi, (B, N))
    p2 = p1 + length * np.stack([np.cos(yaw), np.sin(yaw),
                                 np.zeros_like(yaw)], -1)
    obs = rng.uniform([-3, -3, -0.5], [3, 3, 3], (B, M, 3))
    mask = rng.uniform(size=(B, M)) < 0.9
    return [torch.as_tensor(a) for a in (p1, p2, obs, mask)]


def _voxel_inputs(seed=0, n=8):
    cloud = voxel_cloud(seed)
    p1, p2 = axis_segments(seed, n)
    return [torch.as_tensor(p1)[None], torch.as_tensor(p2)[None],
            torch.as_tensor(cloud)[None],
            torch.ones(1, len(cloud), dtype=torch.bool)]


def _held(lib, args, k=0, route=0, group=0):
    """The emulated kernel's rows equal the plain version's bit for bit;
    returns the launch's geometry and the rows."""
    args = [a.contiguous() for a in args]
    A, b, geo = corridor_kernel.launch(lib, *args, _ccfg(k), 30, None, group,
                                       route)
    Ar, br = corridor_kernel.decompose_stages_reference(*args, _ccfg(k), 30)
    assert torch.equal(A, Ar) and torch.equal(b, br), (
        (A - Ar).abs().max().item(), (b - br).abs().max().item())
    return geo, Ar


@pytest.mark.parametrize("route,k,group", [
    (1, 0, 0), (2, 0, 0), (2, 0, 4), (2, 0, 32), (0, 16, 0), (0, 16, 16)])
def test_kernel_routes_match_plain_on_a_small_cloud(emulated, route, k, group):
    """Both shrink phases run (2 m segments); the gathered route forced,
    with its own lanes per stage and with 4 and 32, and the compaction
    (chosen by the kernel: the gathered route)."""
    geo, A = _held(emulated, _random_inputs(), k, route, group)
    assert geo.route == (route or 2)
    assert geo.scratch > 0 if geo.route == 2 else geo.scratch == 0
    assert (A[..., :C.corridor.max_obs_planes, :].norm(dim=-1) > 0).any()


@pytest.mark.parametrize("route,k", [(1, 0), (2, 0), (0, 16), (0, 64)])
def test_kernel_routes_match_plain_on_a_voxel_cloud(emulated, route, k):
    geo, _ = _held(emulated, _voxel_inputs(), k, route)
    assert geo.route == (route or 2)


def test_gathered_compaction_breaks_distance_ties_by_index(emulated):
    """Eight obstacles tie at squared distance 0.25 from each stage's
    midpoint, k = 5: the gathered route keeps the plain version's five,
    in its order, and so its rows."""
    p1 = torch.tensor([[[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]], dtype=torch.float64)
    p2 = torch.tensor([[[0.5, 0.0, 1.0], [0.0, 0.5, 1.0]]], dtype=torch.float64)
    ring = [[0.25, 0.5, 1.0], [0.25, -0.5, 1.0], [0.25, 0.0, 1.5],
            [0.25, 0.0, 0.5], [0.75, 0.0, 1.0], [-0.25, 0.0, 1.0],
            [0.25, 0.3, 1.4], [0.25, -0.3, 0.6]]
    far = [[1.5, 1.2, 1.0], [0.25, 0.0, 1.8], [-1.0, -1.0, 1.3]]
    obs = torch.tensor([far[0]] + ring[:4] + [far[1]] + ring[4:] + [far[2]],
                       dtype=torch.float64)[None]
    mask = torch.ones(1, len(obs[0]), dtype=torch.bool)
    geo, A = _held(emulated, (p1, p2, obs, mask), k=5)
    assert geo.route == 2
    assert (A[0, 0, :C.corridor.max_obs_planes].norm(dim=-1) > 0).sum() >= 2


def test_gathered_route_takes_indices_past_16_bits(emulated):
    """B = 1, N = 2, M = 70,000: every obstacle far away but one at index
    65,600 beside the segments; the kernel takes the gathered route by
    itself and its rows hold that obstacle's plane, as the plain
    version's."""
    M, near = 70_000, 65_600
    rng = np.random.default_rng(2)
    obs = rng.uniform([50.0, 50.0, 0.0], [60.0, 60.0, 3.0], (1, M, 3))
    obs[0, near] = [0.6, 0.35, 1.0]
    p1 = np.array([[[0.0, 0.0, 1.0], [0.5, 0.0, 1.0]]])
    p2 = np.array([[[0.5, 0.0, 1.0], [1.0, 0.0, 1.0]]])
    args = [torch.as_tensor(a) for a in (p1, p2, obs)] + [
        torch.ones(1, M, dtype=torch.bool)]
    geo, A = _held(emulated, args)
    assert geo.route == 2
    planes = A[0, :, :C.corridor.max_obs_planes].norm(dim=-1) > 0
    assert planes[:, 0].all() and not planes[:, 1:].any()


def test_route_choice_follows_shared_memory_and_compaction(emulated):
    """The shared route while the cloud and one group's lists fit a CTA's
    227 KB (4 M values + 4 M bytes: M <= 11,622 at f32, 6,456 at f64) and
    nothing is compacted; the gathered route past that, past 65,535, and
    for 0 < k < M; its scratch within 256 MiB per chunk of scenarios."""
    f32, f64 = torch.float32, torch.float64
    cases = [(f32, 256, 0, 1), (f32, 11_622, 0, 1), (f32, 11_623, 0, 2),
             (f64, 6_456, 0, 1), (f64, 6_457, 0, 2), (f64, 8_192, 0, 2),
             (f32, 16_384, 0, 2), (f32, 70_000, 0, 2), (f64, 70_000, 0, 2),
             (f32, 256, 16, 2), (f32, 2048, 64, 2), (f32, 256, 256, 1),
             (f64, 256, 300, 1)]
    for dtype, M, k, route in cases:
        geo = corridor_kernel.launch_geometry(
            emulated, 4096, 20, M, dtype,
            corridor_kernel.compaction_k(_ccfg(k), M))
        assert geo.route == route, (dtype, M, k, geo)
        if route == 1:
            assert geo.scratch == 0 and 0 < geo.smem <= 232_448
        else:
            assert geo.smem == 0 and 0 < geo.scratch <= (256 << 20) + 16
    # a chunk of all 8 scenarios; a scenario past the budget runs alone
    per_stage = 4 * (1 + 2 * 70_000)
    geo = corridor_kernel.launch_geometry(emulated, 8, 20, 70_000, f64)
    assert geo.scratch == 8 * 20 * per_stage + 16
    geo = corridor_kernel.launch_geometry(emulated, 8, 20, 4_000_000, f32)
    assert geo.scratch == 20 * 4 * (1 + 2 * 4_000_000) + 16


# ---- the single-robot step with the compaction -------------------------------

def test_single_step_with_compaction_matches_jax():
    """engine/pipeline.py::nmpc_step at f64 with max_active_obstacles = 16
    on a 64-point voxel cloud beside the path: the exit code and the
    corridors equal JAX's, mpc_output within 1e-6 (as the single step's
    parity test holds it)."""
    cfg = dataclasses.replace(C, corridor=_ccfg(16))
    a = {k: np.asarray(v) for k, v in make_inputs().items()}
    ix, iy, iz = np.meshgrid(np.arange(8), [-7, -6, 5, 6], [11, 12],
                             indexing="ij")
    cloud = (np.stack([ix, iy, iz], -1).reshape(-1, 3) + 0.5) * RES
    np.random.default_rng(4).shuffle(cloud)
    a["obstacles"], a["obstacle_mask"] = cloud, np.ones(64, bool)
    ref = jax.jit(lambda d: jp.nmpc_step(*[d[k] for k in tpb.PIPELINE_ARG_KEYS],
                                         cfg=cfg))(a)
    t = {k: torch.as_tensor(np.array(v)) for k, v in a.items()}
    got = tp.nmpc_step(*[t[k] for k in tpb.PIPELINE_ARG_KEYS], cfg=cfg)
    assert int(got.exit_code) == int(ref.exit_code) == 1
    np.testing.assert_allclose(got.corridor_A.numpy(),
                               np.asarray(ref.corridor_A), rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(got.corridor_b.numpy(),
                               np.asarray(ref.corridor_b), rtol=0, atol=ROW_TOL)
    P = C.corridor.max_obs_planes
    assert (np.abs(np.asarray(ref.corridor_A)[..., :P, :]).sum(-1) > 0).any()
    np.testing.assert_allclose(got.mpc_output.numpy(),
                               np.asarray(ref.mpc_output), rtol=0, atol=1e-6)
