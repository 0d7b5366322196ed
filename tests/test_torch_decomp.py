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


def _inputs(B=2, N=3, M=96, seed=31):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform([-1, -1, 0.8], [1, 1, 1.6], (B, N, 3))
    yaw = rng.uniform(-np.pi, np.pi, (B, N))
    p2 = p1 + 0.1 * np.stack([np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)], -1)
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
    launches = corridor_kernel.LAUNCHES
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
    launches = corridor_kernel.LAUNCHES
    A, b = corridor_kernel.decompose_stages_lanes(*args, C.corridor, 30)
    Ar, br = corridor_kernel.decompose_stages_reference(*args, C.corridor, 30)
    torch.cuda.synchronize()
    assert corridor_kernel.LAUNCHES == launches + 1
    assert (A - Ar).abs().max().item() <= TOL
    assert (b - br).abs().max().item() <= TOL
