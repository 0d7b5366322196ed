"""Port parity: the occupancy map of the torch port (mapping/occ_grid.py)
against the JAX package's at f64, on tests/test_mapping.py's small map.

The JAX side runs as the JAX package's callers run it: set_occupancy,
occupied_cloud and the depth projection outside jit (the planner's and
the fleet scene's calls), the raycast, voxel states and checks under jit
(XLA multiplies by 1 / res where the eager code divides; the port does
as each caller's JAX does).

Stated tolerances: buffers bit-equal after set_occupancy (masked and
out-of-map points included: both max the far-corner voxel, a behaviour of
the JAX package the port keeps) and after three raycast_update calls
(whose miss votes sit origin / res voxels off the ray in both packages);
voxel states, surround and state checks, and the occupied / history
clouds' masks and order identical; projected points within 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.mapping import occ_grid as jog
from forces_resilient_planner_tpu_torch.mapping import occ_grid as tog
from test_mapping import CFG
from _torch_threads import one_torch_thread  # noqa: F401

EGO_R, EGO_H = 0.27, 0.0425
F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _wall():
    ys = np.linspace(-1, 1, 21)
    zs = np.linspace(0.5, 1.5, 11)
    yy, zz = np.meshgrid(ys, zs)
    return np.stack([np.full(yy.size, 3.0), yy.ravel(), zz.ravel()], axis=-1)


@pytest.fixture(scope="module")
def grids():
    """The same occupancy in both packages: set_occupancy of random points
    with a mask and out-of-map points, then three raycast updates."""
    rng = np.random.default_rng(4)
    pts = rng.uniform([-6, -6, -2], [6, 6, 4], (400, 3))
    mask = rng.uniform(size=400) < 0.8
    cam = np.array([0.3, -0.2, 1.05])
    wall = _wall()
    valid = rng.uniform(size=len(wall)) < 0.9
    jg = jog.set_occupancy(jog.make_grid(CFG, jnp.float64), jnp.asarray(pts),
                           jnp.asarray(mask), CFG)
    tg = tog.set_occupancy(tog.make_grid(CFG, F64, device="cpu"), _t(pts),
                           torch.as_tensor(mask), CFG)
    set_j, set_t = np.asarray(jg.buffer), tg.buffer.numpy()
    ray = jax.jit(lambda g, p, v, c: jog.raycast_update(g, p, v, c, CFG))
    for _ in range(3):
        jg = ray(jg, jnp.asarray(wall), jnp.asarray(valid), jnp.asarray(cam))
        tg = tog.raycast_update(tg, _t(wall), torch.as_tensor(valid), _t(cam),
                                CFG)
    window = (np.array([0.5, -0.5, 0.2]), np.array([3.0, 2.0, 1.5]))
    jg = jog.update_local_window(jg, *map(jnp.asarray, window))
    tg = tog.update_local_window(tg, *map(_t, window))
    return dict(set_j=set_j, set_t=set_t, jg=jg, tg=tg, pts=pts, mask=mask)


def test_set_occupancy_bit_equal_and_masked_points_max_the_far_corner(grids):
    np.testing.assert_array_equal(grids["set_t"], grids["set_j"])
    # the JAX package's index -1 wraps to the last voxel of every axis
    assert not grids["mask"].all()
    assert grids["set_t"][-1, -1, -1] == CFG.clamp_max_log
    assert grids["set_j"][-1, -1, -1] == CFG.clamp_max_log
    occupied = int((grids["set_t"] == CFG.clamp_max_log).sum())
    idx = np.floor((grids["pts"] - np.asarray(CFG.origin)) / CFG.resolution)
    inside = np.all((idx >= 0) & (idx < np.asarray(CFG.grid_shape)), axis=1)
    kept = {tuple(i) for i in idx[grids["mask"] & inside].astype(int)}
    assert occupied == len(kept | {tuple(np.asarray(CFG.grid_shape) - 1)})


def test_raycast_update_bit_equal(grids):
    np.testing.assert_array_equal(grids["tg"].buffer.numpy(),
                                  np.asarray(grids["jg"].buffer))


def test_miss_votes_land_off_the_ray_in_both():
    """From a zero log-odds buffer one update lowers exactly the voxels the
    JAX package lowers: its traversal indices floor(p / res) lack the map
    origin, so the rays from x 0.3 to the wall at x 3.0 vote misses at
    world x < -1.9 (origin / res voxels away), while the hits sit at x 3."""
    cam = np.array([0.3, -0.2, 1.05])
    wall = _wall()
    ok = np.ones(len(wall), bool)
    z = np.zeros(CFG.grid_shape)
    lo, hi = np.asarray(CFG.origin), np.asarray(CFG.origin) + CFG.size
    jg = jax.jit(lambda g, p, v, c: jog.raycast_update(g, p, v, c, CFG))(
        jog.OccGrid(*map(jnp.asarray, (z, lo, hi))), jnp.asarray(wall),
        jnp.asarray(ok), jnp.asarray(cam))
    tg = tog.raycast_update(tog.OccGrid(*map(_t, (z, lo, hi))), _t(wall),
                            torch.as_tensor(ok), _t(cam), CFG)
    buf = tg.buffer.numpy()
    np.testing.assert_array_equal(buf, np.asarray(jg.buffer))
    x_world = (np.arange(CFG.grid_shape[0]) + 0.5) * CFG.resolution + lo[0]
    missed = x_world[np.nonzero(buf < 0)[0]]
    hit = x_world[np.nonzero(buf > 0)[0]]
    assert len(missed) > 100 and missed.max() < -1.9
    assert np.all(np.abs(hit - 3.0) < 0.1)


def test_raycast_voxels_match():
    rng = np.random.default_rng(1)
    a = rng.uniform(-4, 4, (10, 3))
    b = rng.uniform(-4, 4, 3)
    vox_t, ok_t = tog._raycast_voxels(_t(a), _t(b), 400, CFG)
    vj, okj = jax.jit(jax.vmap(lambda p, q: jog._raycast_voxels(
        p, q, 400, CFG), in_axes=(0, None)))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(vox_t.numpy(), np.asarray(vj))
    assert ok_t.sum() > 100


def _probe_points(n=3000, seed=6):
    rng = np.random.default_rng(seed)
    p = rng.uniform([-5.5, -5.5, -1.5], [5.5, 5.5, 3.5], (n, 3))
    p[: n // 3] = rng.uniform([2.5, -1.2, 0.3], [3.5, 1.2, 1.7], (n // 3, 3))
    v = rng.normal(0, 1.0, (n, 3))
    v[:20, :2] = 0.0
    return p, v


def test_voxel_state_and_checks_identical(grids):
    jg, tg = grids["jg"], grids["tg"]
    p, v = _probe_points()
    st_j = jax.jit(lambda g, q: jog.voxel_state(g, q, CFG))(jg, jnp.asarray(p))
    st_t = tog.voxel_state(tg, _t(p), CFG)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    assert set(np.unique(np.asarray(st_j))) == {-1, 0, 1}
    sur = jax.jit(jax.vmap(lambda q: jog.check_pos_surround(
        jg, q, 1.2, EGO_R, EGO_H, CFG)))(jnp.asarray(p))
    np.testing.assert_array_equal(
        tog.check_pos_surround(tg, _t(p), 1.2, EGO_R, EGO_H, CFG).numpy(),
        np.asarray(sur))
    chk = jax.jit(jax.vmap(lambda q, w: jog.check_state(
        jg, q, w, 1.5, EGO_R, EGO_H, CFG)))(jnp.asarray(p), jnp.asarray(v))
    got = tog.check_state(tg, _t(p), _t(v), 1.5, EGO_R, EGO_H, CFG).numpy()
    np.testing.assert_array_equal(got, np.asarray(chk))
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("window_only", [True, False])
def test_clouds_identical(grids, window_only):
    jg, tg = grids["jg"], grids["tg"]
    pj, mj = jog.occupied_cloud(jg, CFG, 512, window_only=window_only)
    pt, mt = tog.occupied_cloud(tg, CFG, 512, window_only=window_only)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert 0 < int(mt.sum()) < 512
    hj = jog.history_cloud(jg, CFG, 64)
    ht = tog.history_cloud(tg, CFG, 64)
    for a, b in zip(ht, hj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _camera():
    rng = np.random.default_rng(8)
    depth = rng.uniform(0.5, 5.0, (48, 64))
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    depth[3, 5] = np.inf
    R = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    c, s = np.cos(0.1), np.sin(0.1)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return depth, R, Rz @ R, np.array([0.0, 0.0, 1.0]), np.array([0.1, 0.05, 1.0])


def test_project_depth_and_shift_filter():
    depth, R0, R1, t0, t1 = _camera()
    intr = (40.0, 40.0, 31.5, 23.5)
    pj, vj = jog.project_depth(jnp.asarray(depth), jnp.asarray(R0),
                               jnp.asarray(t0), CFG, *intr)
    pt, vt = tog.project_depth(_t(depth), _t(R0), _t(t0), CFG, *intr)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-12)
    depth1 = depth * 1.05
    sj, kj = jog.project_depth_shift_filter(
        *map(jnp.asarray, (depth1, R1, t1, depth, R0, t0)), CFG, *intr)
    st, kt = tog.project_depth_shift_filter(
        *map(_t, (depth1, R1, t1, depth, R0, t0)), CFG, *intr)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert 0 < int(kt.sum()) < int(vt.sum())
