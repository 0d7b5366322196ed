"""Port parity: the kinodynamic search of the torch port (search/
kinodynamic.py) against the JAX package's at f64 on the CPU, the JAX
search under jit as its callers (the fleet, the planner) run it.

Scenes: the five of tests/test_search.py (free space, wall with a gap,
fully blocked, disturbance bias, init expansion with a start acceleration)
and its B = 4 batched scene, flown through the port at B = 1 each and at
B = 4 at once.  Starts and goals sit off voxel boundaries (2.3 mm): jitted
XLA contracts products and sums into FMAs the port cannot form, which
moves positions by an ulp, enough to flip a floor() on a boundary.

Stated tolerances: status, n_edges, edge_inputs, shot_ok and iterations
identical; edge states, durations, terminal state, shot coefficients and
shot time within 1e-12; get_kino_traj's path within 1e-12 and its size
identical; get_cur_pos and get_samples within 1e-12; the cube root
within 1 ulp of jnp.cbrt (normal inputs); the
heuristic on 10^4 random pairs within a relative 1e-13, its optimal time
within 1e-9 (JAX's eager and jitted runs differ by 6.7e-10 there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.mapping import occ_grid as jog
from forces_resilient_planner_tpu.search import kinodynamic as jkd
from forces_resilient_planner_tpu_torch.mapping import occ_grid as tog
from forces_resilient_planner_tpu_torch.search import kinodynamic as tkd
from test_search import MAP, SRCH, TUBE
from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
OFF = 0.0023      # off the 0.1 m voxel boundaries
EXACT = ("status", "n_edges", "edge_inputs", "shot_ok", "iterations")
CLOSE = ("edge_states", "edge_durs", "term_state", "shot_coef", "shot_time")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _wall_gap():
    ys = np.arange(-5, 5, 0.1)
    zs = np.arange(-1, 3, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.zeros(yy.size), yy.ravel(), zz.ravel()], -1)
    keep = ~((pts[:, 1] > 0.8) & (pts[:, 1] < 2.2) & (pts[:, 2] > 0.5)
             & (pts[:, 2] < 2.0))
    return pts[keep]


def _full_wall():
    ys = np.arange(-5, 5, 0.1)
    zs = np.arange(-1, 3, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    return np.concatenate([
        np.stack([np.full(yy.size, xw), yy.ravel(), zz.ravel()], -1)
        for xw in (0.0, 0.1, 0.2)])


def _block():
    ys = np.arange(-1.0, 1.0, 0.1)
    zs = np.arange(0.5, 2.0, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    return np.stack([np.full(yy.size, 1.0), yy.ravel(), zz.ravel()], -1)


def _scene(start, goal, obstacles=None, v0=None, ext=None, a0=None,
           init=False):
    z = np.zeros(3)
    return dict(start=np.asarray(start) + OFF, goal=np.asarray(goal) + OFF,
                obstacles=obstacles,
                v0=z if v0 is None else np.asarray(v0, float),
                ext=z if ext is None else np.asarray(ext, float),
                a0=z if a0 is None else np.asarray(a0, float), init=init)


SCENES = {
    "free_space": _scene([-3.0, 0.0, 1.2], [0.5, 0.5, 1.2]),
    "wall_with_gap": _scene([-2.5, 1.5, 1.2], [2.5, 1.5, 1.2], _wall_gap()),
    "fully_blocked": _scene([-2.0, 0.0, 1.2], [2.0, 0.0, 1.2], _full_wall()),
    "disturbance_bias": _scene([-3.0, 0.0, 1.2], [0.5, 0.0, 1.2],
                               ext=[1.0, 0.5, 0.0]),
    "init_expansion": _scene([-3.0, 0.0, 1.2], [1.0, 0.0, 1.2],
                             v0=[1.0, 0, 0], a0=[1.5, 0.0, 0.0], init=True),
}


def _grids(obstacles):
    jg = jog.make_grid(MAP, jnp.float64)
    tg = tog.make_grid(MAP, F64, device="cpu")
    if obstacles is not None:
        ones = np.ones(len(obstacles), bool)
        jg = jog.set_occupancy(jg, jnp.asarray(obstacles), jnp.asarray(ones),
                               MAP)
        tg = tog.set_occupancy(tg, _t(obstacles), torch.as_tensor(ones), MAP)
    return jg, tg


def _jax_search(init):
    def run(grid, p, v, a, g, ext):
        z3 = jnp.zeros(3, jnp.float64)
        r = jkd.search(grid, p, v, a, g, z3, ext, init, SRCH, TUBE, MAP)
        path, size = jkd.get_kino_traj(r, ext, 0.05)
        return r, path, size
    return run


@pytest.fixture(scope="module")
def jax_single():
    return {init: jax.jit(_jax_search(init)) for init in (False, True)}


def _port(tg, starts, v0s, a0s, goals, exts, init):
    B = len(starts)
    r = tkd.search(tg, _t(starts), _t(v0s), _t(a0s), _t(goals),
                   torch.zeros(B, 3, dtype=F64), _t(exts), init, SRCH, TUBE,
                   MAP)
    path, size = tkd.get_kino_traj(r, _t(exts), 0.05)
    return r, path, size


def _compare(want, got, lane):
    rj, pj, sj = want
    rt, pt, st = got
    for name in EXACT:
        np.testing.assert_array_equal(
            getattr(rt, name)[lane].numpy(), np.asarray(getattr(rj, name)),
            err_msg=name)
    for name in CLOSE:
        np.testing.assert_allclose(
            getattr(rt, name)[lane].numpy(), np.asarray(getattr(rj, name)),
            rtol=0, atol=1e-12, err_msg=name)
    assert int(st[lane]) == int(sj)
    np.testing.assert_allclose(pt[lane].numpy(), np.asarray(pj), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", list(SCENES))
def test_search_scene_matches_jax(name, jax_single):
    sc = SCENES[name]
    jg, tg = _grids(sc["obstacles"])
    want = jax_single[sc["init"]](
        jg, *map(jnp.asarray, (sc["start"], sc["v0"], sc["a0"], sc["goal"],
                               sc["ext"])))
    got = _port(tg, sc["start"][None], sc["v0"][None], sc["a0"][None],
                sc["goal"][None], sc["ext"][None], sc["init"])
    _compare(want, got, 0)
    status = int(got[0].status[0])
    if name == "fully_blocked":
        assert status == tkd.NO_PATH
    else:
        assert status in (tkd.REACH_END, tkd.REACH_END_BUT_SHOT_FAILS,
                          tkd.REACH_HORIZON)
        assert int(got[0].n_edges[0]) > 0
    if name == "init_expansion":
        np.testing.assert_array_equal(got[0].edge_inputs[0, 0].numpy(),
                                      sc["a0"])


def test_batched_search_matches_vmapped_jax():
    """tests/test_search.py's B = 4 scene: the port's four lanes at once
    against jax.vmap of the JAX search, lane by lane."""
    B = 4
    rng = np.random.default_rng(11)
    starts = np.array([[-3.0, 0.0, 1.2]] * B) + rng.uniform(-0.3, 0.3, (B, 3))
    goals = np.array([[2.5, 0.5, 1.2]] * B) + rng.uniform(-0.5, 0.5, (B, 3))
    v0s = rng.uniform(-0.5, 0.5, (B, 3))
    exts = rng.uniform(-0.8, 0.8, (B, 3))
    a0s = np.zeros((B, 3))
    jg, tg = _grids(_block())
    want = jax.jit(jax.vmap(_jax_search(False), in_axes=(None, 0, 0, 0, 0, 0)))(
        jg, *map(jnp.asarray, (starts, v0s, a0s, goals, exts)))
    got = _port(tg, starts, v0s, a0s, goals, exts, False)
    iters = got[0].iterations.numpy()
    assert len(set(iters.tolist())) > 1      # lanes stop at different rounds
    for b in range(B):
        _compare(jax.tree.map(lambda x: x[b], want), got, b)


def test_cbrt_within_one_ulp_of_jnp():
    """jnp.cbrt on XLA is the signed power |x|^(1/3), not a correctly
    rounded cube root (that one differs from it by up to a dozen ulps): the
    port's power is within 1 ulp of it on normal inputs, 0 and negatives.
    On subnormal inputs XLA:CPU returns one constant (1.35e-108, its
    inputs flushed); there the port's power is within a relative 1e-13 of
    numpy's cube root."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.normal(0, 1, 4000) * 10.0 ** rng.uniform(-30, 30, 4000),
        [0.0, -0.0, 1.0, -1.0, 8.0, -27.0, 2.2250738585072014e-308, 1e300,
         -1e300],
    ])
    want = np.asarray(jnp.cbrt(jnp.asarray(x)))
    got = tkd.cbrt(_t(x)).numpy()
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    sub = np.array([5e-324, -5e-324, 1e-310, -3e-320])
    np.testing.assert_allclose(tkd.cbrt(_t(sub)).numpy(), np.cbrt(sub),
                               rtol=1e-13)


def test_estimate_heuristic_matches_jax():
    rng = np.random.default_rng(7)
    n = 10_000
    x1 = rng.uniform(-3, 3, (n, 6))
    x2 = rng.uniform(-3, 3, (n, 6))
    x1[:, 3:] = rng.uniform(-2, 2, (n, 3))
    x2[:, 3:] = rng.uniform(-2, 2, (n, 3))
    args = (SRCH.w_time, SRCH.max_vel, SRCH.tie_breaker)
    hj, tj = jax.jit(lambda a, b: jkd.estimate_heuristic(a, b, *args))(
        jnp.asarray(x1), jnp.asarray(x2))
    ht, tt = tkd.estimate_heuristic(_t(x1), _t(x2), *args)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-13, atol=0)
    # the optimal time sits where the cost is flat: JAX's own eager and
    # jitted runs of it differ by up to 6.7e-10 relative on these pairs
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-9, atol=0)


def test_get_cur_pos_and_samples_match_jax(jax_single):
    """The host path queries on the disturbance scene's result (edges and
    a one-shot tail), the port's on lane 0 of its B = 1 result: within
    1e-12 at times along the edges, the tail and past the end."""
    sc = SCENES["disturbance_bias"]
    jg, tg = _grids(None)
    rj = jax_single[False](jg, *map(jnp.asarray, (
        sc["start"], sc["v0"], sc["a0"], sc["goal"], sc["ext"])))[0]
    rt = _port(tg, sc["start"][None], sc["v0"][None], sc["a0"][None],
               sc["goal"][None], sc["ext"][None], False)[0]
    ext, tau, end = sc["ext"], SRCH.max_tau, sc["goal"]
    for t in np.linspace(0.0, 6.0, 25):
        np.testing.assert_allclose(
            tkd.get_cur_pos(rt, ext, t, tau, end),
            jkd.get_cur_pos(rj, ext, t, tau, end), rtol=0, atol=1e-12)
    pts_t, der_t = tkd.get_samples(rt, ext, 0.05)
    pts_j, der_j = jkd.get_samples(rj, ext, 0.05)
    assert len(pts_t) == len(pts_j) > 5
    np.testing.assert_allclose(np.asarray(pts_t), np.asarray(pts_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(der_t), np.asarray(der_j), rtol=0,
                               atol=1e-12)
