"""Port parity: the fleet closed loop of the torch port (engine/fleet.py::
run_fleet) against the JAX package's at f64 on the CPU, B = 2 lanes of
tests/test_fleet.py's wide-gap fence scene for 1.0 s (20 ticks) with a
replan every 10 ticks; and the fence scenarios of engine/scenarios.py.

Stated tolerances: exit codes identical on every tick; outcomes, the
outcome table and the number of searches identical; plant states within
1e-5 on every tick.  The step alone holds mpc_output to 1e-6 against JAX
(tests/test_torch_pipeline.py); here each tick's state feeds the next
tick's solve and the plant, and over the 20 ticks the states stayed within
2.2e-16 of JAX's and the applied controls within 1.8e-15, once the port's
references pick the path samples jitted JAX picks at the fleet's on-grid
time offsets (engine/reference.py): the bar leaves the loop ten orders of
magnitude.  The scene's grid, cloud and mask identical; the
scenarios' corridors within 1e-9 (the port's decomposition bar) and every
other field within 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.engine import fleet as jfleet
from forces_resilient_planner_tpu.engine import scenarios as jscen
from forces_resilient_planner_tpu.mapping import occ_grid as jog
from forces_resilient_planner_tpu_torch.engine import fleet as tfleet
from forces_resilient_planner_tpu_torch.engine import scenarios as tscen
from forces_resilient_planner_tpu_torch.mapping import occ_grid as tog
from test_fleet import CFG
from _torch_threads import one_torch_thread  # noqa: F401

B, DURATION, REPLAN = 2, 1.0, 10
F64 = torch.float64


def _fence():
    ys = np.arange(-4.0, 4.0, 0.1)
    zs = np.arange(0.0, 2.6, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.full(yy.size, 1.5), yy.ravel(), zz.ravel()], -1)
    return pts[~((pts[:, 1] > 0.3) & (pts[:, 1] < 2.1))]


def _lanes():
    rng = np.random.default_rng(2)
    starts = np.zeros((B, 9))
    starts[:, 0] = -0.5
    starts[:, 1] = rng.uniform(0.6, 1.8, B)
    starts[:, 2] = 1.2
    goals = np.stack(
        [np.full(B, 3.2), rng.uniform(0.6, 1.8, B), np.full(B, 1.2)], -1
    )
    return starts, goals, rng.uniform(-0.5, 0.5, (B, 3))


@pytest.fixture(scope="module")
def runs():
    pts = _fence()
    ones = np.ones(len(pts), bool)
    jg = jog.set_occupancy(jog.make_grid(CFG.map, jnp.float64),
                           jnp.asarray(pts), jnp.asarray(ones), CFG.map)
    jobs, jmask = jog.occupied_cloud(jg, CFG.map, 2048)
    tg = tog.set_occupancy(tog.make_grid(CFG.map, F64, device="cpu"),
                           torch.as_tensor(pts), torch.as_tensor(ones),
                           CFG.map)
    tobs, tmask = tog.occupied_cloud(tg, CFG.map, 2048)
    starts, goals, f_true = _lanes()
    jtrace, ttrace = [], []
    want = jfleet.run_fleet(CFG, jg, jobs, jmask, starts, goals, f_true,
                            duration=DURATION, replan_every=REPLAN,
                            dtype=jnp.float64, tick_trace=jtrace)
    got = tfleet.run_fleet(CFG, tg, tobs, tmask, starts, goals, f_true,
                           duration=DURATION, replan_every=REPLAN,
                           tick_trace=ttrace)
    return dict(jg=jg, tg=tg, jobs=jobs, tobs=tobs, jmask=jmask, tmask=tmask,
                want=want, got=got, jtrace=jtrace, ttrace=ttrace)


def test_scene_identical(runs):
    np.testing.assert_array_equal(runs["tg"].buffer.numpy(),
                                  np.asarray(runs["jg"].buffer))
    np.testing.assert_array_equal(runs["tobs"].numpy(),
                                  np.asarray(runs["jobs"]))
    np.testing.assert_array_equal(runs["tmask"].numpy(),
                                  np.asarray(runs["jmask"]))
    assert 1000 < int(runs["tmask"].sum()) <= 2048


def test_exit_codes_identical_every_tick(runs):
    jt, tt = runs["jtrace"], runs["ttrace"]
    assert len(tt) == len(jt) == int(round(DURATION / CFG.model.dt))
    for k, (a, b) in enumerate(zip(tt, jt)):
        np.testing.assert_array_equal(a["ec"], b["ec"], err_msg=f"tick {k}")
        np.testing.assert_array_equal(a["fail"], b["fail"], err_msg=f"tick {k}")
        np.testing.assert_array_equal(a["size"], b["size"], err_msg=f"tick {k}")
        np.testing.assert_array_equal(a["use_final"], b["use_final"])


def test_states_within_1e5_every_tick(runs):
    for a, b in zip(runs["ttrace"], runs["jtrace"]):
        np.testing.assert_allclose(a["states"], b["states"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(a["t_off"], b["t_off"], rtol=0, atol=0)
    moved = np.abs(runs["ttrace"][-1]["states"][:, 0]
                   - runs["ttrace"][0]["states"][:, 0])
    assert (moved > 0.1).all(), moved
    np.testing.assert_allclose(runs["got"].final_states,
                               runs["want"].final_states, rtol=0, atol=1e-5)


def test_outcomes_and_searches_identical(runs):
    got, want = runs["got"], runs["want"]
    np.testing.assert_array_equal(got.outcome, want.outcome)
    assert got.outcome_counts == want.outcome_counts
    assert sum(got.outcome_counts.values()) == B
    assert got.searches == want.searches
    assert (got.n_ticks, got.batch) == (want.n_ticks, want.batch)
    assert got.tick_code_fracs == want.tick_code_fracs
    np.testing.assert_array_equal(got.infeas_ticks, want.infeas_ticks)
    np.testing.assert_array_equal(got.panic_exit_code, want.panic_exit_code)
    np.testing.assert_array_equal(np.isnan(got.time_to_goal),
                                  np.isnan(want.time_to_goal))
    assert got.collided_frac == want.collided_frac == 0.0


def test_fence_scenarios_match_jax():
    cfg, n = jscen.PARITY_SCENE_CFG, 2
    np.testing.assert_array_equal(tscen.fence_scene(), jscen.fence_scene())
    want = jscen.corridor_scenarios(cfg, n, dtype=jnp.float64)
    got = tscen.corridor_scenarios(tscen.PARITY_SCENE_CFG, n, device="cpu")
    np.testing.assert_allclose(got.Z0.numpy(), np.asarray(want.Z0), rtol=0,
                               atol=1e-12)
    for name in want.params._fields:
        g, w = getattr(got.params, name), getattr(want.params, name)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            tol = 1e-9 if name.startswith("corridor") else 1e-12
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=tol, err_msg=name)
    A = got.params.corridor_A.numpy()
    assert (np.linalg.norm(A[..., :12, :], axis=-1) > 0).any()
