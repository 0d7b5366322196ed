"""The ported closed-loop BASELINE examples (the port's examples/
config3_obstacle_scene.py and config6_fleet.py) on the CPU at f64, at a
tiny size against the JAX calls their JAX examples make (the JAX examples
have no size switch): config 3's robot through the fence's gap under the
sinusoidal wind for 0.5 s, config 6's fleet at B = 2 for 0.5 s on the
fleet's configuration, scene and lanes (tools/fleet_probe.py).

Stated tolerances, those of tests/test_torch_planner.py and
tests/test_torch_fleet.py: the FSM sequence, solves and replans identical
and the final position within 1e-5 (config 3, which also writes its two
HTML files); the outcomes, searches and solver-success fraction identical
and the final states within 1e-5 (config 6).  Each printed outcome line
is the one the JAX example prints for those values."""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from forces_resilient_planner_tpu.engine import fleet as jfleet
from forces_resilient_planner_tpu.engine import planner as jplan
from forces_resilient_planner_tpu.engine import simulator as jsim
from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.examples import (
    config3_obstacle_scene as ex3,
    config6_fleet as ex6,
)
from test_closed_loop import CFG as JCFG

ROOT = Path(__file__).resolve().parents[1]
DURATION = 0.5


def _fleet_probe():
    spec = importlib.util.spec_from_file_location(
        "fleet_probe", ROOT / "tools" / "fleet_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def config3(tmp_path_factory):
    out = tmp_path_factory.mktemp("scene")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex3, "DURATION", DURATION)
        got = ex3.main(["--device", "cpu", "--out-dir", str(out)])
    x0 = np.zeros(9)
    x0[2] = 1.2
    planner = jplan.ResilientPlanner(JCFG, max_cloud=2048, dtype=jnp.float64)
    sim = jsim.QuadSim(JCFG.model, x0.copy(), np.zeros(3))
    planner.on_odometry(x0)
    planner.set_occupied(ex3.fence())
    trace = jsim.run_closed_loop(planner, sim, ex3.GOAL, duration=DURATION,
                                 force_schedule=ex3.wind, record_plans=True)
    return got, trace, planner, out


def test_config3_flies_as_the_jax_planner(config3):
    got, trace, planner, _ = config3
    assert got["trace"]["state"] == trace["state"]
    assert got["planner"].diag.fsm_transitions == planner.diag.fsm_transitions
    assert (got["solves"], got["replans"]) == (planner.diag.solves,
                                               planner.diag.replans)
    assert got["solves"] >= 5
    np.testing.assert_allclose(got["final"], trace["pos"][-1], rtol=0,
                               atol=1e-5)


def test_config3_writes_its_scene_and_replay(config3, capsys):
    got, _, _, out = config3
    for name in ("scene_config3.html", "replay_config3.html"):
        assert (out / name).stat().st_size > 1000
    assert '"solves": %d' % got["solves"] in (
        out / "replay_config3.html").read_text()


def test_config6_flies_as_the_jax_fleet(capsys):
    got = ex6.main(["2", str(DURATION), "--device", "cpu"])
    line = capsys.readouterr().out
    fp = _fleet_probe()
    cfg = fp.fleet_cfg()
    grid, obs, mask = fp.fleet_scene(cfg, jnp.float64)
    starts, goals, f_true = workloads.fleet_lanes(2, seed=5)
    want = jfleet.run_fleet(cfg, grid, jnp.asarray(obs, jnp.float64), mask,
                            starts, goals, f_true, duration=DURATION,
                            replan_every=10, dtype=jnp.float64)
    assert got.outcome_counts == want.outcome_counts
    assert (got.searches, got.n_ticks) == (want.searches, want.n_ticks)
    assert got.solved_frac == want.solved_frac
    np.testing.assert_array_equal(got.outcome, np.asarray(want.outcome))
    np.testing.assert_allclose(got.final_states, np.asarray(want.final_states),
                               rtol=0, atol=1e-5)
    m = re.search(r"fleet B=2: reached ([\d.]+) collided ([\d.]+) "
                  r"solver-success ([\d.]+) searches (\d+)", line)
    assert m, line
    assert m.groups() == (f"{want.reached_frac:.2f}",
                          f"{want.collided_frac:.3f}",
                          f"{want.solved_frac:.3f}", str(want.searches))
