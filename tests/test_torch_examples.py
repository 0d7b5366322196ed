"""The ported BASELINE examples of the port (its examples/) on the CPU.

Config 5 at a small size: a sweep interrupted after 2 checkpointed chunks
and resumed to 3 in a fresh call gives every chunk's exit codes and
iterations bit-equal to one uninterrupted run, with the JAX example's
per-chunk seeds and summary fields.  The full 25 x 4096 sweep and the
--mesh path over 2 and 4 CPU ranks are marked slow; the full sweep runs on
the card in chip_smoke.py.

Configs 1, 2 and 4: each example's printed exit code and outcome against
the JAX calls its JAX example makes, on the same problem at f64 (config 4,
at its f32, on a 4 x 2 grid: the JAX example has no size switch): exit
codes and iterations identical, the controls within 1e-6 (config 4: 1e-3,
the control bar at f32), config 2's tightening margins and tube radii
within 1e-9.  Configs 3 and 6 (the closed loops) are in
tests/test_torch_examples_loop.py.  Config 1's --oracle is marked slow
(one SLSQP solve; chip_smoke.py runs it on the card)."""
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.engine import batch as jbm
from forces_resilient_planner_tpu.engine.pipeline import nmpc_step as jstep
from forces_resilient_planner_tpu.solver import ipm as jipm
from forces_resilient_planner_tpu.solver import problems as jp
from forces_resilient_planner_tpu_torch.examples import (
    config1_hover_to_goal as ex1,
    config2_constant_force as ex2,
    config4_batched as ex4,
    config5_monte_carlo as ex,
)
from forces_resilient_planner_tpu_torch.utils.checkpoint import (
    SweepCheckpointer,
)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--goals", "2", "--forces", "4"]


def _jax_example():
    """The JAX example module, loaded by path (it imports no JAX at module
    level: chunk_seeds is numpy)."""
    spec = importlib.util.spec_from_file_location(
        "jax_config5", ROOT / "examples" / "config5_monte_carlo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chunks(d, n):
    ck = SweepCheckpointer(d)
    return [tuple(a.numpy() for a in ck.load_chunk(c, device="cpu"))
            for c in range(n)]


def test_chunk_seeds_are_the_jax_example_s():
    jex = _jax_example()
    for c in (0, 7, 24):
        for a, b in zip(ex.chunk_seeds(c, 256, 16), jex.chunk_seeds(c, 256, 16)):
            np.testing.assert_array_equal(a, b)


def test_resume_after_interrupt_is_bit_equal(tmp_path):
    resumed, whole = tmp_path / "resumed", tmp_path / "whole"
    assert ex.main(SMALL + ["--chunks", "2", "--ckpt-dir", str(resumed),
                            "--no-summary"]) is None
    assert SweepCheckpointer(resumed).done_chunks() == {0, 1}
    out = tmp_path / "summary.json"
    s = ex.main(SMALL + ["--chunks", "3", "--ckpt-dir", str(resumed),
                         "--out", str(out)])
    assert json.loads(out.read_text()) == s
    assert s["resumed_chunks"] == 2 and s["n_scenarios"] == 24
    assert s["n_chunks"] == 3 and s["mode"] == "streamed"
    assert s["device"] == "cpu" and s["chunk_batch"] == 8
    assert set(s["exit_code_fracs"]) == {"OPTIMAL", "MAXITREACHED",
                                         "BADFUNCEVAL", "NOPROGRESS"}
    assert s["steady_state_solves_per_s"] is None   # one chunk this call
    u = ex.main(SMALL + ["--chunks", "3", "--ckpt-dir", str(whole)])
    assert u["resumed_chunks"] == 0 and u["steady_state_solves_per_s"] > 0
    for a, b in zip(_chunks(resumed, 3), _chunks(whole, 3)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for k in ("resilience_rate", "mean_iters", "max_iters", "iters_p99",
              "exit_code_fracs", "n_scenarios"):
        assert s[k] == u[k], k
    # a finished sweep resumes every chunk and solves none
    again = ex.main(SMALL + ["--chunks", "3", "--ckpt-dir", str(whole)])
    assert again["resumed_chunks"] == 3 and again["wall_s"] == 0.0


@pytest.mark.slow
@pytest.mark.parametrize("ranks", [2, 4])
def test_mesh_path_over_cpu_ranks(tmp_path, ranks):
    s = ex.main(SMALL + ["--mesh", "--ranks", str(ranks), "--chunks", "2",
                         "--ckpt-dir", str(tmp_path)])
    assert s["mode"] == "mesh" and s["n_chunks"] == 2
    assert s["n_scenarios"] == 2 * (8 + (-8) % ranks)


@pytest.mark.slow
def test_full_sweep_resumed_after_8_chunks(tmp_path):
    """BASELINE config 5's r05 bar at full scale (run it on the card)."""
    ex.main(["--device", "cpu", "--chunks", "8", "--ckpt-dir", str(tmp_path),
             "--no-summary"])
    s = ex.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert s["resumed_chunks"] == 8 and s["n_scenarios"] == 102_400
    assert s["resilience_rate"] >= 0.999


X0 = np.zeros(9)
X0[2] = 1.2


def _printed(capsys, pattern):
    """The ints of the first printed line matching `pattern`."""
    out = capsys.readouterr().out
    m = re.search(pattern, out)
    assert m, out
    return tuple(int(g) for g in m.groups())


def test_config1_matches_the_jax_example_s_solve(capsys):
    got = ex1.main(["--device", "cpu"])
    assert _printed(capsys, r"exit=(-?\d+) iters=(\d+)") == (
        got["exit"], got["iters"])
    p = jp.hover_to_goal_params(X0, ex1.GOAL, C.model, C.weights)
    ref = jax.jit(lambda z, p: jipm.solve(z, p, C.model, C.solver))(
        jp.hover_warm_start(jnp.asarray(X0), C.model), p)
    assert (got["exit"], got["iters"]) == (int(ref.exit_code),
                                           int(ref.iters)) == (1, 13)
    np.testing.assert_allclose(got["Z"], np.asarray(ref.Z), rtol=0,
                               atol=1e-6)


@pytest.mark.slow
def test_config1_oracle_parity():
    got = ex1.main(["--device", "cpu", "--oracle"])
    assert got["exit"] == 1 and got["oracle_err"] < 1e-3


def test_config2_matches_the_jax_example_s_step(capsys):
    got = ex2.main(["--device", "cpu"])
    assert _printed(capsys, r"exit=(-?\d+) iters=(\d+)") == (
        got["exit"], got["iters"])
    f64 = jnp.float64
    Z = np.asarray(jp.hover_warm_start(jnp.asarray(X0, f64), C.model))
    K = ex2.K
    s = np.arange(K) * C.model.dt
    path = np.stack([1.5 * s, np.zeros(K), np.full(K, 1.2)], -1)
    res = jax.jit(lambda *a: jstep(*a, cfg=C))(
        jnp.asarray(np.concatenate([Z, Z[-1:]]), f64), jnp.asarray(path, f64),
        jnp.asarray(K), jnp.asarray(0.0, f64), jnp.asarray(X0, f64),
        jnp.asarray(ex2.WIND, f64), jnp.asarray(path[-1], f64),
        jnp.zeros((64, 3), f64), jnp.zeros(64, bool), jnp.asarray(False))
    assert (got["exit"], got["iters"]) == (int(res.exit_code),
                                           int(res.iters))
    tighten = np.asarray(res.corridor_b - res.corridor_b_tight)
    rows = np.linalg.norm(np.asarray(res.corridor_A), axis=-1) > 1e-9
    np.testing.assert_allclose(got["tighten"], tighten[rows], rtol=0,
                               atol=1e-9)
    E = np.asarray(res.tube_E)
    np.testing.assert_allclose(
        got["radii"], (np.linalg.norm(E[0], 2), np.linalg.norm(E[-1], 2)),
        rtol=0, atol=1e-9)
    assert got["radii"][1] > got["radii"][0]


def test_config4_matches_the_jax_example_s_grid(capsys, monkeypatch):
    monkeypatch.setattr(ex4, "N_GOALS", 4)
    monkeypatch.setattr(ex4, "N_FORCES", 2)
    got = ex4.main(["--device", "cpu"])
    assert "batch: 8" in capsys.readouterr().out
    rng = np.random.default_rng(1)
    scen = jbm.make_scenarios(
        C, rng.uniform([-3, -3, 1.0], [3, 3, 1.6], (4, 3)),
        rng.uniform(-1.5, 1.5, (2, 3)), ex4.HALVES, dtype=jnp.float32)
    ref = jbm.solve_scenarios(scen, C)
    np.testing.assert_array_equal(got["exit_codes"],
                                  np.asarray(ref.exit_code))
    assert (got["exit_codes"] == 1).all()
    np.testing.assert_allclose(got["Z"][..., 0:4],
                               np.asarray(ref.Z[..., 0:4], np.float64),
                               rtol=0, atol=1e-3)
