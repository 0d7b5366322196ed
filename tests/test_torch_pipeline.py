"""Port parity: the full NMPC step of the torch port (engine/pipeline_batch.py
::nmpc_step_batched, engine/pipeline.py::nmpc_step) against the JAX
package's at f64, on the obstacle scene of tests/test_pipeline.py with the
per-lane variety of its batched-vs-vmapped test (forces, time offsets, one
final-profile lane, perturbed deques).  Stated tolerances: exit codes,
iterations and the five FSM flags identical; references within 1e-12;
tube ellipsoids within 1e-10; corridor A, b and b_tight within 1e-9;
mpc_output within 1e-6 (the lane-major solver against the JAX per-lane
solver for the single step)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.engine import pipeline as jp
from forces_resilient_planner_tpu.engine import pipeline_batch as jpb
from forces_resilient_planner_tpu_torch.engine import pipeline as tp
from forces_resilient_planner_tpu_torch.engine import pipeline_batch as tpb
from test_pipeline import make_inputs

KEYS = tpb.PIPELINE_ARG_KEYS
FLAGS = ("reach_local_end", "switch_to_final", "diverged", "goal_reached",
         "ref_jump_replan")
B = 4


def _batched_inputs():
    rng = np.random.default_rng(3)
    base = {k: np.asarray(v) for k, v in make_inputs(with_obstacles=True).items()}
    a = {k: np.stack([v] * B, axis=0) for k, v in base.items()}
    a["f_ext"] = rng.uniform(-1.0, 1.0, (B, 3))
    a["t_offset"] = rng.uniform(0.0, 0.3, (B,))
    a["use_final"] = np.array([False, True, False, False])
    a["mpc_output"] = a["mpc_output"] + rng.normal(0, 1e-3, a["mpc_output"].shape)
    return a


@pytest.fixture(scope="module")
def steps():
    a = _batched_inputs()
    ref = jax.jit(lambda d: jpb.nmpc_step_batched(*[d[k] for k in KEYS],
                                                  cfg=C))(a)
    t = tpb.pipeline_inputs_from_numpy(a, dtype=torch.float64, device="cpu")
    got = tpb.nmpc_step_batched(*[t[k] for k in KEYS], cfg=C)
    return ref, got


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_pipeline_inputs_from_numpy_dtypes():
    assert KEYS == bench.PIPELINE_ARG_KEYS
    t = tpb.pipeline_inputs_from_numpy(_batched_inputs(), dtype=torch.float32,
                                       device="cpu")
    assert tuple(t) == KEYS
    for k, v in t.items():
        want = (torch.bool if k in ("obstacle_mask", "use_final")
                else torch.int64 if k == "kino_size" else torch.float32)
        assert v.dtype == want, k
    assert t["use_final"].tolist() == [False, True, False, False]


def test_batched_step_solver_outputs_match_jax(steps):
    ref, got = steps
    assert (_np(got.exit_code) == 1).all()
    np.testing.assert_array_equal(_np(got.exit_code), _np(ref.exit_code))
    np.testing.assert_array_equal(_np(got.iters), _np(ref.iters))
    np.testing.assert_allclose(_np(got.mpc_output), _np(ref.mpc_output),
                               rtol=0, atol=1e-6)
    out = _np(got.mpc_output)
    np.testing.assert_array_equal(out[:, -1], out[:, -2])   # row N = row N-1


@pytest.mark.parametrize("field", FLAGS)
def test_batched_step_flags_match_jax(steps, field):
    ref, got = steps
    np.testing.assert_array_equal(_np(getattr(got, field)),
                                  _np(getattr(ref, field)))


@pytest.mark.parametrize("field,tol", [
    ("corridor_A", 1e-9), ("corridor_b", 1e-9), ("corridor_b_tight", 1e-9),
    ("tube_E", 1e-10),
])
def test_batched_step_corridors_and_tubes_match_jax(steps, field, tol):
    ref, got = steps
    np.testing.assert_allclose(_np(getattr(got, field)),
                               _np(getattr(ref, field)), rtol=0, atol=tol)


def test_batched_step_references_match_jax(steps):
    ref, got = steps
    for f in ("ref_pos", "ref_yaw", "stage0_jump"):
        np.testing.assert_allclose(_np(getattr(got.ref, f)),
                                   _np(getattr(ref.ref, f)), rtol=0, atol=1e-12)


def test_single_step_matches_jax_nmpc_step():
    a = {k: v[2] for k, v in _batched_inputs().items()}
    ref = jax.jit(lambda d: jp.nmpc_step(*[d[k] for k in KEYS], cfg=C))(a)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    got = tp.nmpc_step(*[t[k] for k in KEYS], cfg=C)
    assert got.mpc_output.shape == (C.model.N + 1, 17)
    assert int(got.exit_code) == int(ref.exit_code) == 1
    for f in FLAGS:
        assert bool(getattr(got, f)) == bool(getattr(ref, f)), f
    np.testing.assert_allclose(_np(got.corridor_b_tight),
                               _np(ref.corridor_b_tight), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(got.mpc_output), _np(ref.mpc_output),
                               rtol=0, atol=1e-6)


def test_acceptance_rule_keeps_previous_deque_on_maxit():
    """ok = (ec == 1) | (accept_on_maxit & isfinite(kkt)): a max-iteration
    stop keeps the previous rows unless accept_on_maxit (nmpc_solver.cpp:
    397-429)."""
    cfg = dataclasses.replace(C, solver=dataclasses.replace(C.solver,
                                                            max_iters=2))
    a = tpb.pipeline_inputs_from_numpy(_batched_inputs(), dtype=torch.float64,
                                       device="cpu")
    args = [a[k] for k in KEYS]
    kept = tpb.nmpc_step_batched(*args, cfg=cfg)
    assert (kept.exit_code != 1).all()
    prev = a["mpc_output"]
    assert torch.equal(kept.mpc_output[:, :-1], prev[:, :-1])
    assert torch.equal(kept.mpc_output[:, -1], prev[:, -2])
    took = tpb.nmpc_step_batched(*args, cfg=cfg, accept_on_maxit=True)
    assert torch.isfinite(took.kkt_error).all()
    assert not torch.equal(took.mpc_output[:, :-1], prev[:, :-1])


def test_drifted_robots_match_jax():
    """chip_smoke.py's drifted workload (every 4th robot's deque shifted by
    N(0, 0.3) m and N(0, 1) m/s): the robots that end at max_iters (0) and
    at the NaN guard (-6) end there in both packages after the same
    iterations; corridors within 1e-9, solved deques within 1e-6."""
    import chip_smoke

    t = chip_smoke.step_inputs(1, 32, torch.float64, "cpu", drift=True)
    a = {k: v.numpy() for k, v in t.items()}
    ref = jax.jit(lambda d: jpb.nmpc_step_batched(*[d[k] for k in KEYS],
                                                  cfg=C))(a)
    got = tpb.nmpc_step_batched(*[t[k] for k in KEYS], cfg=C)
    ec = _np(got.exit_code)
    assert {0, -6} <= set(ec.tolist())
    np.testing.assert_array_equal(ec, _np(ref.exit_code))
    np.testing.assert_array_equal(_np(got.iters), _np(ref.iters))
    np.testing.assert_allclose(_np(got.corridor_b_tight),
                               _np(ref.corridor_b_tight), rtol=0, atol=1e-9)
    solved = ec == 1
    np.testing.assert_allclose(_np(got.mpc_output)[solved],
                               _np(ref.mpc_output)[solved], rtol=0, atol=1e-6)


def test_nmpc_step_stream_steps_every_set():
    """The stream steps each input set once, in order, and returns the
    results in order."""
    sets = [{"set": i} for i in range(3)]
    seen = []

    def step_fn(a):
        seen.append(a)
        return ("stepped", a["set"])

    outs = tpb.nmpc_step_stream(step_fn, sets)
    assert outs == [("stepped", 0), ("stepped", 1), ("stepped", 2)]
    assert len(seen) == 3 and all(a is b for a, b in zip(seen, sets))
    assert tpb.nmpc_step_stream(step_fn, []) == []
