"""Port parity: solver/ipm_lanes.py of the torch port against the JAX
lane-major solver at f64 on the 24-lane set of tests/test_ipm_lanes.py:
identical exit codes and iteration counts, Z within 1e-8.  Mirrors that
file's NaN isolation, tiered / multitier bit-exactness (including overflow
into the full-batch safety net) and predictor-corrector parity, and counts
the Riccati wrapper calls (ops/lqr_kernel.py, K4) of one iteration."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.engine import batch as jb
from forces_resilient_planner_tpu.solver import ipm_lanes as jl
from forces_resilient_planner_tpu_torch.ops import lqr_kernel
from forces_resilient_planner_tpu_torch.solver import ipm_lanes as tl
from forces_resilient_planner_tpu_torch.solver import nlp as tn

F64 = torch.float64


def _scenarios(dtype=jnp.float64):
    rng = np.random.default_rng(11)
    goals = rng.uniform([-2.5, -2.5, 1.0], [2.5, 2.5, 1.6], (4, 3))
    forces = np.vstack([[0.0, 0.0, 0.0], rng.uniform(-1.5, 1.5, (2, 3))])
    halves = np.array([[5.0, 5.0, 2.0], [2.0, 3.0, 1.2]])
    return jb.make_scenarios(C, goals, forces, halves, dtype=dtype)


_JAX_SOLVERS = {}


def _jax_solver(scfg):
    """One jitted JAX solver per config (few XLA:CPU compiles per file)."""
    if scfg not in _JAX_SOLVERS:
        _JAX_SOLVERS[scfg] = jax.jit(
            lambda Z0, p: jl.solve_batch_lanes(Z0, p, C.model, scfg)
        )
    return _JAX_SOLVERS[scfg]


@pytest.fixture(scope="module")
def problem():
    sc = _scenarios()
    params, Z0 = tn.nlp_params_from_numpy(sc.params, sc.Z0, dtype=F64,
                                          device="cpu")
    return sc, params, Z0


@pytest.fixture(scope="module")
def single_phase(problem):
    _, params, Z0 = problem
    return tl.solve_batch_lanes(Z0, params, C.model, C.solver)


def _same(got, ref, atol=1e-8):
    np.testing.assert_array_equal(got.exit_code.numpy(),
                                  np.asarray(ref.exit_code))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.Z.numpy(), np.asarray(ref.Z),
                               rtol=atol, atol=atol)


def _bit_identical(got, ref):
    assert torch.equal(got.exit_code, ref.exit_code)
    assert torch.equal(got.iters, ref.iters)
    assert torch.equal(got.Z, ref.Z)


def test_solve_batch_lanes_matches_jax(problem, single_phase):
    sc, _, _ = problem
    ref = _jax_solver(C.solver)(sc.Z0, sc.params)
    assert (np.asarray(ref.exit_code) == 1).all()
    _same(single_phase, ref)
    np.testing.assert_allclose(single_phase.kkt_error.numpy(),
                               np.asarray(ref.kkt_error), rtol=1e-4,
                               atol=1e-10)
    assert single_phase.Z.shape == (24, C.model.N, 17)
    assert single_phase.lam.shape == (24, C.model.N, 13)
    assert single_phase.s.shape == single_phase.mu_d.shape == (24, C.model.N, 64)


def test_f32_controls_close_to_jax_f64(problem):
    sc, _, _ = problem
    ref = _jax_solver(C.solver)(sc.Z0, sc.params)
    params32, Z0_32 = tn.nlp_params_from_numpy(
        sc.params, sc.Z0, dtype=torch.float32, device="cpu")
    got = tl.solve_batch_lanes(Z0_32, params32, C.model, C.solver)
    assert (got.exit_code == 1).all()
    d = np.abs(got.Z[:, :, 0:4].double().numpy() - np.asarray(ref.Z[:, :, 0:4]))
    assert d.max() < 1e-3, d.max()


def test_nan_isolation_matches_jax(problem):
    """A poisoned lane (NaN f_ext) fails alone with -6; its neighbours
    solve, and the port's exit codes equal the JAX solver's."""
    sc, params, Z0 = problem
    f = np.asarray(sc.params.f_ext).copy()
    f[2] = np.nan
    ref = _jax_solver(C.solver)(sc.Z0, sc.params._replace(f_ext=jnp.asarray(f)))
    got = tl.solve_batch_lanes(
        Z0, params._replace(f_ext=torch.as_tensor(f)), C.model, C.solver)
    ec = got.exit_code.numpy()
    assert ec[2] == -6, ec[2]
    ok = np.ones(len(ec), bool)
    ok[2] = False
    assert (ec[ok] == 1).all()
    assert torch.isfinite(got.Z[torch.as_tensor(ok)]).all()
    _same(got, ref)


def test_tiered_solver_bit_identical(problem, single_phase):
    _, params, Z0 = problem
    scfg = dataclasses.replace(C.solver, tier_phase1=8, tier_frac=1.0)
    _bit_identical(
        tl.solve_batch_lanes_tiered(Z0, params, C.model, scfg), single_phase
    )
    # overflow: a 4-lane tail cannot hold the unconverged lanes after 6
    # iterations; the full-batch safety net must still finish them exactly
    assert (single_phase.iters > 6).sum() > 4
    got = tl.solve_lanes_tiered(
        Z0.movedim(0, -1).contiguous(), tl.lanes_params(params),
        C.model, C.solver, 6, 4,
    )
    _bit_identical(got, single_phase)


def test_multitier_solver_bit_identical(problem, single_phase):
    _, params, Z0 = problem
    scfg = dataclasses.replace(C.solver, tiers=((6, 1.0), (9, 1.0)))
    _bit_identical(
        tl.solve_batch_lanes_tiered(Z0, params, C.model, scfg), single_phase
    )
    it = single_phase.iters
    lanes1, lanes2 = int((it > 8).sum()), int((it > 11).sum())
    assert lanes1 >= 1 and lanes2 >= 1
    got = tl.solve_lanes_multitier(
        Z0.movedim(0, -1).contiguous(), tl.lanes_params(params),
        C.model, C.solver, ((8, lanes1), (11, lanes2)),
    )
    _bit_identical(got, single_phase)
    # overflowing levels: the safety net restores single-phase results
    got = tl.solve_lanes_multitier(
        Z0.movedim(0, -1).contiguous(), tl.lanes_params(params),
        C.model, C.solver, ((8, 2), (11, 1)),
    )
    _bit_identical(got, single_phase)


def test_tier_phase1_past_max_iters_is_capped(problem):
    """tier_phase1 beyond the solver's own cap stops phase 1 at max_iters,
    as the single-phase solve does (the JAX two-tier route does not cap)."""
    _, params, Z0 = problem
    scfg = dataclasses.replace(C.solver, max_iters=4)
    single = tl.solve_batch_lanes(Z0, params, C.model, scfg)
    assert int(single.iters.max()) == 4
    tiered = dataclasses.replace(scfg, tier_phase1=scfg.max_iters + 3,
                                 tier_frac=1.0)
    _bit_identical(
        tl.solve_batch_lanes_tiered(Z0, params, C.model, tiered), single)


def test_empty_schedule_is_the_single_phase_solve(problem):
    _, params, Z0 = problem
    scfg = dataclasses.replace(C.solver, max_iters=4)
    Zl, pl = Z0.movedim(0, -1).contiguous(), tl.lanes_params(params)
    _bit_identical(tl.solve_lanes_multitier(Zl, pl, C.model, scfg, ()),
                   tl.solve_lanes(Zl, pl, C.model, scfg))


def test_round_lanes_bench_tiers():
    assert [tl._round_lanes(4096, f) for f in (0.25, 0.0625)] == [1024, 256]
    assert tl._round_lanes(24, 0.25) == 24


def test_host_loop_steps_are_counted(problem):
    _, params, Z0 = problem
    before = tl.STEPS
    res = tl.solve_batch_lanes(Z0, params, C.model, C.solver)
    assert tl.STEPS - before == int(res.iters.max())


def test_predictor_corrector_parity(problem):
    sc, params, Z0 = problem
    scfg = dataclasses.replace(C.solver, predictor_corrector=True)
    ref = _jax_solver(scfg)(sc.Z0, sc.params)
    assert (np.asarray(ref.exit_code) == 1).all()
    _same(tl.solve_batch_lanes(Z0, params, C.model, scfg), ref)


@pytest.mark.parametrize("pc,backsolves", [(True, 2), (False, 1)])
def test_lane_step_riccati_calls(problem, monkeypatch, pc, backsolves):
    """One lane_step factors once (the K4a wrapper) and backsolves once per
    right-hand side (K4b): twice for the predictor-corrector, once for the
    monotone step; plain=True calls neither wrapper."""
    _, params, Z0 = problem
    scfg = dataclasses.replace(C.solver, predictor_corrector=pc)
    calls = {"factor": 0, "backsolve": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(lqr_kernel, "lqr_factor_fused_lanes",
                        counted("factor", lqr_kernel.lqr_factor_fused_lanes))
    monkeypatch.setattr(lqr_kernel, "lqr_backsolve_fused_lanes",
                        counted("backsolve",
                                lqr_kernel.lqr_backsolve_fused_lanes))
    lp = tl.lanes_params(params)
    st = tl._init_state(Z0.movedim(0, -1).contiguous(), lp, C.model, scfg)
    out = tl.lane_step(st, lp, C.model, scfg, 60)
    assert calls == {"factor": 1, "backsolve": backsolves}
    plain = tl.lane_step(st, lp, C.model, scfg, 60, plain=True)
    assert calls == {"factor": 1, "backsolve": backsolves}
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
