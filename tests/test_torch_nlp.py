"""Port parity: solver/nlp.py and solver/problems.py of the torch port
against the JAX package: the constructions exact (no arithmetic beyond
what numpy does on both sides); the per-lane NLP block (stage_hessians ...
ineq_weighted_hessian) within 1e-12 (1 + |ref|) at f64 on seeded random
problems and on hover-to-goal problems of both profiles, and equal to the
lane-major helpers of solver/ipm_lanes.py on a B = 1 lane."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.solver import nlp as jn
from forces_resilient_planner_tpu.solver import problems as jp
from forces_resilient_planner_tpu_torch.engine import batch as tb
from forces_resilient_planner_tpu_torch.solver import nlp as tn
from forces_resilient_planner_tpu_torch.solver import problems as tp

F64 = torch.float64


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("final", [False, True])
def test_make_stage_weights_exact(final):
    ref = jn.make_stage_weights(C.weights, C.model.N, final=final)
    got = tn.make_stage_weights(
        C.weights, C.model.N, final=final, dtype=F64, device="cpu"
    )
    assert got._fields == ref._fields
    for g, r in zip(got, ref):
        _eq(g, r)


def test_variable_bounds_exact():
    lb_r, ub_r = jn.variable_bounds(C.model)
    lb, ub = tn.variable_bounds(C.model, F64, device="cpu")
    _eq(lb, lb_r)
    _eq(ub, ub_r)


def test_hover_warm_start_exact():
    x0 = np.random.default_rng(3).uniform(-1, 1, 9)
    ref = jax.jit(lambda s: jp.hover_warm_start(s, C.model))(x0)
    got = tp.hover_warm_start(torch.as_tensor(x0, dtype=F64), C.model)
    assert got.shape == (C.model.N, 17)
    _eq(got, ref)


def test_hover_to_goal_params_and_box_corridor_exact():
    x0 = np.zeros(9)
    x0[2] = 1.2
    goal = np.array([1.5, 0.8, 1.3])
    ref = jp.hover_to_goal_params(x0, goal, C.model, C.weights,
                                  f_ext=(0.2, -0.1, 0.3))
    got = tp.hover_to_goal_params(x0, goal, C.model, C.weights,
                                  f_ext=(0.2, -0.1, 0.3), device="cpu")
    for f in tn.NLPParams._fields[:-1]:
        _eq(getattr(got, f), getattr(ref, f))
    for g, r in zip(got.weights, ref.weights):
        _eq(g, r)


def test_nlp_params_from_numpy_carries_jax_problem_exactly():
    x0 = np.zeros(9)
    x0[2] = 1.2
    ref = jp.hover_to_goal_params(x0, np.array([-1.0, 2.0, 1.1]), C.model,
                                  C.weights, final=True)
    Z0 = jp.hover_warm_start(jnp.asarray(x0), C.model)
    for dtype in (torch.float64, torch.float32):
        got, Z0_t = tn.nlp_params_from_numpy(ref, Z0, dtype=dtype, device="cpu")
        assert isinstance(got, tn.NLPParams)
        assert isinstance(got.weights, tn.StageWeights)
        assert Z0_t.dtype == dtype and Z0_t.shape == (C.model.N, 17)
        for f in tn.NLPParams._fields[:-1]:
            np.testing.assert_array_equal(
                getattr(got, f).numpy(),
                np.asarray(getattr(ref, f)).astype(got.xinit.numpy().dtype),
            )
        for g, r in zip(got.weights, ref.weights):
            assert g.dtype == dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(g.numpy().dtype))


def test_lqr_warm_start_not_ported_raises():
    """warm_start="lqr" is ported and no longer raises: every scenario
    starts from problems.lqr_warm_start_batch on its own start state,
    references and force (the JAX grid's Z0: tests/test_torch_batch.py)."""
    cfg = dataclasses.replace(
        C, solver=dataclasses.replace(C.solver, warm_start="lqr")
    )
    sc = tb.make_scenarios(cfg, np.ones((1, 3)), np.zeros((1, 3)),
                           np.ones((1, 3)), dtype=F64, device="cpu")
    p = sc.params
    want = tp.lqr_warm_start_batch(
        p.xinit, p.ref_pos, p.ref_yaw, p.f_ext, C.model,
        torch.as_tensor(cfg.K_matrix(), dtype=F64))
    assert torch.equal(sc.Z0, want)
    hover = tp.hover_warm_start(p.xinit[0], C.model)
    assert not torch.equal(sc.Z0[0], hover)


# ---- the per-lane NLP block ------------------------------------------------

BLOCK_TOL = 1e-12
BLOCK = ("H", "grad", "cost", "c", "Ax", "Bx", "g", "JTv", "Jdz", "W")


def _block_problems():
    """(label, NLPParams as numpy-backed JAX params, Z, v, dz, sigma):
    two hover-to-goal problems (normal, final) and one seeded random one
    with random weights and corridor rows."""
    rng = np.random.default_rng(31)
    N = C.model.N
    x0 = np.zeros(9)
    x0[2] = 1.2
    out = []
    for final in (False, True):
        p = jp.hover_to_goal_params(x0, np.array([1.5, -0.7, 1.4]), C.model,
                                    C.weights, f_ext=(0.4, -0.2, 0.0),
                                    final=final)
        out.append((f"hover final={final}", p))
    w = jn.StageWeights(*(jnp.asarray(rng.uniform(0.1, 20.0, N))
                          for _ in jn.StageWeights._fields))
    p = jn.NLPParams(
        xinit=jnp.asarray(rng.normal(0, 1, 9)),
        ref_pos=jnp.asarray(rng.normal(0, 2, (N, 3))),
        ref_yaw=jnp.asarray(rng.normal(0, 1, N)),
        f_ext=jnp.asarray(rng.normal(0, 1, 3)),
        corridor_A=jnp.asarray(rng.normal(0, 1, (N, 30, 3))),
        corridor_b=jnp.asarray(rng.normal(0, 1, (N, 30))),
        weights=w,
    )
    out.append(("random", p))
    res = []
    for label, p in out:
        Z = np.asarray(jp.hover_warm_start(p.xinit, C.model)) + rng.normal(
            0, 0.3, (N, 17))
        res.append((label, p, Z, rng.normal(0, 1, (N, 64)),
                    rng.normal(0, 1, (N, 17)), rng.uniform(0, 5, (N, 64))))
    return res


def _jax_block(p, Z, v, dz, sigma):
    lb, ub = jn.variable_bounds(C.model)
    H = jn.stage_hessians(p.weights, C.model)
    Ax, Bx = jn.dynamics_jacobians(Z, p, C.model)
    return (H, jn.cost_gradient(Z, p, H), jn.cost_value(Z, p, H),
            jn.dynamics_residuals(Z, p, C.model), Ax, Bx,
            jn.inequality_residuals(Z, p, lb, ub, C.solver.corridor_slack),
            jn.ineq_jac_T_times(p, v), jn.ineq_jac_times(p, dz),
            jn.ineq_weighted_hessian(p, sigma))


def _port_block(p, Z, v, dz, sigma):
    lb, ub = tn.variable_bounds(C.model, F64, device="cpu")
    H = tn.stage_hessians(p.weights, C.model, F64)
    Ax, Bx = tn.dynamics_jacobians(Z, p, C.model)
    return (H, tn.cost_gradient(Z, p, H), tn.cost_value(Z, p, H),
            tn.dynamics_residuals(Z, p, C.model), Ax, Bx,
            tn.inequality_residuals(Z, p, lb, ub, C.solver.corridor_slack),
            tn.ineq_jac_T_times(p, v), tn.ineq_jac_times(p, dz),
            tn.ineq_weighted_hessian(p, sigma))


@pytest.fixture(scope="module")
def nlp_block():
    """Per problem: the port's problem and inputs, JAX's block, the port's."""
    f = jax.jit(_jax_block)
    out = []
    for label, p, Z, v, dz, sigma in _block_problems():
        ref = f(p, Z, v, dz, sigma)
        tp_, _ = tn.nlp_params_from_numpy(p, Z, dtype=F64, device="cpu")
        args = [torch.as_tensor(a) for a in (Z, v, dz, sigma)]
        out.append((label, tp_, args, ref, _port_block(tp_, *args)))
    return out


@pytest.mark.parametrize("name", BLOCK)
def test_nlp_block_matches_jax(nlp_block, name):
    i = BLOCK.index(name)
    for label, _, _, ref, got in nlp_block:
        want = np.asarray(ref[i])
        assert got[i].shape == want.shape, (label, name)
        err = np.max(np.abs(got[i].numpy() - want) / (1.0 + np.abs(want)))
        assert err <= BLOCK_TOL, (label, name, err)


def test_nlp_block_agrees_with_the_lane_major_helpers(nlp_block):
    """The per-lane functions and ipm_lanes' lane-major helpers compute the
    same gradient, inequality rows and constraint products on a B = 1 lane
    (neither calls the other: the lane-major ones keep a fixed sum order)."""
    from forces_resilient_planner_tpu_torch.solver import ipm_lanes as il

    lb, ub = tn.variable_bounds(C.model, F64, device="cpu")
    hu = C.solver.corridor_slack
    for label, p, (Z, v, dz, _), _, got in nlp_block:
        pl = il.lanes_params(il._map_params(lambda a: a[None], p))
        A = pl.corridor_A
        pairs = (
            ("grad", got[1], il._cost_gradient(
                Z[..., None], pl.weights, pl.ref_pos, pl.ref_yaw,
                C.model.max_rate ** 2)),
            ("g", got[6], il._ineq_residuals(Z[..., None], A, pl.corridor_b,
                                             lb, ub, hu)),
            ("JTv", got[7], il._ineq_jac_T_times(A, v[..., None])),
            ("Jdz", got[8], il._ineq_jac_times(A, dz[..., None])),
        )
        for name, a, b in pairs:
            b = b[..., 0]
            err = ((a - b).abs() / (1 + b.abs())).max().item()
            assert err <= BLOCK_TOL, (label, name, err)
