"""Port parity: solver/nlp.py and solver/problems.py of the torch port
against the JAX package (exact: these are constructions, no arithmetic
beyond what numpy does on both sides)."""
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
