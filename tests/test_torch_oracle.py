"""Port parity: oracle/cpu_oracle.py of the torch port against the JAX
package's oracle at f64 on the CPU.  Both run scipy's SLSQP with the same
ftol on the same condensed problem (one hover-to-goal problem with an
external force): the same Z within 1e-6.  The KKT certificate of both at
the same point agrees, the port's solution is a KKT point by it, and the
port's interior-point solve of the problem lies within the control bar
(1e-3 in u) of the port's oracle, as the JAX package holds its own."""
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as JC
from forces_resilient_planner_tpu.oracle import cpu_oracle as jo
from forces_resilient_planner_tpu.solver import problems as jp
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.oracle import cpu_oracle as to
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.solver.problems import (
    hover_to_goal_params,
    hover_warm_start,
)

X0 = np.array([0, 0, 1.2, 0, 0, 0, 0, 0, 0], float)
GOAL = np.array([1.5, 0.8, 1.2])
F_EXT = (0.4, -0.2, 0.0)


@pytest.fixture(scope="module")
def oracles():
    pj = jp.hover_to_goal_params(X0, GOAL, JC.model, JC.weights, f_ext=F_EXT)
    Zj, rj = jo.solve_oracle(pj, JC.model, JC.solver)
    p = hover_to_goal_params(X0, GOAL, C.model, C.weights, f_ext=F_EXT,
                             device="cpu")
    Z, r = to.solve_oracle(p, C.model, C.solver)
    return (pj, Zj, rj), (p, Z, r)


def test_oracle_matches_jax(oracles):
    (_, Zj, rj), (_, Z, r) = oracles
    assert Z.shape == (20, 17) and Z.dtype == np.float64
    assert np.max(np.abs(Z - Zj)) <= 1e-6
    assert r.nit > 10 and rj.nit > 10


def test_kkt_certificate_matches_jax_at_the_same_point(oracles):
    (pj, _, rj), (p, _, r) = oracles
    fj, sj = jo.kkt_certificate(rj.x, pj, JC.model, JC.solver)
    f, s = to.kkt_certificate(rj.x, p, C.model, C.solver)
    assert f == pytest.approx(fj, rel=1e-6, abs=1e-12)
    assert s == pytest.approx(sj, rel=1e-6, abs=1e-12)
    feas, stat = to.kkt_certificate(r.x, p, C.model, C.solver)
    assert feas <= 1e-8 and stat <= 1e-4


def test_condensed_derivatives_match_finite_differences(oracles):
    """The chain rule through the rollout equals the derivative of the
    condensed cost and constraints (central differences)."""
    _, (p, _, r) = oracles
    prob = to._Condensed(p, C.model, C.solver)
    v = r.x + np.random.default_rng(1).normal(0, 1e-2, r.x.size)
    g, J = prob.grad(v), prob.cons_jac(v)
    h = 1e-6
    for j in (0, 3, 7, 40, 83):
        e = np.zeros_like(v)
        e[j] = h
        fd = (prob.value(v + e) - prob.value(v - e)) / (2 * h)
        assert abs(g[j] - fd) <= 1e-5 * (1 + abs(fd))
        fdc = (prob.cons(v + e) - prob.cons(v - e)) / (2 * h)
        np.testing.assert_allclose(J[:, j], fdc, atol=1e-6)


def test_ipm_solve_within_the_control_bar_of_the_oracle(oracles):
    _, (p, Z, _) = oracles
    Z0 = hover_warm_start(torch.as_tensor(X0), C.model)
    res = ipm_lanes.solve_batch_lanes(
        Z0[None], ipm_lanes._map_params(lambda a: a[None], p), C.model,
        C.solver)
    assert int(res.exit_code[0]) == 1
    assert np.max(np.abs(res.Z[0, :, :4].numpy() - Z[:, :4])) <= 1e-3
