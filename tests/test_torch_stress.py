"""Port parity on the adversarial solver suite (tests/test_solver_stress.py):
the same near-infeasible corridors, starts outside the corridor, saturated
thrust, force-vs-wall conflicts, the randomized stress batch and the
exit-code taxonomy, solved by the port's lane solver and by the JAX lane
solver at f64 on the CPU.  Exit codes and iterations identical, Z within
1e-6, and every property the JAX suite asserts: no exit 1 with a corridor
violation beyond the slack, finite outputs, the stress batch's solved
fraction >= 0.5, the taxonomy pair [1, -7].

Two jitted JAX programs in the file: the single problems stacked into one
lane batch, and the B = 64 stress batch (tiers=(), as the JAX suite)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.solver import ipm_lanes as jl
from forces_resilient_planner_tpu.solver import problems as jp
from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.solver import ipm_lanes as tl
from forces_resilient_planner_tpu_torch.solver import nlp as tn
from forces_resilient_planner_tpu_torch.solver import problems as tp

F64 = torch.float64
MCFG = C.model
SCFG = dataclasses.replace(C.solver, tiers=())
X0 = np.zeros(9)
X0[2] = 1.2
SLACK = C.solver.corridor_slack
WALLS = (1.0, 0.5, 0.05, -0.05)
FYS = (0.0, 1.0, 2.0, 4.0, 8.0)
STRESS_B = 64

_jax_solve = jax.jit(
    lambda z, p: jl.solve_batch_lanes_tiered(z, p, MCFG, SCFG))


def _single_problems(lib):
    """The JAX suite's single problems, built by `lib` (the JAX package's
    problems module or the port's), in a fixed order: the empty corridor,
    the four walls, the saturated thrust, the five force conflicts, the
    taxonomy's feasible and empty-slab pair."""
    if lib is jp:
        def box(center, half):
            return jp.box_corridor(center, half, MCFG.N)

        def goal_params(goal, **kw):
            return jp.hover_to_goal_params(X0, goal, MCFG, C.weights, **kw)

        def with_b(p, A, b, rows):
            for k, v in rows.items():
                b = b.at[:, k].set(v)
            return p._replace(corridor_A=A, corridor_b=b)
    else:
        def box(center, half):
            return tp.box_corridor(center, half, MCFG.N, device="cpu")

        def goal_params(goal, **kw):
            return tp.hover_to_goal_params(X0, goal, MCFG, C.weights,
                                           device="cpu", **kw)

        def with_b(p, A, b, rows):
            for k, v in rows.items():
                b[:, k] = v
            return p._replace(corridor_A=A, corridor_b=b)

    centre, half = np.array([0.0, 0.0, 1.2]), np.array([5, 5, 2.0])
    out = [with_b(goal_params(np.array([1.0, 0.0, 1.2])), *box(centre, half),
                  {0: 0.5, 1: -0.6})]
    for wall_x in WALLS:
        out.append(with_b(goal_params(np.array([2.0, 0.0, 1.2])),
                          *box(centre, half), {1: -wall_x}))
    out.append(goal_params(np.array([0.0, 0.0, 2.5]),
                           f_ext=(0.0, 0.0, -12.0)))
    for fy in FYS:
        out.append(goal_params(np.array([2.0, 0.0, 1.2]), f_ext=(0.0, fy, 0.0),
                               corridor_half=(5.0, 0.45, 2.0)))
    out.append(goal_params(np.array([1.0, 0.0, 1.2])))
    out.append(workloads.empty_slab_params(dtype=F64, device="cpu")
               if lib is tp else out[0])
    return out


LANE_EMPTY, LANE_WALLS, LANE_SAT = 0, slice(1, 5), 5
LANE_FORCES, LANE_PAIR = slice(6, 11), slice(11, 13)


def _jax_stress_batch():
    """The JAX suite's stress batch, as test_stress_batch_no_false_optimals
    builds it."""
    rng = np.random.default_rng(123)
    problems = []
    for _ in range(STRESS_B):
        goal = rng.uniform([-2.5, -2.5, 0.6], [2.5, 2.5, 2.2], 3)
        f = rng.uniform(-4, 4, 3)
        half = rng.uniform([0.3, 0.3, 0.4], [4.0, 4.0, 2.0], 3)
        center = 0.5 * (X0[:3] + goal) + rng.uniform(-0.5, 0.5, 3)
        problems.append(jp.hover_to_goal_params(
            X0, goal, MCFG, C.weights, f_ext=tuple(f),
            corridor_center=center, corridor_half=tuple(half)))
    params = jax.tree.map(lambda *a: jnp.stack(a), *problems)
    Z0 = jnp.tile(jp.hover_warm_start(jnp.asarray(X0), MCFG)[None],
                  (STRESS_B, 1, 1))
    return Z0, params


def _solve_both(jax_Z0, jax_params, port_Z0, port_params):
    ref = _jax_solve(jax_Z0, jax_params)
    got = tl.solve_batch_lanes_tiered(port_Z0, port_params, MCFG, SCFG)
    return got, ref


def _same_problem(port_params, jax_params, port_Z0, jax_Z0):
    """The port's problems are the JAX package's, value for value."""
    want, Z0 = tn.nlp_params_from_numpy(jax_params, jax_Z0, dtype=F64,
                                        device="cpu")
    assert torch.equal(port_Z0, Z0)
    for a, b in zip(port_params[:-1], want[:-1]):
        assert torch.equal(a, b)
    for a, b in zip(port_params.weights, want.weights):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def singles():
    jparams = jax.tree.map(lambda *a: jnp.stack(a), *_single_problems(jp))
    pparams = workloads.stack_params(_single_problems(tp))
    B = pparams.xinit.shape[0]
    jZ0 = jnp.tile(jp.hover_warm_start(jnp.asarray(X0), MCFG)[None],
                   (B, 1, 1))
    pZ0 = tp.hover_warm_start(torch.as_tensor(X0), MCFG)[None].repeat(B, 1, 1)
    _same_problem(pparams, jparams, pZ0, jZ0)
    got, ref = _solve_both(jZ0, jparams, pZ0, pparams)
    return got, ref, pparams


@pytest.fixture(scope="module")
def stress():
    jZ0, jparams = _jax_stress_batch()
    pZ0, pparams = workloads.stress_params(STRESS_B, dtype=F64, device="cpu")
    _same_problem(pparams, jparams, pZ0, jZ0)
    got, ref = _solve_both(jZ0, jparams, pZ0, pparams)
    return got, ref, pparams


def _same_as_jax(got, ref, lanes):
    """Exit codes and iterations identical, Z within 1e-6, all finite."""
    np.testing.assert_array_equal(got.exit_code.numpy()[lanes],
                                  np.asarray(ref.exit_code)[lanes])
    np.testing.assert_array_equal(got.iters.numpy()[lanes],
                                  np.asarray(ref.iters)[lanes])
    np.testing.assert_allclose(got.Z.numpy()[lanes], np.asarray(ref.Z)[lanes],
                               rtol=0, atol=1e-6)
    assert bool(torch.isfinite(got.Z[lanes]).all())


def _corridor_excess(Z, params, first_stage=0):
    """Max corridor violation a lane, over stages first_stage..N-1."""
    A = params.corridor_A[:, first_stage:]
    pos = Z[:, first_stage:, 8:11]
    return (torch.einsum("bnkj,bnj->bnk", A, pos)
            - params.corridor_b[:, first_stage:]).amax(dim=(1, 2))


def test_empty_corridor_reports_failure(singles):
    got, ref, _ = singles
    _same_as_jax(got, ref, LANE_EMPTY)
    assert int(got.exit_code[LANE_EMPTY]) == -7


def test_start_outside_corridor_recovers_or_fails_honestly(singles):
    got, ref, params = singles
    _same_as_jax(got, ref, LANE_WALLS)
    lb, ub = tn.variable_bounds(MCFG, F64, device="cpu")
    cv_free = _corridor_excess(got.Z, params, first_stage=1)
    bound = torch.maximum(lb - got.Z, got.Z - ub).amax(dim=(1, 2))
    for lane, wall_x in zip(range(1, 5), WALLS):
        if int(got.exit_code[lane]) == 1:
            assert float(cv_free[lane]) <= SLACK + 1e-6, (wall_x, cv_free)
            assert float(bound[lane]) <= 1e-6, (wall_x, bound)


def test_saturated_thrust_stays_within_bounds(singles):
    got, ref, _ = singles
    _same_as_jax(got, ref, LANE_SAT)
    _, ub = tn.variable_bounds(MCFG, F64, device="cpu")
    thrust = float(got.Z[LANE_SAT, :, 3].max())
    assert thrust <= float(ub[3]) + 1e-8
    assert thrust >= float(ub[3]) - 0.5


def test_force_conflicts_with_corridor_wall(singles):
    got, ref, params = singles
    _same_as_jax(got, ref, LANE_FORCES)
    cv = _corridor_excess(got.Z, params)
    rates = got.exit_code[LANE_FORCES].tolist()
    for lane, fy in zip(range(6, 11), FYS):
        if int(got.exit_code[lane]) == 1:
            assert float(cv[lane]) <= SLACK + 1e-6, (fy, float(cv[lane]))
    assert rates[0] == 1 and rates[1] == 1, rates


def test_stress_batch_no_false_optimals(stress):
    got, ref, params = stress
    _same_as_jax(got, ref, slice(None))
    solved = got.exit_code == 1
    false_optimal = solved & (_corridor_excess(got.Z, params, 1)
                              > SLACK + 1e-6)
    assert not false_optimal.any(), torch.nonzero(false_optimal)
    assert solved.double().mean() >= 0.5, solved.double().mean()
    # the failures are the reference's families, not only max-iter
    assert set(got.exit_code.tolist()) <= {1, 0, -6, -7}


def test_exit_code_taxonomy(singles):
    got, ref, _ = singles
    _same_as_jax(got, ref, LANE_PAIR)
    assert got.exit_code[LANE_PAIR].tolist() == [1, -7]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stress_params_cast_from_the_f64_build(dtype):
    """stress_params at any dtype is the f64 build cast, on every field."""
    Z64, p64 = workloads.stress_params(3, seed=7, dtype=F64, device="cpu")
    Z, p = workloads.stress_params(3, seed=7, dtype=dtype, device="cpu")
    assert torch.equal(Z, Z64.to(dtype))
    for a, b in zip(list(p[:-1]) + list(p.weights),
                    list(p64[:-1]) + list(p64.weights)):
        assert a.dtype == dtype and torch.equal(a, b.to(dtype))
