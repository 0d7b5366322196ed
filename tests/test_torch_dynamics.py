"""Port parity: forces_resilient_planner_tpu_torch.dynamics.quadrotor against
the JAX dynamics, same numpy inputs, f64, atol 1e-12 (roundoff only: the
formulas are the same, the summation order may differ)."""
import jax
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.dynamics import quadrotor as jq
from forces_resilient_planner_tpu_torch.dynamics import quadrotor as tq

ATOL = 1e-12


def _inputs(n=32):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-3, 3, (n, 3)),          # position
        rng.uniform(-2, 2, (n, 3)),          # velocity
        rng.uniform(-0.6, 0.6, (n, 3)),      # roll pitch yaw
    ], axis=1)
    u = np.concatenate(
        [rng.uniform(-1.2, 1.2, (n, 3)), rng.uniform(4.0, 12.0, (n, 1))], axis=1
    )
    f = rng.uniform(-1.5, 1.5, (n, 3))
    return x, u, f


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("name", ["continuous_dynamics", "rk2_step"])
def test_dynamics_match_jax(name):
    x, u, f = _inputs()
    ref = jax.jit(lambda x, u, f: getattr(jq, name)(x, u, f, C.model))(x, u, f)
    got = getattr(tq, name)(_t(x), _t(u), _t(f), C.model)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_euler_to_rot_matches_jax():
    x, _, _ = _inputs()
    ref = jax.jit(jq.euler_to_rot)(x[:, 6:9])
    got = tq.euler_to_rot(_t(x[:, 6:9]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_continuous_jacobians_match_jax():
    x, u, _ = _inputs()
    Jr, Br = jax.jit(
        lambda x, u: jq.continuous_jacobians_analytic(x, u, C.model)
    )(x, u)
    Jg, Bg = tq.continuous_jacobians_analytic(_t(x), _t(u), C.model)
    np.testing.assert_allclose(Jg.numpy(), np.asarray(Jr), rtol=0, atol=ATOL)
    np.testing.assert_allclose(Bg.numpy(), np.asarray(Br), rtol=0, atol=ATOL)


def test_rk2_jacobians_match_jax():
    x, u, f = _inputs()
    Ar, Br = jax.jit(
        lambda x, u, f: jq.rk2_jacobians_analytic(x, u, f, C.model)
    )(x, u, f)
    Ag, Bg = tq.rk2_jacobians_analytic(_t(x), _t(u), _t(f), C.model)
    np.testing.assert_allclose(Ag.numpy(), np.asarray(Ar), rtol=0, atol=ATOL)
    np.testing.assert_allclose(Bg.numpy(), np.asarray(Br), rtol=0, atol=ATOL)


def test_rk2_jacobian_matches_finite_difference():
    """The analytic Jacobian is the derivative of the port's own rk2_step."""
    x, u, f = (_t(a[:4]) for a in _inputs())
    A, B = tq.rk2_jacobians_analytic(x, u, f, C.model)
    h = 1e-6
    for j in range(9):
        e = torch.zeros(9, dtype=torch.float64)
        e[j] = h
        fd = (tq.rk2_step(x + e, u, f, C.model)
              - tq.rk2_step(x - e, u, f, C.model)) / (2 * h)
        np.testing.assert_allclose(A[..., j].numpy(), fd.numpy(), atol=1e-7)
    for j in range(4):
        e = torch.zeros(4, dtype=torch.float64)
        e[j] = h
        fd = (tq.rk2_step(x, u + e, f, C.model)
              - tq.rk2_step(x, u - e, f, C.model)) / (2 * h)
        np.testing.assert_allclose(B[..., j].numpy(), fd.numpy(), atol=1e-7)


@pytest.fixture(scope="module")
def jax_autodiff():
    """JAX's autodiff Jacobians at 8 points (one jitted vmap each)."""
    x, u, f = _inputs(8)

    def both(fn):
        return jax.jit(jax.vmap(lambda a, b, c: fn(a, b, c, C.model)))(x, u, f)

    return both(jq.ab_jacobians), both(jq.continuous_jacobians)


def _close(got, want, tol=ATOL):
    want = np.asarray(want)
    err = np.max(np.abs(got.numpy() - want) / (1.0 + np.abs(want)))
    assert err <= tol, err


@pytest.mark.parametrize("name", ["ab_jacobians", "continuous_jacobians"])
def test_autodiff_jacobians_match_jax(jax_autodiff, name):
    """torch.func.jacfwd of the port's rk2_step / continuous_dynamics
    against jax.jacfwd of JAX's, within 1e-12 (1 + |ref|), point by point."""
    ref = jax_autodiff[name == "continuous_jacobians"]
    x, u, f = _inputs(8)
    for i in range(8):
        A, B = getattr(tq, name)(_t(x[i]), _t(u[i]), _t(f[i]), C.model)
        assert A.shape == (9, 9) and B.shape == (9, 4)
        _close(A, ref[0][i])
        _close(B, ref[1][i])


def test_autodiff_jacobians_match_the_analytic_ones():
    """As tests/test_dynamics.py holds JAX's: the autodiff Jacobians equal
    the closed forms the solver and the tubes use."""
    x, u, f = _inputs(8)
    Aa, Ba = tq.rk2_jacobians_analytic(_t(x), _t(u), _t(f), C.model)
    Ja, Bca = tq.continuous_jacobians_analytic(_t(x), _t(u), C.model)
    for i in range(8):
        A, B = tq.ab_jacobians(_t(x[i]), _t(u[i]), _t(f[i]), C.model)
        _close(A, Aa[i].numpy())
        _close(B, Ba[i].numpy())
        At, Bt = tq.continuous_jacobians(_t(x[i]), _t(u[i]), _t(f[i]),
                                         C.model)
        _close(At, Ja[i].numpy())
        _close(Bt, Bca[i].numpy())
        # structure (nmpc_solver.cpp:8-26): dp/dv = I, deuler/du = I
        np.testing.assert_array_equal(At[0:3, 3:6].numpy(), np.eye(3))
        np.testing.assert_array_equal(Bt[6:9, 0:3].numpy(), np.eye(3))


def test_thrust_world_acc_matches_jax():
    x, u, _ = _inputs()
    ref = jax.jit(lambda r, t: jq.thrust_world_acc(r, t, C.model))(
        x[:, 6:9], u[:, 3])
    got = tq.thrust_world_acc(_t(x[:, 6:9]), _t(u[:, 3]), C.model)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    # hover thrust at level attitude cancels gravity
    hov = tq.thrust_world_acc(torch.zeros(3, dtype=torch.float64),
                              torch.tensor(C.model.hover_thrust,
                                           dtype=torch.float64), C.model)
    np.testing.assert_allclose(hov.numpy(), 0.0, atol=1e-12)
