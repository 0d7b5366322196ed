"""Port parity: the lane-major Riccati factor/backsolve of the torch port
against solver/riccati.py (lane-major half) on random SPD stage data, f64,
rtol 1e-10 (roundoff of a 6-stage recursion on well-conditioned blocks)."""
import jax
import numpy as np
import torch

from forces_resilient_planner_tpu.solver import riccati as jr
from forces_resilient_planner_tpu_torch.solver import riccati as tr

N, B = 6, 5
RTOL, ATOL = 1e-10, 1e-12


def _stage_data():
    rng = np.random.default_rng(5)

    def spd(n, count):
        M = rng.normal(size=(count, n, n, B))
        return np.einsum("sijb,skjb->sikb", M, M) + n * np.eye(n)[None, :, :, None]

    Q = spd(13, N)
    R = spd(4, N)
    S = 0.1 * rng.normal(size=(N, 4, 13, B))
    A = np.eye(13)[None, :, :, None] + 0.1 * rng.normal(size=(N - 1, 13, 13, B))
    Bm = 0.3 * rng.normal(size=(N - 1, 13, 4, B))
    c = rng.normal(size=(N - 1, 13, B))
    qx = rng.normal(size=(N, 13, B))
    qu = rng.normal(size=(N, 4, B))
    dx0 = rng.normal(size=(9, B))
    return Q, R, S, A, Bm, c, qx, qu, dx0


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_lqr_factor_and_solve_match_jax():
    Q, R, S, A, Bm, c, qx, qu, dx0 = _stage_data()
    fac_r = jax.jit(jr.lqr_factor_ll)(Q, R, S, A, Bm)
    sol_r = jax.jit(jr.lqr_solve_ll)(fac_r, A, Bm, c, qx, qu, dx0)
    fac = tr.lqr_factor_ll(*map(_t, (Q, R, S, A, Bm)))
    sol = tr.lqr_solve_ll(fac, *map(_t, (A, Bm, c, qx, qu, dx0)))
    for name in tr.LQRFactor._fields:
        np.testing.assert_allclose(
            getattr(fac, name).numpy(), np.asarray(getattr(fac_r, name)),
            rtol=RTOL, atol=ATOL, err_msg=name,
        )
    for name in tr.LQRSolution._fields:
        np.testing.assert_allclose(
            getattr(sol, name).numpy(), np.asarray(getattr(sol_r, name)),
            rtol=RTOL, atol=ATOL, err_msg=name,
        )


def test_lqr_solution_satisfies_dynamics_and_init():
    """The backsolve's trajectory obeys the linear dynamics and the fixed
    part of the initial state."""
    Q, R, S, A, Bm, c, qx, qu, dx0 = map(_t, _stage_data())
    sol = tr.lqr_solve_ll(tr.lqr_factor_ll(Q, R, S, A, Bm), A, Bm, c, qx, qu, dx0)
    for i in range(N - 1):
        nxt = tr._mv_ll(A[i], sol.dxb[i]) + tr._mv_ll(Bm[i], sol.du[i]) + c[i]
        np.testing.assert_allclose(sol.dxb[i + 1].numpy(), nxt.numpy(), atol=1e-10)
    np.testing.assert_allclose(sol.dxb[0, :9].numpy(), dx0.numpy(), atol=0)
    np.testing.assert_allclose(sol.dxb[0, 9:].numpy(), sol.dtheta.numpy(), atol=0)


def test_chol4_solvers_invert_spd_blocks():
    rng = np.random.default_rng(9)
    M = rng.normal(size=(4, 4, B))
    A = _t(np.einsum("ijb,kjb->ikb", M, M) + 4 * np.eye(4)[:, :, None])
    X = _t(rng.normal(size=(4, 3, B)))
    rhs = tr._mm_ll(A, X)
    np.testing.assert_allclose(tr.spd_solve4_ll(A, rhs).numpy(), X.numpy(),
                               rtol=1e-10, atol=1e-12)
    packed = torch.stack(tr._chol4_ll(A), dim=0)
    np.testing.assert_allclose(tr.chol4_solve_ll(packed, rhs).numpy(),
                               X.numpy(), rtol=1e-10, atol=1e-12)
