"""Port parity: ops/lqr_kernel.py's plain versions of the Riccati kernels
against the JAX package at f64, rtol = atol = 1e-9 (the tolerance of the
JAX package's own Pallas-vs-XLA parity checks, tools/kernel_parity_debug.py).

  K4 (fused assembly + factor, backsolve): the real-NLP inputs of
  kernel_parity_debug.py::check_fused_assembly, against JAX
  ipm_lanes._assemble_qp_blocks + riccati.solve_lqr_batched, at 30 and at
  18 corridor rows;
  K5 (pre-assembled blocks): the random well-conditioned LQR data of
  kernel_parity_debug.py::_random_lqr, against JAX riccati.solve_lqr_batched,
  plus the KKT residuals of check_lqr_kkt on the port's own output.

Also: CPU tensors take the plain versions without counting a launch, the
wrappers' checks reject bad shapes, dtypes and nh > 30 (on the meta device,
where the checks run and no kernel exists), and cuda-marked kernel-vs-plain
tests that skip without a GPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.dynamics.quadrotor import (
    rk2_jacobians_analytic,
    rk2_step,
)
from forces_resilient_planner_tpu.engine import batch as jb
from forces_resilient_planner_tpu.solver import ipm_lanes as jl
from forces_resilient_planner_tpu.solver import nlp as jnlp
from forces_resilient_planner_tpu.solver import riccati as jr
from chip_smoke import kkt_residuals, random_lqr
from forces_resilient_planner_tpu_torch.ops import lqr_kernel
from forces_resilient_planner_tpu_torch.solver import riccati as tr

F64 = torch.float64
TOL = 1e-9
NXB, NU = 13, 4
RMAX2 = C.model.max_rate ** 2


def _t(a, dtype=F64, device="cpu"):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _close(got, want, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=name)


# ---------------------------------------------------------------------------
# K4: the IPM's own stage data (kernel_parity_debug.py:205-281)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nlp_data():
    """Numpy inputs of K4 from a real NLP: weights, sigma, corridor rows,
    RK2 Jacobians and defects, and a random right-hand side."""
    rng = np.random.default_rng(7)
    goals = rng.uniform([-2, -2, 1.0], [2, 2, 1.5], (4, 3))
    forces = rng.uniform(-1.0, 1.0, (2, 3))
    halves = np.array([[4.0, 4.0, 1.5]])
    sc = jb.make_scenarios(C, goals, forces, halves, dtype=jnp.float64)
    lp = jl.lanes_params(sc.params)
    Z = jnp.moveaxis(sc.Z0, 0, -1)
    N, Bn = Z.shape[0], Z.shape[-1]
    lb, ub = jnlp.variable_bounds(C.model, jnp.float64)
    g0 = jl._ineq_residuals(Z, lp.corridor_A, lp.corridor_b, lb, ub, 1e-5)
    s_ = np.maximum(-np.asarray(g0), 1e-2)
    sigma = np.clip(1.0 / s_, 1e-6, 1e6) / s_
    x_bl = jnp.moveaxis(Z[:-1, 8:17], 1, -1)
    u_bl = jnp.moveaxis(Z[:-1, 0:4], 1, -1)
    f_bl = lp.f_ext.T
    Ax, Bx = rk2_jacobians_analytic(x_bl, u_bl, f_bl[None], C.model)
    xn = rk2_step(x_bl, u_bl, f_bl[None], C.model)
    F = jnp.concatenate([jnp.moveaxis(xn, -1, 1), Z[:-1, 0:4]], axis=1)
    c = F - jnp.concatenate([Z[1:, 8:17], Z[1:, 4:8]], axis=1)
    return dict(
        w=tuple(np.asarray(a) for a in lp.weights),
        sigma=sigma, Acor=np.asarray(lp.corridor_A),
        Ax=np.asarray(jnp.moveaxis(Ax, 1, -1)),
        Bx=np.asarray(jnp.moveaxis(Bx, 1, -1)), c=np.asarray(c),
        qx=rng.standard_normal((N, NXB, Bn)),
        qu=rng.standard_normal((N, NU, Bn)),
        dx0=0.01 * rng.standard_normal((9, Bn)),
    )


def _rows(d, nh):
    """The K4 inputs with the first nh corridor rows (and their sigmas)."""
    return d["sigma"][:, :34 + nh], d["Acor"][:, :nh]


def _jax_fused(d, nh):
    sigma, Acor = _rows(d, nh)
    N, Bn = d["qx"].shape[0], d["qx"].shape[-1]
    w = jnlp.StageWeights(*(jnp.asarray(a) for a in d["w"]))
    Wp, Rp, Sp = jl._assemble_qp_blocks(
        w, jnp.asarray(Acor), jnp.asarray(sigma),
        jnp.asarray(C.solver.reg, jnp.float64), RMAX2, jnp.float64)
    Abar = np.zeros((N - 1, NXB, NXB, Bn))
    Abar[:, :9, :9] = d["Ax"]
    Bbar = np.zeros((N - 1, NXB, NU, Bn))
    Bbar[:, :9] = d["Bx"]
    Bbar[:, 9:] = np.eye(NU)[None, :, :, None]
    fac = jax.jit(jr.lqr_factor_ll)(Wp, Rp, Sp, Abar, Bbar)
    sol = jax.jit(jr.solve_lqr_batched)(Wp, Rp, Sp, d["qx"], d["qu"], Abar,
                                        Bbar, d["c"], d["dx0"])
    return fac, sol


def _port_fused(d, nh, factor, backsolve, device="cpu", dtype=F64):
    sigma, Acor = _rows(d, nh)

    def t(a):
        return _t(np.ascontiguousarray(a), dtype, device)

    fac = factor(*(t(a) for a in d["w"]), t(sigma), t(Acor), t(d["Ax"]),
                 t(d["Bx"]), C.solver.reg, RMAX2)
    sol = backsolve(fac, t(d["Ax"]), t(d["Bx"]), t(d["c"]), t(d["qx"]),
                    t(d["qu"]), t(d["dx0"]))
    return fac, sol


@pytest.mark.parametrize("nh", [30, 18])
def test_fused_plain_matches_jax_assembly_and_solve(nlp_data, nh):
    fac_r, sol_r = _jax_fused(nlp_data, nh)
    fac, sol = _port_fused(nlp_data, nh,
                           lqr_kernel.lqr_factor_fused_reference,
                           lqr_kernel.lqr_backsolve_fused_reference)
    for name in tr.LQRFactor._fields:
        _close(getattr(fac, name), getattr(fac_r, name), name)
    for name in tr.LQRSolution._fields:
        _close(getattr(sol, name), getattr(sol_r, name), name)


def test_fused_wrappers_route_cpu_tensors_to_the_plain_versions(nlp_data):
    launches = dict(lqr_kernel.LAUNCHES)
    got = _port_fused(nlp_data, 30, lqr_kernel.lqr_factor_fused_lanes,
                      lqr_kernel.lqr_backsolve_fused_lanes)
    ref = _port_fused(nlp_data, 30, lqr_kernel.lqr_factor_fused_reference,
                      lqr_kernel.lqr_backsolve_fused_reference)
    for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
        assert torch.equal(g, r)
    assert lqr_kernel.LAUNCHES == launches


# ---------------------------------------------------------------------------
# K5: pre-assembled random blocks (kernel_parity_debug.py:117-202; the
# recipe and the KKT residuals are chip_smoke.py's, which phase 9 runs on
# the card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Bn", [128, 96])
def test_block_plain_matches_jax(Bn):
    args = random_lqr(np.random.default_rng(0), N=20, Bn=Bn)
    ref = jax.jit(jr.solve_lqr_batched)(*args)
    got = tr.solve_lqr_batched(*(_t(a) for a in args))
    for name in tr.LQRSolution._fields:
        _close(getattr(got, name), getattr(ref, name), name)
    fac = lqr_kernel.lqr_factor_reference(*(_t(args[i]) for i in (0, 1, 2, 5, 6)))
    fac_r = jax.jit(jr.lqr_factor_ll)(*(args[i] for i in (0, 1, 2, 5, 6)))
    for name in tr.LQRFactor._fields:
        _close(getattr(fac, name), getattr(fac_r, name), name)


def test_block_solution_satisfies_kkt():
    args = random_lqr(np.random.default_rng(1), N=8, Bn=128)
    sol = tr.solve_lqr_batched(*(_t(a) for a in args))
    res = kkt_residuals(args, sol)
    assert res["init"] <= 1e-12, res
    assert max(res.values()) <= 1e-8, res


def test_block_wrappers_route_cpu_and_batch_leading_entry():
    args = [_t(a) for a in random_lqr(np.random.default_rng(2), N=6, Bn=5)]
    launches = dict(lqr_kernel.LAUNCHES)
    got = tr.solve_lqr_batched(*args)
    Q, R, S, qx, qu, A, B, c, dx0 = args
    ref = tr.lqr_solve_ll(tr.lqr_factor_ll(Q, R, S, A, B), A, B, c, qx, qu, dx0)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    lead = tr.solve_lqr_batch(*(a.movedim(-1, 0) for a in args))
    for g, r in zip(lead, ref):
        assert g.shape == r.movedim(-1, 0).shape
        assert torch.equal(g, r.movedim(-1, 0))
    assert lqr_kernel.LAUNCHES == launches


# ---------------------------------------------------------------------------
# the wrappers' checks (meta tensors: every check runs, no kernel exists)
# ---------------------------------------------------------------------------

def _meta_fused(N=4, B=8, nh=30, dtype=torch.float32):
    def m(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    return ([m(N, B) for _ in range(5)], m(N, 34 + nh, B), m(N, nh, 3, B),
            m(N - 1, 9, 9, B), m(N - 1, 9, 4, B))


def _factor_fused(w, sigma, Acor, Ax, Bx):
    return lqr_kernel.lqr_factor_fused_lanes(*w, sigma, Acor, Ax, Bx, 1e-8,
                                             RMAX2)


def test_wrappers_reject_what_the_kernels_cannot_take():
    w, sigma, Acor, Ax, Bx = _meta_fused()
    with pytest.raises(ValueError, match="no route for tensors on meta"):
        _factor_fused(w, sigma, Acor, Ax, Bx)
    with pytest.raises(ValueError, match="corridor rows"):
        _factor_fused(*_meta_fused(nh=31))
    with pytest.raises(ValueError, match="sigma: shape"):
        _factor_fused(w, sigma[:, :40], Acor, Ax, Bx)
    with pytest.raises(ValueError, match="float32 or float64"):
        _factor_fused(*_meta_fused(dtype=torch.float16))
    with pytest.raises(ValueError, match="Bx: torch.float64"):
        _factor_fused(w, sigma, Acor, Ax, Bx.double())
    with pytest.raises(ValueError, match="contiguous"):
        _factor_fused(w, sigma, Acor, Ax.transpose(1, 2), Bx)
    with pytest.raises(ValueError, match="N >= 2"):
        _factor_fused(*_meta_fused(N=1))

    N, B = 4, 8
    fac = tr.LQRFactor(*(torch.empty(s, device="meta")
                         for s in lqr_kernel._factor_shapes(N, B)))
    c = torch.empty(N - 1, NXB, B, device="meta")
    qx = torch.empty(N, NXB, B, device="meta")
    qu = torch.empty(N, NU, B, device="meta")
    dx0 = torch.empty(9, B, device="meta")
    with pytest.raises(ValueError, match="no route"):
        lqr_kernel.lqr_backsolve_fused_lanes(fac, Ax, Bx, c, qx, qu, dx0)
    with pytest.raises(ValueError, match="qu: shape"):
        lqr_kernel.lqr_backsolve_fused_lanes(fac, Ax, Bx, c, qx, qx, dx0)
    with pytest.raises(ValueError, match="fac.P: shape"):
        lqr_kernel.lqr_backsolve_fused_lanes(fac._replace(P=fac.P[1:]), Ax,
                                             Bx, c, qx, qu, dx0)
    A = torch.empty(N - 1, NXB, NXB, B, device="meta")
    Bm = torch.empty(N - 1, NXB, NU, B, device="meta")
    with pytest.raises(ValueError, match="dynamics"):
        lqr_kernel.lqr_backsolve_lanes(fac, Ax, Bx, c, qx, qu, dx0)
    with pytest.raises(ValueError, match="no route"):
        lqr_kernel.lqr_backsolve_lanes(fac, A, Bm, c, qx, qu, dx0)
    Q = torch.empty(N, NXB, NXB, B, device="meta")
    R = torch.empty(N, NU, NU, B, device="meta")
    S = torch.empty(N, NU, NXB, B, device="meta")
    with pytest.raises(ValueError, match="no route"):
        lqr_kernel.lqr_factor_lanes(Q, R, S, A, Bm)
    with pytest.raises(ValueError, match="R: shape"):
        lqr_kernel.lqr_factor_lanes(Q, S, S, A, Bm)
    with pytest.raises(ValueError, match="float32 or float64"):
        lqr_kernel.lqr_factor_lanes(*(t.half() for t in (Q, R, S, A, Bm)))


# ---------------------------------------------------------------------------
# the kernels themselves (need a GPU; chip_smoke.py phase 9 runs the same
# comparisons at B = 4096)
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("nh", [30, 18])
def test_fused_kernels_match_plain_on_cuda(nlp_data, nh):
    _need_cuda()
    launches = dict(lqr_kernel.LAUNCHES)
    got = _port_fused(nlp_data, nh, lqr_kernel.lqr_factor_fused_lanes,
                      lqr_kernel.lqr_backsolve_fused_lanes, device="cuda")
    ref = _port_fused(nlp_data, nh, lqr_kernel.lqr_factor_fused_reference,
                      lqr_kernel.lqr_backsolve_fused_reference, device="cuda")
    torch.cuda.synchronize()
    assert lqr_kernel.LAUNCHES["lqr_factor_fused"] == \
        launches["lqr_factor_fused"] + 1
    assert lqr_kernel.LAUNCHES["lqr_backsolve_fused"] == \
        launches["lqr_backsolve_fused"] + 1
    for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
        assert ((g - r).abs() <= TOL * (1 + r.abs())).all()


@pytest.mark.cuda
def test_block_kernels_match_plain_on_cuda():
    _need_cuda()
    args = random_lqr(np.random.default_rng(0), N=20, Bn=96)
    dev = [_t(a, device="cuda") for a in args]
    launches = dict(lqr_kernel.LAUNCHES)
    got = tr.solve_lqr_batched(*dev)
    Q, R, S, qx, qu, A, B, c, dx0 = dev
    ref = tr.lqr_solve_ll(tr.lqr_factor_ll(Q, R, S, A, B), A, B, c, qx, qu,
                          dx0)
    torch.cuda.synchronize()
    assert lqr_kernel.LAUNCHES["lqr_factor"] == launches["lqr_factor"] + 1
    assert lqr_kernel.LAUNCHES["lqr_backsolve"] == launches["lqr_backsolve"] + 1
    for g, r in zip(got, ref):
        assert ((g - r).abs() <= TOL * (1 + r.abs())).all()
    res = kkt_residuals(args, [a.cpu() for a in got])
    assert max(res.values()) <= 1e-8, res
