"""Port parity: ops/ipm_kernel.py's plain iteration (one monotone step of
the lane-major IPM) against the JAX package's solver/ipm_lanes.py::
_run_lanes, from the initial state and from a mid-solve state, on the
24-lane set of tests/test_ipm_lanes.py.  f64: atol 1e-10 (plus rtol 1e-10
for the large dual values), it/done exact.  The CUDA kernel itself is
held against this plain version on the card (cuda-marked test below,
and phase 2 of chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.engine import batch as jb
from forces_resilient_planner_tpu.solver import ipm_lanes as jl
from forces_resilient_planner_tpu_torch.ops import ipm_kernel
from forces_resilient_planner_tpu_torch.solver import ipm_lanes as tl
from forces_resilient_planner_tpu_torch.solver import nlp as tn

F64 = torch.float64


def _scenarios():
    rng = np.random.default_rng(11)
    goals = rng.uniform([-2.5, -2.5, 1.0], [2.5, 2.5, 1.6], (4, 3))
    forces = np.vstack([[0.0, 0.0, 0.0], rng.uniform(-1.5, 1.5, (2, 3))])
    halves = np.array([[5.0, 5.0, 2.0], [2.0, 3.0, 1.2]])
    return jb.make_scenarios(C, goals, forces, halves, dtype=jnp.float64)


@pytest.fixture(scope="module")
def jax_run():
    """Lane-major JAX params and states after k = 0, 1, 6, 7 iterations."""
    sc = _scenarios()
    Z0 = jnp.moveaxis(sc.Z0, 0, -1)
    p = jl.lanes_params(sc.params)
    st0 = jax.jit(lambda Z, p: jl._init_state(Z, p, C.model, C.solver))(Z0, p)
    states = {0: st0}
    for k in (1, 6, 7):
        states[k] = jax.jit(
            lambda st, p, k=k: jl._run_lanes(st, p, C.model, C.solver, k)
        )(st0, p)
    return Z0, p, states


def _port_state(st):
    return tuple(torch.as_tensor(np.array(a)) for a in st)


def _step_args(st, params, max_iters):
    Z, lam, s, mu_d, mu, it, done, err = st
    scal = torch.stack([mu, it.to(F64), done.to(F64), err])
    B = Z.shape[-1]
    return (Z, lam, s, mu_d, scal, params.weights, params.ref_pos,
            params.ref_yaw, params.corridor_A, params.corridor_b,
            params.f_ext, params.xinit,
            torch.full((B,), float(max_iters), dtype=F64), C.model, C.solver)


def test_init_state_matches_jax(jax_run):
    Z0, p, states = jax_run
    params, Z0_t = tn.nlp_params_from_numpy(p, Z0, dtype=F64, device="cpu")
    got = tl._init_state(Z0_t, params, C.model, C.solver)
    for g, r in zip(got, states[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("k", [0, 6])
def test_reference_step_matches_jax_run_lanes(jax_run, k):
    Z0, p, states = jax_run
    params, _ = tn.nlp_params_from_numpy(p, Z0, dtype=F64, device="cpu")
    Zn, lamn, sn, mudn, scal = ipm_kernel.ipm_iteration_reference(
        *_step_args(_port_state(states[k]), params, k + 1)
    )
    Z, lam, s, mu_d, mu, it, done, err = states[k + 1]
    np.testing.assert_array_equal(scal[1].numpy(), np.asarray(it, float))
    np.testing.assert_array_equal(scal[2].numpy() > 0.5, np.asarray(done))
    assert (np.asarray(it) == k + 1).all()
    for g, r in ((Zn, Z), (lamn, lam), (sn, s), (mudn, mu_d),
                 (scal[0], mu), (scal[3], err)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=1e-10, atol=1e-10)


def test_inactive_lanes_keep_their_state(jax_run):
    """A lane at its iteration cap is not stepped (the stepper mask)."""
    Z0, p, states = jax_run
    params, _ = tn.nlp_params_from_numpy(p, Z0, dtype=F64, device="cpu")
    args = _step_args(_port_state(states[6]), params, 6)
    out = ipm_kernel.ipm_iteration_reference(*args)
    for g, r in zip(out, args[:5]):
        assert torch.equal(g, r)


def test_fused_routes_cpu_tensors_to_the_plain_version(jax_run):
    Z0, p, states = jax_run
    params, _ = tn.nlp_params_from_numpy(p, Z0, dtype=F64, device="cpu")
    args = _step_args(_port_state(states[1]), params, 60)
    launches = ipm_kernel.LAUNCHES
    for g, r in zip(ipm_kernel.ipm_iteration_fused(*args),
                    ipm_kernel.ipm_iteration_reference(*args)):
        assert torch.equal(g, r)
    assert ipm_kernel.LAUNCHES == launches


def test_fused_rejects_predictor_corrector(jax_run):
    Z0, p, states = jax_run
    params, _ = tn.nlp_params_from_numpy(p, Z0, dtype=F64, device="cpu")
    args = list(_step_args(_port_state(states[0]), params, 60))
    args[-1] = dataclasses.replace(C.solver, predictor_corrector=True)
    with pytest.raises(ValueError, match="monotone"):
        ipm_kernel.ipm_iteration_fused(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel_tol", [(torch.float64, 1e-9),
                                           (torch.float32, 1e-3)])
def test_kernel_matches_plain_on_cuda(jax_run, dtype, rel_tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    Z0, p, states = jax_run
    params, _ = tn.nlp_params_from_numpy(p, Z0, dtype=dtype, device="cuda")
    st = tuple(
        a.to("cuda", dtype) if a.is_floating_point() else a.to("cuda")
        for a in _port_state(states[6])
    )
    Z, lam, s, mu_d, mu, it, done, err = st
    scal = torch.stack([mu, it.to(dtype), done.to(dtype), err])
    args = (Z, lam, s, mu_d, scal, params.weights, params.ref_pos,
            params.ref_yaw, params.corridor_A, params.corridor_b,
            params.f_ext, params.xinit,
            torch.full((Z.shape[-1],), 60.0, dtype=dtype, device="cuda"),
            C.model, C.solver)
    launches = ipm_kernel.LAUNCHES
    got = ipm_kernel.ipm_iteration_fused(*args)
    ref = ipm_kernel.ipm_iteration_reference(*args)
    torch.cuda.synchronize()
    assert ipm_kernel.LAUNCHES == launches + 1
    assert torch.equal(got[4][1:3], ref[4][1:3])
    for g, r in zip(got, ref):
        assert ((g - r).abs() <= rel_tol * (1 + r.abs())).all()
