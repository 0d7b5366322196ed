"""Port parity: ops/ipm_kernel.py's plain iteration (one monotone step of
the lane-major IPM) against the JAX package's solver/ipm_lanes.py::
_run_lanes, from the initial state and from a mid-solve state, on the
24-lane set of tests/test_ipm_lanes.py.  f64: atol 1e-10 (plus rtol 1e-10
for the large dual values), it/done exact.  The CUDA kernel itself is
held against this plain version on the card (cuda-marked test below,
and phase 2 of chip_smoke.py), and its source's arithmetic on the CPU:
csrc/ipm_iteration.cu compiled with g++ against tests/cuda_emu (a host
stand-in of the CUDA runtime that runs each thread of a block as a
std::thread) matches the plain version at f64 within 1e-9 (1 + |ref|),
with identical it/done, and gives every lane the same bits wherever it
sits.  The wrapper's checks and its launch geometry are tested here too
(meta tensors: every check runs, no kernel exists)."""
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.engine import batch as jb
from forces_resilient_planner_tpu.solver import ipm_lanes as jl
from forces_resilient_planner_tpu_torch.ops import _build, ipm_kernel
from forces_resilient_planner_tpu_torch.solver import ipm_lanes as tl
from forces_resilient_planner_tpu_torch.solver import nlp as tn

F64 = torch.float64
EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")


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


def test_cpu_route_is_bit_identical_to_lane_step(jax_run):
    """The CPU route of the wrapper is one plain lane_step, bit for bit."""
    Z0, p, states = jax_run
    params, _ = tn.nlp_params_from_numpy(p, Z0, dtype=F64, device="cpu")
    st = _port_state(states[6])
    got = ipm_kernel.ipm_iteration_fused(*_step_args(st, params, 60))
    want = tl.lane_step(st, params, C.model, C.solver, 60, plain=True)
    Z, lam, s, mu_d, mu, it, done, err = want
    for g, r in zip(got, (Z, lam, s, mu_d,
                          torch.stack([mu, it.to(F64), done.to(F64), err]))):
        assert torch.equal(g, r)


# ---- launch geometry and the wrapper's checks -----------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [2, 4, 6, 10, 20])
def test_launch_geometry_fits_a_cta(dtype, N):
    lanes, smem, stride = ipm_kernel.launch_geometry(dtype, N)
    size = torch.empty((), dtype=dtype).element_size()
    assert 1 <= lanes <= ipm_kernel.MAX_LANES and lanes & (lanes - 1) == 0
    assert smem == lanes * stride * size <= 232_448
    assert stride >= ipm_kernel.lane_elements(N) and stride % 32 == 8
    # the most lanes that fit: one more power of two would not
    assert (2 * lanes > ipm_kernel.MAX_LANES
            or 2 * lanes * stride * size > 232_448)


def test_launch_geometry_at_the_main_path_horizon():
    """N = 20: four lanes of ~50 KB per CTA at f32, two at f64."""
    assert ipm_kernel.launch_geometry(torch.float32, 20)[0] == 4
    assert ipm_kernel.launch_geometry(torch.float64, 20)[0] == 2
    assert ipm_kernel.launch_geometry(torch.float32, 20, max_lanes=2)[0] == 2


@pytest.mark.parametrize("dtype,N", [(torch.float32, 100),
                                     (torch.float64, 50), (torch.float32, 1)])
def test_launch_geometry_raises_where_a_lane_does_not_fit(dtype, N):
    with pytest.raises(ValueError):
        ipm_kernel.launch_geometry(dtype, N)


def _meta_args(N=4, B=8, dtype=torch.float32, shapes=None):
    def t(shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    shapes = shapes or {}
    NZ, NXB, NIN, NH = 17, 13, 64, 30
    Z = t(shapes.get("Z", (N, NZ, B)))
    w = tn.StageWeights(*(t((N, B)) for _ in range(5)))
    return (Z, t((N, NXB, B)), t((N, NIN, B)), t((N, NIN, B)), t((4, B)), w,
            t((N, 3, B)), t((N, B)), t(shapes.get("A", (N, NH, 3, B))),
            t((N, NH, B)), t((3, B)), t((9, B)), t((B,)), C.model, C.solver)


def test_wrapper_checks_run_and_meta_has_no_route():
    with pytest.raises(ValueError, match="no route for tensors on meta"):
        ipm_kernel.ipm_iteration_fused(*_meta_args())


@pytest.mark.parametrize("case", ["shape", "rows", "dtype", "device", "N",
                                  "superlin", "contiguous"])
def test_wrapper_rejects_bad_inputs(case):
    args = list(_meta_args())
    match = {"shape": "Z: shape", "rows": "A: shape", "dtype": "float32 or",
             "device": "expected torch.float32 on meta", "N": "N >= 2",
             "superlin": "mu_superlin", "contiguous": "contiguous"}[case]
    if case == "shape":
        args = list(_meta_args(shapes={"Z": (4, 16, 8)}))
    elif case == "rows":
        args = list(_meta_args(shapes={"A": (4, 18, 3, 8)}))
    elif case == "dtype":
        args = list(_meta_args(dtype=torch.float16))
    elif case == "device":
        args[1] = torch.empty(args[1].shape)
    elif case == "N":
        args = list(_meta_args(N=1))
    elif case == "superlin":
        args[-1] = dataclasses.replace(C.solver, mu_superlin=2.0)
    else:
        args[2] = torch.empty(8, 64, 4, device="meta").transpose(0, 2)
    with pytest.raises(ValueError, match=match):
        ipm_kernel.ipm_iteration_fused(*args)


# ---- the CUDA source's arithmetic on the CPU (g++ and tests/cuda_emu) -----

@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    """csrc/ipm_iteration.cu built with g++ against the host stand-in of the
    CUDA runtime: its launch becomes emu::launch, its dynamic shared memory
    a per-block buffer."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("emu")
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    src = (_build.CSRC / ipm_kernel.SOURCE).read_text()
    src, n_smem = re.subn(r"extern __shared__[^;]*\b(\w+)\[\];",
                          r"unsigned char* \1 = emu::shared_memory();", src)
    src, n_launch = re.subn(
        r"([\w:]+(?:<\w+>)?)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>\(",
        r"emu::launch(\1, \2,\3,\4, ", src)
    assert n_smem == 1 and n_launch == 1
    (out / "ipm_iteration.cpp").write_text(src)
    so = out / "libipm_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-I", EMU, "-I", str(out), "-o", str(so), str(out / "ipm_iteration.cpp")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    ipm_kernel._bind(lib)
    return lib


def _emulated(lib, args):
    ins = [*args[:5], *args[5], *args[6:13]]
    outs = [torch.empty_like(t) for t in args[:5]]
    ipm_kernel.launch(lib, ins, outs, args[13], args[14], None)
    return outs


def test_emulated_layout_equals_lane_elements(emulated_lib):
    for N in (2, 6, 20, 40):
        assert emulated_lib.ipm_lane_elements(N) == ipm_kernel.lane_elements(N)


@pytest.mark.parametrize("k", [0, 6])
def test_kernel_source_matches_plain_at_f64_on_cpu(jax_run, emulated_lib, k):
    """From the initial state and after 6 iterations, with one lane at its
    iteration cap and one whose f_ext is NaN (the NaN guard)."""
    Z0, p, states = jax_run
    params, _ = tn.nlp_params_from_numpy(p, Z0, dtype=F64, device="cpu")
    params.f_ext[:, 5] = float("nan")
    args = list(_step_args(_port_state(states[k]), params, 60))
    args[12][3] = float(k)
    got = _emulated(emulated_lib, args)
    ref = ipm_kernel.ipm_iteration_reference(*args)
    assert torch.equal(got[4][1:3], ref[4][1:3])
    assert ref[4][2][5] == 1 and torch.isinf(ref[4][3][5])
    for g, r in zip(got, ref):
        fin = torch.isfinite(r)
        assert torch.equal(g[~fin].nan_to_num(), r[~fin].nan_to_num())
        assert ((g - r).abs()[fin] <= 1e-9 * (1 + r.abs())[fin]).all()


def test_kernel_source_lane_results_do_not_depend_on_their_slot(
        jax_run, emulated_lib):
    """A permutation of the lanes permutes the outputs bit for bit, and 5
    lanes launched alone equal the same lanes of the full launch."""
    Z0, p, states = jax_run
    params, _ = tn.nlp_params_from_numpy(p, Z0, dtype=F64, device="cpu")
    st = _port_state(states[6])
    full = _emulated(emulated_lib, _step_args(st, params, 60))
    B = st[0].shape[-1]
    for idx in (torch.randperm(B, generator=torch.Generator().manual_seed(3)),
                torch.tensor([1, 7, 8, 13, 22])):
        sub_st = tuple(a[..., idx].contiguous() for a in st)
        sub_p = tl._map_params(lambda a: a[..., idx].contiguous(), params)
        got = _emulated(emulated_lib, _step_args(sub_st, sub_p, 60))
        for g, r in zip(got, full):
            assert torch.equal(g, r[..., idx])


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
