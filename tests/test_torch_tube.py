"""Port parity: tube/lyapunov.py and ops/tube_kernel.py of the torch port
against the JAX tube functions on 64 tube-regime linearization points (and
a 3-robot horizon) drawn from a seed.  f64: closed_loop_phi, the channel
Gramians, Qd, e^{Phi dt}, the DB square root, the Minkowski sum, the
batched tubes and the tightening within 1e-10 (relative to 1 + |ref|);
f32: Qd within 1e-6 of the JAX f32 XLA path; an explicit gain other than the
config's through both tube entry points and through the kernel source.
The port's oracle functions (lyapunov_solve, lyapunov_gramian, channel_Qd,
sqrtm_psd) within 1e-10 of JAX's; the fast path held against the port's
own oracle, as tests/test_tube.py holds JAX's.  The Taylor term counts are
pinned: the port's equal the JAX package's and the ones csrc/tube_stage.cu
is launched with.  The CUDA kernel is held against its plain version on
the card (cuda-marked test, and chip_smoke.py)."""
import ctypes
import ctypes.util
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cuda_emu
from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.tube import lyapunov as jl
from forces_resilient_planner_tpu_torch.corridor import decomp
from forces_resilient_planner_tpu_torch.ops import tube_kernel
from forces_resilient_planner_tpu_torch.tube import lyapunov as tl
from forces_resilient_planner_tpu_torch.utils import rounding

TOL = 1e-10
T64 = torch.float64


def _close(got, want, tol=TOL):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want) / (1.0 + np.abs(want)))
    assert err <= tol, err


def _points(n=64, seed=21):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.6, (n, 9))
    u = np.array([0, 0, 0, 7.3]) + rng.normal(0, 0.8, (n, 4))
    return x, u


@pytest.fixture(scope="module")
def jax_stage():
    """JAX Phi, channel Gramians, Mp, Qd at f64 on the 64 points."""
    x, u = _points()
    K = jnp.asarray(C.tube.K, jnp.float64)
    w = jnp.full((3,), C.tube.ext_noise_bound)

    @jax.jit
    def f(x, u):
        Phi = jax.vmap(lambda a, b: jl.closed_loop_phi(a, b, K, C.model))(x, u)
        X, Mp = jl.gramian_channels(Phi, C.model.dt, w)
        Qd, Mp2 = jl.channel_Qd_fast(Phi, C.model.dt, w)
        return Phi, X, Mp, Qd, Mp2

    return f(x, u)


def test_term_counts_pinned_to_jax_and_kernel():
    assert tl.taylor_n_terms(torch.float32) == jl.taylor_n_terms(jnp.float32) == 7
    assert tl.taylor_n_terms(T64) == jl.taylor_n_terms(jnp.float64) == 12
    for dtype in (torch.float32, T64):
        assert tube_kernel.N_TERMS[dtype] == tl.taylor_n_terms(dtype)
    src = (Path(tube_kernel.__file__).parent / "csrc" / tube_kernel.SOURCE
           ).read_text()
    inst = dict(re.findall(r"^TUBE_ENTRY\(tube_stage_\w+, (\w+), (\d+)\)",
                           src, re.M))
    assert inst == {"float": "7", "double": "12"}
    assert tl.MAX_DOUBLINGS == 4
    assert re.search(r"MAX_DOUBLINGS = 4;", src)


def test_closed_loop_phi_and_gramians_match_jax(jax_stage):
    Phi_j, X_j, Mp_j, _, _ = jax_stage
    x, u = (torch.as_tensor(a) for a in _points())
    K = torch.as_tensor(C.tube.K, dtype=T64)
    Phi = tl.closed_loop_phi(x, u, K, C.model)
    _close(Phi, Phi_j)
    w = torch.full((3,), C.tube.ext_noise_bound, dtype=T64)
    X, Mp = tl.gramian_channels(Phi, C.model.dt, w)
    _close(X, X_j)
    _close(Mp, Mp_j)


def test_channel_Qd_fast_matches_jax(jax_stage):
    _, _, _, Qd_j, Mp_j = jax_stage
    x, u = (torch.as_tensor(a) for a in _points())
    Qd, Mp, Phi, Q1 = tube_kernel.tube_stage_reference(x, u, C.model, C.tube)
    _close(Qd, Qd_j)
    _close(Mp, Mp_j)


def test_f32_Qd_matches_jax_f32_path():
    x, u = _points()
    K = jnp.asarray(C.tube.K, jnp.float32)
    w = jnp.full((3,), C.tube.ext_noise_bound, jnp.float32)

    @jax.jit
    def f(x, u):
        Phi = jax.vmap(lambda a, b: jl.closed_loop_phi(a, b, K, C.model))(x, u)
        return jl.channel_Qd_fast(Phi, C.model.dt, w)

    Qd_j, Mp_j = f(jnp.asarray(x, jnp.float32), jnp.asarray(u, jnp.float32))
    xt = torch.as_tensor(x, dtype=torch.float32)
    ut = torch.as_tensor(u, dtype=torch.float32)
    Qd, Mp, _, _ = tube_kernel.tube_stage_reference(xt, ut, C.model, C.tube)
    assert Qd.dtype == torch.float32
    assert np.max(np.abs(Qd.numpy() - np.asarray(Qd_j))) <= 1e-6
    assert np.max(np.abs(Mp.numpy() - np.asarray(Mp_j))) <= 2e-6


def test_tube_stage_lanes_routes_cpu_to_plain():
    x, u = (torch.as_tensor(a) for a in _points(16, seed=4))
    launches = tube_kernel.LAUNCHES
    for g, r in zip(tube_kernel.tube_stage_lanes(x, u, C.model, C.tube),
                    tube_kernel.tube_stage_reference(x, u, C.model, C.tube)):
        assert torch.equal(g, r)
    assert tube_kernel.LAUNCHES == launches
    with pytest.raises(ValueError, match="no route"):
        tube_kernel.tube_stage_lanes(x.to("meta"), u.to("meta"), C.model,
                                     C.tube)


def _horizons(B=3, seed=6):
    rng = np.random.default_rng(seed)
    N = C.model.N
    Z = np.zeros((B, N, 17))
    Z[..., 3] = 7.3 + rng.normal(0, 0.5, (B, N))
    Z[..., 0:3] = rng.normal(0, 0.3, (B, N, 3))
    Z[..., 8:11] = rng.normal(0, 1.0, (B, N, 3))
    Z[..., 11:14] = rng.normal(0, 0.8, (B, N, 3))
    Z[..., 14:17] = rng.normal(0, 0.3, (B, N, 3))
    return Z


def _other_gain(seed=12):
    """A feedback gain other than the config's: 1.3 K plus a seeded
    perturbation, (4, 9) float64."""
    rng = np.random.default_rng(seed)
    return 1.3 * np.asarray(C.tube.K) + rng.normal(0, 0.05, (4, 9))


@pytest.fixture(scope="module")
def jax_tubes():
    """JAX tubes of a 3-robot horizon with the config gain (batched, and
    robot 1 alone with K passed) and with _other_gain (both in one call)."""
    Z = _horizons()
    tb = jax.jit(lambda z: jl.propagate_tubes_batch(z, C.model, C.tube))(Z)
    K = jnp.asarray(C.tube.K, jnp.float64)
    t1 = jax.jit(lambda z: jl.propagate_tubes(z, C.model, C.tube, K))(Z[1])
    Kx = jnp.asarray(_other_gain())
    other = jax.jit(lambda z, k: (
        jl.propagate_tubes_batch(z, C.model, C.tube, K=k),
        jl.propagate_tubes(z[1], C.model, C.tube, k)))(Z, Kx)
    return Z, tb, t1, other


@pytest.mark.parametrize("field", ["E", "Q2", "Phi"])
def test_propagate_tubes_batch_matches_jax(jax_tubes, field):
    Z, tb, _, _ = jax_tubes
    got = tl.propagate_tubes_batch(torch.as_tensor(Z), C.model, C.tube)
    _close(getattr(got, field), getattr(tb, field))


def test_propagate_tubes_single_robot_matches_jax(jax_tubes):
    Z, _, t1, _ = jax_tubes
    got = tl.propagate_tubes(torch.as_tensor(Z[1]), C.model, C.tube)
    for field in ("E", "Q2", "Phi"):
        _close(getattr(got, field), getattr(t1, field))


@pytest.mark.parametrize("as_tensor", [True, False])
def test_propagate_tubes_with_an_explicit_gain_match_jax(jax_tubes, as_tensor):
    """A gain other than tcfg.K, given as a tensor or as an array, reaches
    the per-stage math of both entry points: batched and single robot match
    JAX with the same gain, and differ from the config gain's tubes."""
    Z, tb, _, (tb_k, t1_k) = jax_tubes
    K = _other_gain()
    K = torch.as_tensor(K) if as_tensor else K
    Zt = torch.as_tensor(Z)
    got = tl.propagate_tubes_batch(Zt, C.model, C.tube, K=K)
    one = tl.propagate_tubes(Zt[1], C.model, C.tube, K)
    for field in ("E", "Q2", "Phi"):
        _close(getattr(got, field), getattr(tb_k, field))
        _close(getattr(one, field), getattr(t1_k, field))
        assert not np.allclose(getattr(got, field).numpy(),
                               np.asarray(getattr(tb, field)))
    none = tl.propagate_tubes_batch(Zt, C.model, C.tube)
    given = tl.propagate_tubes_batch(Zt, C.model, C.tube, K=C.tube.K)
    for g, r in zip(none, given):
        assert torch.equal(g, r)


def test_sqrtm_minkowski_and_tightening_match_jax():
    rng = np.random.default_rng(17)
    M = rng.normal(0, 0.3, (10, 3, 3))
    Q1 = np.einsum("bij,bkj->bik", M, M) + 1e-3 * np.eye(3)
    M2 = rng.normal(0, 0.1, (10, 3, 3))
    Q2 = np.einsum("bij,bkj->bik", M2, M2) + 1e-4 * np.eye(3)
    A = rng.normal(0, 1, (10, 30, 3))
    A[:, 24:] = 0.0                              # zero padding rows
    b = rng.normal(0, 1, (10, 30))

    @jax.jit
    def f(Q1, Q2, A, b):
        Qm = jl.minkowski_sum(Q1, Q2)
        E = jl.sqrtm_psd_db(Qm)
        return Qm, E, jl.tighten_corridor(A, b, E)

    Qm_j, E_j, bt_j = f(Q1, Q2, A, b)
    t = torch.as_tensor
    Qm = tl.minkowski_sum(t(Q1), t(Q2))
    E = tl.sqrtm_psd_db(Qm)
    _close(Qm, Qm_j)
    _close(E, E_j)
    _close(E @ E, Qm_j, 1e-9)
    bt = tl.tighten_corridor(t(A), t(b), E)
    _close(bt, bt_j)
    assert torch.equal(bt[:, 24:], t(b)[:, 24:])


# ---- the oracle functions ----------------------------------------------------

ORACLES = ("lyapunov_solve", "lyapunov_gramian", "channel_Qd", "sqrtm_psd")


def _oracle_inputs(n=8, seed=5):
    """Tube-regime Phi's points, symmetric right-hand sides, PSD 3x3's."""
    x, u = _points(n, seed)
    rng = np.random.default_rng(seed + 1)
    W = rng.standard_normal((n, 9, 9))
    M = rng.standard_normal((n, 3, 3))
    Q = M @ np.swapaxes(M, -1, -2) + 0.05 * np.eye(3)
    return x, u, W + np.swapaxes(W, -1, -2), Q


@pytest.fixture(scope="module")
def jax_oracle():
    """JAX's Phi and its four oracle functions at f64 (one jitted call)."""
    x, u, W, Q = _oracle_inputs()
    K = jnp.asarray(C.tube.K, jnp.float64)
    w = jnp.full((3,), C.tube.ext_noise_bound)
    dt = C.model.dt

    @jax.jit
    def f(x, u, W, Q):
        Phi = jax.vmap(lambda a, b: jl.closed_loop_phi(a, b, K, C.model))(x, u)
        return Phi, {
            "lyapunov_solve": jax.vmap(jl.lyapunov_solve)(Phi, W),
            "lyapunov_gramian": jax.vmap(
                lambda P, Wi: jl.lyapunov_gramian(P, Wi, dt))(Phi, W),
            "channel_Qd": jax.vmap(lambda P: jl.channel_Qd(P, dt, w))(Phi),
            "sqrtm_psd": jl.sqrtm_psd(Q),
        }

    return f(x, u, W, Q)


def _port_oracle(name, Phi, W, Q):
    w = torch.full((3,), C.tube.ext_noise_bound, dtype=T64)
    if name == "lyapunov_solve":
        return torch.stack([tl.lyapunov_solve(P, Wi) for P, Wi in zip(Phi, W)])
    if name == "lyapunov_gramian":
        return tl.lyapunov_gramian(Phi, W, C.model.dt)
    if name == "channel_Qd":
        return tl.channel_Qd(Phi, C.model.dt, w)
    return tl.sqrtm_psd(Q)


@pytest.mark.parametrize("name", ORACLES)
def test_oracle_functions_match_jax(jax_oracle, name):
    """The port's oracle functions on JAX's Phi within 1e-10 (1 + |ref|):
    torch.linalg.matrix_exp, eigh and solve against the JAX package's
    Pade-13 expm, eigh and LU."""
    Phi_j, ref = jax_oracle
    _, _, W, Q = _oracle_inputs()
    t = torch.as_tensor
    got = _port_oracle(name, t(np.array(Phi_j)), t(W), t(Q))
    _close(got, ref[name])


def test_lyapunov_solve_residual_and_the_gramian_identity():
    """As tests/test_tube.py holds JAX's: the Kronecker solve's residual,
    and the Gramian as the solution of the getDistrEllipsoid problem."""
    x, u, W, _ = _oracle_inputs(4, seed=9)
    K = torch.as_tensor(C.tube.K, dtype=T64)
    Phi = tl.closed_loop_phi(torch.as_tensor(x), torch.as_tensor(u), K,
                             C.model)
    dt = C.model.dt
    for P, Wi in zip(Phi, torch.as_tensor(W)):
        X = tl.lyapunov_solve(P, Wi)
        np.testing.assert_allclose((P @ X + X @ P.T).numpy(), Wi.numpy(),
                                   atol=1e-9)
        G = tl.lyapunov_gramian(P, Wi, dt)
        E = torch.linalg.matrix_exp(-P * dt)
        want = tl.lyapunov_solve(P, Wi - E @ Wi @ E.T)
        _close(G, want.numpy(), 1e-9)


def test_fast_path_matches_the_ports_oracle():
    """The matmul-only Gramian path (channel_Qd_fast, which tube_stage_lanes'
    plain version and K2 compute) against the port's own Van Loan oracle
    (tests/test_tube.py's check of JAX's, on the port)."""
    x, u = _points(10, seed=17)
    K = torch.as_tensor(C.tube.K, dtype=T64)
    Phi = tl.closed_loop_phi(torch.as_tensor(x), torch.as_tensor(u), K,
                             C.model)
    w = torch.full((3,), C.tube.ext_noise_bound, dtype=T64)
    Qd_ref = tl.channel_Qd(Phi, C.model.dt, w)
    Qd, Mp = tl.channel_Qd_fast(Phi, C.model.dt, w)
    assert (Qd - Qd_ref).abs().max().item() < 1e-14
    Mp_ref = torch.linalg.matrix_exp(Phi * C.model.dt)
    assert (Mp - Mp_ref).abs().max().item() < 1e-12
    Qd_k, _, _, _ = tube_kernel.tube_stage_reference(
        torch.as_tensor(x), torch.as_tensor(u), C.model, C.tube)
    assert (Qd_k - Qd_ref).abs().max().item() < 1e-14


def test_sqrtm_db_matches_the_ports_eigh():
    rng = np.random.default_rng(3)
    for _ in range(20):
        A = rng.normal(0, 1.0, (3, 3))
        Q = torch.as_tensor(A @ A.T * 10 ** rng.uniform(-4, 1))
        got = tl.sqrtm_psd_db(Q)
        want = tl.sqrtm_psd(Q)
        scale = 1e-9 + want.abs().max().item()
        assert (got - want).abs().max().item() / scale < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_cuda(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, u = (torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in _points(4096, seed=9))
    launches = tube_kernel.LAUNCHES
    got = tube_kernel.tube_stage_lanes(x, u, C.model, C.tube)
    ref = tube_kernel.tube_stage_reference(x, u, C.model, C.tube)
    torch.cuda.synchronize()
    assert tube_kernel.LAUNCHES == launches + 1
    bounds = ((1e-10,) * 4 if dtype == torch.float64
              else (1e-6, 2e-6, 2e-5, 1e-6))        # Qd, Mp, Phi, Q1
    for g, r, tol in zip(got, ref, bounds):
        if dtype == torch.float64:
            assert ((g - r).abs() <= tol * (1 + r.abs())).all()
        else:
            assert (g - r).abs().max().item() <= tol


def test_operation_count_matches_hand_count():
    """Four lanes Phi = c I with |c dt| = 0.25, 0.75, 100 and NaN: s = 0, 1,
    4 (clamped) and 0 (nan_to_num), so 5 doublings.  7 terms: per lane 2 x
    6 Horner products, 3 x 5 full series products and 3 of H_1's (225),
    the elementwise steps and the fixed parts; per doubling 8 products and
    3 x 81 sums; a product 9 x 17 operations per column."""
    dt = C.model.dt
    c = torch.tensor([0.25, 0.75, 100.0, float("nan")], dtype=T64) / dt
    Phi = c[:, None, None] * torch.eye(9, dtype=T64)
    ops = tube_kernel.tube_stage_operations(Phi, dt, 7)
    product = 9 * 9 * 17
    lane = (57 + 236 + 2 * (6 * product + 7 * 90)
            + 3 * (225 + 5 * product + 7 * 180 + 45) + 758)
    assert lane == tube_kernel.lane_operations(7) == 44080
    assert ops == 4 * lane + 5 * (8 * product + 3 * 81)


# ---- the CUDA source's arithmetic on the CPU (g++ and tests/cuda_emu) -----

@pytest.fixture(scope="module")
def emulated_tube(tmp_path_factory):
    """csrc/tube_stage.cu built with g++ against the host stand-in of the
    CUDA runtime (a thread per CUDA thread, masked warp barriers)."""
    return _cuda_emu.build(tube_kernel.SOURCE, tmp_path_factory.mktemp("emu"),
                           tube_kernel._bind)


def _spread_lanes(L=40, seed=3):
    """Stage lanes whose scaled 1-norm asks for 0 to 4 doublings under a
    gain of 0.2 K, one lane with a NaN state: (x, u, tcfg)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.6, (L, 9))
    u = np.array([0, 0, 0, 7.3]) + rng.normal(0, 0.8, (L, 4))
    scale = np.geomspace(0.05, 100, L)
    u[:, 3] *= scale
    x[:, 3:6] *= scale[:, None]
    x[7, 4] = np.nan
    tcfg = dataclasses.replace(
        C.tube, K=tuple(tuple(0.2 * v for v in row) for row in C.tube.K))
    return torch.as_tensor(x), torch.as_tensor(u), tcfg


def _emulated_tube(lib, x, u, tcfg):
    return tube_kernel.launch(lib, x.contiguous(), u.contiguous(), C.model,
                              tcfg, None)


@pytest.mark.parametrize("dtype", [T64, torch.float32])
def test_kernel_source_matches_plain_on_cpu(emulated_tube, dtype):
    """f64 within 1e-10 (1 + |ref|) on 40 lanes (f64 CTAs of 6: a ragged
    last one) with 0-4 doublings, the NaN lane NaN where the plain one is; f32
    within phase 5's bars (Phi 2e-5, Mp 2e-6, Qd and Q1 1e-6 absolute) on
    40 tube-regime lanes (f32 CTAs of 3: a ragged last one)."""
    if dtype == T64:
        x, u, tcfg = _spread_lanes()
        Phi = tube_kernel.tube_stage_reference(x, u, C.model, tcfg)[2]
        norm1 = (Phi * C.model.dt).abs().sum(dim=-2).amax(dim=-1)
        s = torch.ceil(torch.log2(torch.clamp(norm1 / 0.5, min=1.0)))
        assert set(s.clamp(0, 4).nan_to_num(0.0).tolist()) == {
            0.0, 1.0, 2.0, 3.0, 4.0}
    else:
        x, u = (torch.as_tensor(a, dtype=dtype) for a in _points(40, seed=8))
        tcfg = C.tube
    got = _emulated_tube(emulated_tube, x, u, tcfg)
    ref = tube_kernel.tube_stage_reference(x, u, C.model, tcfg)
    bars = (1e-6, 2e-6, 2e-5, 1e-6)                   # Qd, Mp, Phi, Q1
    for g, r, bar in zip(got, ref, bars):
        assert torch.equal(g.isnan(), r.isnan())
        fin = ~r.isnan()
        d = (g - r).abs()[fin]
        if dtype == T64:
            assert (d <= 1e-10 * (1 + r.abs()[fin])).all(), d.max()
        else:
            assert d.max().item() <= bar, d.max()


def test_kernel_source_honours_an_explicit_gain(emulated_tube):
    """K2's source with a gain other than tcfg.K in its constants, at f64 on
    the main path's kind of stage lanes: within 1e-10 (1 + |ref|) of the
    plain version with the same gain, and unlike the config gain's Phi."""
    x, u = (torch.as_tensor(a) for a in _points(24, seed=5))
    K = torch.as_tensor(_other_gain())
    got = tube_kernel.launch(emulated_tube, x, u, C.model, C.tube, None, K)
    ref = tube_kernel.tube_stage_reference(x, u, C.model, C.tube, K)
    for g, r in zip(got, ref):
        assert ((g - r).abs() <= 1e-10 * (1 + r.abs())).all()
    phi_cfg = tube_kernel.tube_stage_reference(x, u, C.model, C.tube)[2]
    assert (got[2] - phi_cfg).abs().max() > 1e-3


def test_kernel_source_lane_results_do_not_depend_on_their_slot(
        emulated_tube):
    """A permutation of the lanes permutes the outputs bit for bit, and 5
    lanes launched alone equal the same lanes of the full launch."""
    x, u, tcfg = _spread_lanes()
    full = _emulated_tube(emulated_tube, x, u, tcfg)
    for idx in (torch.randperm(40, generator=torch.Generator().manual_seed(3)),
                torch.tensor([1, 7, 12, 25, 39])):
        got = _emulated_tube(emulated_tube, x[idx], u[idx], tcfg)
        for g, r in zip(got, full):
            assert torch.equal(g.nan_to_num(), r[idx].nan_to_num())
            assert torch.equal(g.isnan(), r[idx].isnan())


# ---- the tube chain: the recursion and the roots after K2 ------------------

def test_tube_chain_lanes_routes_cpu_to_plain():
    """On a CPU tensor the chain is its plain version and launches nothing;
    a tensor on no device the route knows raises."""
    B, N = 3, C.model.N
    Qd, Mp, _, Q1 = tube_kernel.tube_stage_reference(
        *(torch.as_tensor(a) for a in _points(B * N, seed=4)), C.model,
        C.tube)
    args = (Qd.reshape(B, N, 9, 9), Mp.reshape(B, N, 9, 9),
            Q1.reshape(B, N, 3, 3), C.tube)
    launches = tube_kernel.CHAIN_LAUNCHES
    for g, r in zip(tube_kernel.tube_chain_lanes(*args),
                    tube_kernel.tube_chain_reference(*args)):
        assert torch.equal(g, r)
    assert tube_kernel.CHAIN_LAUNCHES == launches
    with pytest.raises(ValueError, match="no route"):
        tube_kernel.tube_chain_lanes(*(a.to("meta") for a in args[:3]),
                                     C.tube)


def test_chain_operation_count_matches_hand_count():
    """Per stage: the 9x9 Minkowski sum 16 + 2 + 3 + 81 x 3, W = Mp[0:3] Qu
    27 x 17, Q2 9 x 17; per root the regularisation 7, 12 Denman-Beavers
    steps (two det3 of 14, g 2, gY and gZ 18, two inv3 of 41, Y and Z 36)
    and the symmetrisation 18; per combination 4 + 5 + 27.  3 robots of 5
    stages: 5 stages, 5 roots and 4 combinations each."""
    stage = (16 + 2 + 3 + 81 * 3) + 27 * 17 + 9 * 17
    root = 7 + 12 * (2 * 14 + 2 + 18 + 2 * 41 + 36) + 18
    assert (stage, root) == (876, 2017)
    assert tube_kernel.tube_chain_operations(3, 5) == 3 * (
        5 * (stage + root) + 4 * (4 + 5 + 27)) == 43827


@pytest.fixture(scope="module")
def emulated_chain(tmp_path_factory):
    """csrc/tube_chain.cu built with g++ against the host stand-in of the
    CUDA runtime."""
    return _cuda_emu.build(tube_kernel.CHAIN_SOURCE,
                           tmp_path_factory.mktemp("emu_chain"),
                           tube_kernel._bind_chain)


def _chain_inputs(B, N, dtype=T64, seed=6):
    """K2's plain outputs on B robots' horizons (_horizons), cut to their
    first N stages: (Qd, Mp (B, N, 9, 9), Q1 (B, N, 3, 3)) at dtype."""
    Z = torch.as_tensor(_horizons(B, seed)[:, :N], dtype=dtype)
    x = Z[..., 8:17].reshape(B * N, 9).contiguous()
    u = Z[..., 0:4].reshape(B * N, 4).contiguous()
    Qd, Mp, _, Q1 = tube_kernel.tube_stage_reference(x, u, C.model, C.tube)
    return (Qd.reshape(B, N, 9, 9), Mp.reshape(B, N, 9, 9),
            Q1.reshape(B, N, 3, 3))


def _emulated_chain(lib, Qd, Mp, Q1):
    return tube_kernel.launch_chain(lib, Qd.contiguous(), Mp.contiguous(),
                                    Q1.contiguous(), C.tube, None)


@pytest.mark.parametrize("N", [1, 5, 20])
@pytest.mark.parametrize("dtype", [T64, torch.float32])
def test_chain_source_matches_plain_on_cpu(emulated_chain, dtype, N):
    """7 robots (CTAs of 3: a ragged last one) of N stages: E and Q2 within
    1e-10 (1 + |ref|) at f64 and 1e-6 absolute at f32 of the plain chain."""
    args = _chain_inputs(7, N, dtype)
    got = _emulated_chain(emulated_chain, *args)
    ref = tube_kernel.tube_chain_reference(*args, C.tube)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (7, N, 3, 3) and g.dtype == dtype
        assert torch.isfinite(r).all()
        d = (g - r).abs()
        if dtype == T64:
            assert (d <= 1e-10 * (1 + r.abs())).all(), d.max()
        else:
            assert d.max().item() <= 1e-6, d.max()


def test_chain_source_propagates_a_nan_stage_as_plain(emulated_chain):
    """A NaN in robot 2's Qd at stage 7: NaN in its Q2 from stage 7 and its
    E from stage 8 on, as in the plain chain, and nowhere else; the other
    robots' outputs within 1e-10 (1 + |ref|)."""
    Qd, Mp, Q1 = _chain_inputs(5, C.model.N)
    Qd = Qd.clone()
    Qd[2, 7, 4, 4] = float("nan")
    got = _emulated_chain(emulated_chain, Qd, Mp, Q1)
    ref = tube_kernel.tube_chain_reference(Qd, Mp, Q1, C.tube)
    for g, r, first in zip(got, ref, (8, 7)):
        want = torch.zeros_like(r, dtype=torch.bool)
        want[2, first:] = True
        assert torch.equal(r.isnan(), want)
        assert torch.equal(g.isnan(), want)
        fin = ~want
        assert ((g - r).abs()[fin] <= 1e-10 * (1 + r.abs()[fin])).all()


def test_chain_source_robot_results_do_not_depend_on_their_slot(
        emulated_chain):
    """A permutation of the robots permutes the outputs bit for bit, and 3
    robots launched alone equal the same robots of the full launch."""
    args = _chain_inputs(8, C.model.N, seed=9)
    full = _emulated_chain(emulated_chain, *args)
    for idx in (torch.randperm(8, generator=torch.Generator().manual_seed(4)),
                torch.tensor([1, 4, 7])):
        got = _emulated_chain(emulated_chain, *(a[idx] for a in args))
        for g, r in zip(got, full):
            assert torch.equal(g, r[idx])


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.powf.argtypes, _LIBM.powf.restype = [ctypes.c_float] * 2, ctypes.c_float
_LIBM.pow.argtypes, _LIBM.pow.restype = [ctypes.c_double] * 2, ctypes.c_double


def _sum9(x):
    """A 9-term diagonal's sum as torch's reduction adds it on the card."""
    return ((((x[..., 0] + x[..., 8]) + x[..., 4]) + (x[..., 2] + x[..., 6]))
            + ((x[..., 1] + x[..., 5]) + (x[..., 3] + x[..., 7])))


def _sum3(x):
    return (x[..., 0] + x[..., 2]) + x[..., 1]


def _fma_chain(a, b, k0, k1):
    acc = a[..., k0] * b[..., k0]
    for k in range(k0 + 1, k1):
        acc = rounding.fma(a[..., k], b[..., k], acc)
    return acc


def _card_order_chain(Qd, Mp, Q1, eps2):
    """The plain chain with its sums in the order its library calls take on
    the H100 at B = 4096 and B = 1 (csrc/tube_chain.cu's header), every
    other operation rounded on its own; sqrt correctly rounded and pow
    libm's, as the source's CPU build calls them."""
    dt = Q1.dtype
    f32 = dt == torch.float32
    B, N = Q1.shape[0], Q1.shape[1]
    powf = _LIBM.powf if f32 else _LIBM.pow

    def mink(P, Q, tr):
        beta = rounding.sqrt(tr(P.diagonal(dim1=-2, dim2=-1))
                             / tr(Q.diagonal(dim1=-2, dim2=-1)))
        beta = beta[..., None, None]
        return (1.0 + 1.0 / beta) * P + (1.0 + beta) * Q

    Q_init = (eps2 * torch.eye(9, dtype=dt)).expand(B, 9, 9)
    Q2 = []
    for i in range(N):
        Qu = mink(Q_init, Qd[:, i], _sum9)
        A = Mp[:, i, 0:3]                                  # (B, 3, 9)
        a, q = A[:, :, None, :], Qu.transpose(-1, -2)[:, None]
        W = (_fma_chain(a, q, 0, 5) + _fma_chain(a, q, 5, 9) if f32
             else _fma_chain(a, q, 0, 9))                  # (B, 3, 9)
        w, m = W[:, :, None, :], A[:, None, :, :]
        if f32:
            acc = w[..., 0] * m[..., 0]
            for k in range(1, 9):
                acc = acc + w[..., k] * m[..., k]
        else:
            acc = _fma_chain(w, m, 0, 9)
        Q2.append(acc)
        Q_init = Qu
    Q2 = torch.stack(Q2, dim=1)
    Q = torch.cat([Q1[:, 0:1], mink(Q1[:, 1:], Q2[:, :-1], _sum3)], dim=1)
    eye = torch.eye(3, dtype=dt)
    tr = _sum3(Q.diagonal(dim1=-2, dim2=-1))[..., None, None]
    Y = Q + (1e-12 * tr + 1e-30) * eye
    Z = eye.expand(Q.shape)
    for _ in range(12):
        x = torch.abs(decomp.det3(Y) * decomp.det3(Z))
        g = torch.tensor([powf(v, -1.0 / 6.0) for v in x.reshape(-1).tolist()],
                         dtype=dt).reshape(x.shape)
        g = torch.nan_to_num(g, nan=1.0, posinf=1.0, neginf=1.0)[..., None,
                                                                  None]
        Yn = 0.5 * (g * Y + decomp.inv3(g * Z))
        Z = 0.5 * (g * Z + decomp.inv3(g * Y))
        Y = Yn
    return 0.5 * (Y + Y.transpose(-1, -2)), Q2


@pytest.mark.parametrize("dtype", [T64, torch.float32])
def test_chain_source_sums_in_the_cards_plain_order(emulated_chain, dtype):
    """The source equals, bit for bit, the plain chain with its traces and
    products summed in the order torch and cuBLAS take on the card (what
    makes the kernel equal the plain chain there), 5 robots of 20 stages."""
    args = _chain_inputs(5, C.model.N, dtype, seed=3)
    got = _emulated_chain(emulated_chain, *args)
    want = _card_order_chain(*args, C.tube.epsilon ** 2)
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        assert torch.equal(g, w), (g - w).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chain_kernel_matches_plain_on_cuda(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    B, N = 4096, C.model.N
    x, u = (torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in _points(B * N, seed=9))
    Qd, Mp, _, Q1 = tube_kernel.tube_stage_lanes(x, u, C.model, C.tube)
    args = (Qd.reshape(B, N, 9, 9), Mp.reshape(B, N, 9, 9),
            Q1.reshape(B, N, 3, 3), C.tube)
    launches = tube_kernel.CHAIN_LAUNCHES
    got = tube_kernel.tube_chain_lanes(*args)
    ref = tube_kernel.tube_chain_reference(*args)
    torch.cuda.synchronize()
    assert tube_kernel.CHAIN_LAUNCHES == launches + 1
    for g, r in zip(got, ref):
        assert torch.equal(g.isnan(), r.isnan())
        fin = ~r.isnan()
        d = (g - r).abs()[fin]
        if dtype == torch.float64:
            assert (d <= 1e-10 * (1 + r.abs()[fin])).all(), d.max()
        else:
            assert d.max().item() <= 1e-6, d.max()
