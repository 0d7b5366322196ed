"""Port parity: tube/lyapunov.py and ops/tube_kernel.py of the torch port
against the JAX tube functions on 64 tube-regime linearization points (and
a 3-robot horizon) drawn from a seed.  f64: closed_loop_phi, the channel
Gramians, Qd, e^{Phi dt}, the DB square root, the Minkowski sum, the
batched tubes and the tightening within 1e-10 (relative to 1 + |ref|);
f32: Qd within 1e-6 of the JAX f32 XLA path; an explicit gain other than the
config's through both tube entry points and through the kernel source.  The Taylor term counts are
pinned: the port's equal the JAX package's and the ones csrc/tube_stage.cu
is launched with.  The CUDA kernel is held against its plain version on
the card (cuda-marked test, and chip_smoke.py)."""
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
from forces_resilient_planner_tpu_torch.ops import tube_kernel
from forces_resilient_planner_tpu_torch.tube import lyapunov as tl

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
