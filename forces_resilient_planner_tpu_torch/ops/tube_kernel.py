"""The tube stage's CUDA kernels and their plain PyTorch versions.

Counterpart of forces_resilient_planner_tpu/ops/tube_pallas.py.  The
kernel K2 (csrc/tube_stage.cu) replaces the Pallas TPU kernel
`_tube_kernel` (tube_pallas.py:65): per stage lane it forms Phi = Jc + Bc
K, the three disturbance-channel Gramians and e^{Phi dt} by the scaled
Taylor series and doublings, the trace-normalized Qd and the ego ellipsoid
Q1.  The tube chain (csrc/tube_chain.cu) takes K2's outputs and does the
rest of the tube stage per robot in one launch: the Minkowski stage
recursion, the combination with Q1 and the Denman-Beavers square roots.

Route by device: on a CPU tensor `tube_stage_lanes` runs
`tube_stage_reference` and `tube_chain_lanes` runs `tube_chain_reference`
(the formulas of tube/lyapunov.py); on a CUDA tensor each launches its
kernel or raises.  Unlike the JAX package there is no batch-size gate: one
lane on the card runs the kernels too.
"""
from __future__ import annotations

import ctypes

import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, TubeConfig
from forces_resilient_planner_tpu_torch.ops import _build
from forces_resilient_planner_tpu_torch.tube import lyapunov

SOURCE = "tube_stage.cu"
CHAIN_SOURCE = "tube_chain.cu"
NX = 9

# kernel launches, over all calls in this process: K2, the tube chain
LAUNCHES = 0
CHAIN_LAUNCHES = 0

# the Taylor length each instantiation is launched with (= the plain
# path's lyapunov.taylor_n_terms; csrc/tube_stage.cu's TUBE_ENTRY lines)
N_TERMS = {torch.float32: 7, torch.float64: 12}

_ENTRY = {torch.float32: ("tube_stage_f32", ctypes.c_float),
          torch.float64: ("tube_stage_f64", ctypes.c_double)}


def _consts_struct(ctype):
    class TubeConsts(ctypes.Structure):
        # layout of TubeConsts<T> in csrc/tube_stage.cu
        _fields_ = [(name, ctype) for name in (
            "mass", "drag", "dt", "noise", "ego_r2", "ego_h2")] + [
            ("K", ctype * 36)]
    return TubeConsts


_STRUCTS = {dt: _consts_struct(ct) for dt, (_, ct) in _ENTRY.items()}

_CHAIN_ENTRY = {torch.float32: ("tube_chain_f32", ctypes.c_float),
                torch.float64: ("tube_chain_f64", ctypes.c_double)}


def _bind(lib):
    for name, ctype in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.tube_geometry.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.tube_geometry.restype = None


def _bind_chain(lib):
    for name, ctype in _CHAIN_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctype]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def launch_geometry(lib, dtype):
    """(stage lanes, threads, bytes of shared memory) per CTA of the
    kernel in `lib` at dtype: a team of 9 threads per stage lane."""
    lanes, threads = ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_size_t()
    lib.tube_geometry(torch.empty((), dtype=dtype).element_size(),
                      ctypes.byref(lanes), ctypes.byref(threads),
                      ctypes.byref(smem))
    return lanes.value, threads.value, smem.value


def _gain(tcfg: TubeConfig, K):
    """The feedback gain as a (4, 9) float64 CPU tensor: K as given, or the
    config gain tcfg.K when K is None."""
    Kt = torch.as_tensor(tcfg.K if K is None else K,
                         dtype=torch.float64).detach().cpu()
    if tuple(Kt.shape) != (4, NX):
        raise ValueError(f"K: shape {tuple(Kt.shape)}, expected (4, 9)")
    return Kt


def launch(lib, x, u, mcfg: ModelConfig, tcfg: TubeConfig, stream, K=None):
    """One launch of the kernel in `lib` (the nvcc build, or the CPU build
    of the tests) on checked, contiguous x (L, 9), u (L, 4) with the gain K
    (None: tcfg.K) in the kernel's constants; returns (Qd, Mp, Phi, Q1),
    allocated like x.  Raises when the launch fails."""
    L = x.shape[0]
    entry, ctype = _ENTRY[x.dtype]
    Kt = _gain(tcfg, K)
    consts = _STRUCTS[x.dtype](
        mass=mcfg.mass, drag=mcfg.drag_coeff, dt=mcfg.dt,
        noise=tcfg.ext_noise_bound, ego_r2=tcfg.ego_r ** 2,
        ego_h2=tcfg.ego_h ** 2, K=(ctype * 36)(*Kt.reshape(-1).tolist()),
    )
    outs = [x.new_empty((L, NX, NX)) for _ in range(3)] + [x.new_empty((L, 3, 3))]
    rc = getattr(lib, entry)(
        ctypes.addressof(consts), L, N_TERMS[x.dtype], x.data_ptr(),
        u.data_ptr(), *(t.data_ptr() for t in outs), stream,
    )
    _build.check(rc, "tube_stage")
    return tuple(outs)


def tube_stage_reference(x: torch.Tensor, u: torch.Tensor, mcfg: ModelConfig,
                         tcfg: TubeConfig, K=None):
    """Plain PyTorch version: the per-stage branch of propagate_tubes_batch
    with the gain K (None: the config gain tcfg.K).
    x (L, 9), u (L, 4) -> (Qd, Mp, Phi (L, 9, 9), Q1 (L, 3, 3))."""
    Kt = torch.as_tensor(tcfg.K if K is None else K, dtype=x.dtype,
                         device=x.device)
    w = torch.full((3,), tcfg.ext_noise_bound, dtype=x.dtype, device=x.device)
    Phi = lyapunov.closed_loop_phi(x, u, Kt, mcfg)
    Qd, Mp = lyapunov.channel_Qd_fast(Phi, mcfg.dt, w)
    return Qd, Mp, Phi, lyapunov.ego_ellipsoid(x[:, 6:9], tcfg)


# Operations of one lane, counted as corridor_kernel.OPS_PER counts them
# (the fewest that give the plain version's result bit for bit; a
# multiply-add counts 2), from the formulas of tube/lyapunov.py, which
# csrc/tube_stage.cu follows.  A full 9x9 product costs 9 mul + 8 add per
# entry, 1377.
PRODUCT = 81 * 17
# per doubling: 8 products (3 channels' M X and (M X) M^T, M_-^2, M_+^2)
# and the 3 channels' X += (M X) M^T
DOUBLING_OPS = 8 * PRODUCT + 3 * 81


def lane_operations(n_terms: int) -> int:
    """Operations of one lane before its doublings:
      Phi = Jc + Bc K: rows 3-5 (3 divisions, 27 products, 27 sums; rows
        0-2 and 6-8 are copies; the Jacobian blocks of Jc not counted)  57
      the scaling: |Phi dt|'s column sums (81 mul, 72 add), log2, ceil,
        Pu = (Phi dt) 2^-s (81)                                          236
      each of the 2 Horner chains, n_terms steps: the product with Pu
        (none in the first: the factor is I), 81 products with 1/m and
        9 sums with +-I                                 (n-1) 1377 + 90 n
      each of the 3 channel series, n_terms steps: the product Pu H (none
        for H_0 = e_c e_c^T, 225 for H_1, nonzero in one row and column
        only, then 1377); H = -(W + W^T)/m and X += H/(m+1) on the 45
        entries of a symmetric matrix (180); then X dt 2^-s (45)
                                                 225 + (n-2) 1377 + 180 n + 45
      the combine: X dt w^2 (243), the traces (24 add, 3 sqrt), their
        sum (2), Qd (81 x 3 divisions, 2 add, 1 mul)                    758
    The ego ellipsoid Q1 is not counted either: a lower bound."""
    n = n_terms
    horner = (n - 1) * PRODUCT + 90 * n
    series = 225 + (n - 2) * PRODUCT + 180 * n + 45
    return 57 + 236 + 2 * horner + 3 * series + 758


def tube_stage_operations(Phi: torch.Tensor, dt: float, n_terms: int) -> int:
    """Operations that the tube math of these lanes needs: lane_operations
    per lane and DOUBLING_OPS per doubling, each lane its own s from the
    1-norm of Phi dt.  A counting helper for the kernel's bound
    (chip_smoke.py); the main path never calls it."""
    norm1 = (Phi * dt).abs().sum(dim=-2).amax(dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm1 / 0.5, min=1.0)))
    s = torch.nan_to_num(s, nan=0.0).clamp(0, lyapunov.MAX_DOUBLINGS)
    return (lane_operations(n_terms) * Phi.shape[0]
            + DOUBLING_OPS * int(s.sum().item()))


# Operations of the tube chain, counted as above from the formulas of
# tube/lyapunov.py that csrc/tube_chain.cu follows (a division, a square
# root and a power count 1, a negation and an absolute value 0):
#   the 9x9 Minkowski sum: the traces (16 add), beta = sqrt(t1 / t2) (2),
#     1 + 1/beta and 1 + beta (3), 81 entries of 2 mul and 1 add        264
#   W = Mp[0:3] Qu (27 entries of 9 mul and 8 add) and Q2 = W Mp[0:3]^T
#     (9 entries)                                               459 + 153
STAGE_OPS = 264 + 459 + 153
#   the combination's 3x3 Minkowski sum (the traces 4, beta and its
#     factors 5, 9 entries of 3)                                          36
COMBINE_OPS = 36
#   det3: 3 cofactors of 3, 3 mul and 2 add                               14
#   inv3: det3's 14, the other 6 cofactors (18), 9 divisions              41
#   a Denman-Beavers step: two det3, g (a product, a power), gY and gZ
#     (18), two inv3, Y and Z (9 entries of an add and a mul, twice)    166
#   the root: the regularisation (the trace 2, 1e-12 tr + 1e-30 2, the
#     diagonal 3), 12 steps, the symmetrisation (9 add, 9 mul)          2017
ROOT_OPS = 7 + 12 * (2 * 14 + 2 + 18 + 2 * 41 + 36) + 18


def tube_chain_operations(B: int, N: int) -> int:
    """Operations that the tube chain of B robots of N stages needs: per
    robot, N recursion stages and roots and N - 1 combinations.  A counting
    helper for the kernel's bound (k23_probe.py); the main path never calls
    it."""
    return B * (N * (STAGE_OPS + ROOT_OPS) + (N - 1) * COMBINE_OPS)


def tube_stage_lanes(x: torch.Tensor, u: torch.Tensor, mcfg: ModelConfig,
                     tcfg: TubeConfig, K=None):
    """Per-stage tube math over L stage lanes with the gain K (a (4, 9)
    tensor or array; None: the config gain tcfg.K).
    Returns (Qd (L, 9, 9), Mp (L, 9, 9), Phi (L, 9, 9), Q1 (L, 3, 3))."""
    global LAUNCHES
    if x.device.type == "cpu":
        return tube_stage_reference(x, u, mcfg, tcfg, K)
    L = x.shape[0]
    if L == 0:
        raise ValueError("need L >= 1 stage lanes")
    lib = _build.route(SOURCE, _bind, [("x", x, (L, NX)), ("u", u, (L, 4))])
    outs = _build.on_stream(x.device, launch, lib, x, u, mcfg, tcfg, K=K)
    LAUNCHES += 1
    return outs


def launch_chain(lib, Qd, Mp, Q1, tcfg: TubeConfig, stream):
    """One launch of the tube chain in `lib` (the nvcc build, or the CPU
    build of the tests) on checked, contiguous Qd, Mp (B, N, 9, 9) and Q1
    (B, N, 3, 3); returns (E, Q2 (B, N, 3, 3)), allocated like Q1.  Raises
    when the launch fails."""
    B, N = Q1.shape[0], Q1.shape[1]
    entry, ctype = _CHAIN_ENTRY[Q1.dtype]
    E, Q2 = Q1.new_empty((B, N, 3, 3)), Q1.new_empty((B, N, 3, 3))
    rc = getattr(lib, entry)(
        B, N, ctype(tcfg.epsilon ** 2), Qd.data_ptr(), Mp.data_ptr(),
        Q1.data_ptr(), E.data_ptr(), Q2.data_ptr(), stream,
    )
    _build.check(rc, "tube_chain")
    return E, Q2


def tube_chain_reference(Qd: torch.Tensor, Mp: torch.Tensor,
                         Q1: torch.Tensor, tcfg: TubeConfig):
    """Plain PyTorch version: the stage recursion of propagate_tubes_batch
    (setFORCESParams, nmpc_solver.cpp:490-520), the combination with the
    ego ellipsoids and the Denman-Beavers roots.
    Qd, Mp (B, N, 9, 9), Q1 (B, N, 3, 3) -> (E, Q2 (B, N, 3, 3))."""
    B, N = Q1.shape[0], Q1.shape[1]
    Q_init = ((tcfg.epsilon ** 2)
              * torch.eye(NX, dtype=Q1.dtype, device=Q1.device)
              ).expand(B, NX, NX)
    Q2 = []
    for i in range(N):
        Qu = lyapunov.minkowski_sum(Q_init, Qd[:, i])
        Q2.append((Mp[:, i] @ Qu @ Mp[:, i].transpose(-1, -2))[:, 0:3, 0:3])
        Q_init = Qu
    Q2pos = torch.stack(Q2, dim=1)                               # (B, N, 3, 3)

    Qcomb = torch.cat(
        [Q1[:, 0:1], lyapunov.minkowski_sum(Q1[:, 1:], Q2pos[:, :-1])], dim=1
    )
    return lyapunov.sqrtm_psd_db(Qcomb), Q2pos


def tube_chain_lanes(Qd: torch.Tensor, Mp: torch.Tensor, Q1: torch.Tensor,
                     tcfg: TubeConfig):
    """The tube stage after K2 for B robots of N stages: Qd, Mp (B, N, 9, 9)
    and Q1 (B, N, 3, 3) as K2 gives them -> (E, Q2 (B, N, 3, 3))."""
    global CHAIN_LAUNCHES
    if Q1.device.type == "cpu":
        return tube_chain_reference(Qd, Mp, Q1, tcfg)
    B, N = Q1.shape[0], Q1.shape[1]
    if B == 0 or N == 0:
        raise ValueError("need B >= 1 robots and N >= 1 stages")
    lib = _build.route(CHAIN_SOURCE, _bind_chain, [
        ("Qd", Qd, (B, N, NX, NX)), ("Mp", Mp, (B, N, NX, NX)),
        ("Q1", Q1, (B, N, 3, 3))])
    out = _build.on_stream(Q1.device, launch_chain, lib, Qd, Mp, Q1, tcfg)
    CHAIN_LAUNCHES += 1
    return out
