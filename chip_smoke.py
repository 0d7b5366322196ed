"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width and holds every hand-written
CUDA kernel against its plain PyTorch version on the card:

  slice 1, the bench headline: a 256 goals x 16 forces x 1 box = 4096-
  scenario grid at N = 20 solved by engine/batch.py::solve_scenario_grid
  with the bench tier schedule, every monotone IPM iteration launched as
  ops/csrc/ipm_iteration.cu (K1);
  slice 2, the batched full NMPC step: engine/pipeline_batch.py::
  nmpc_step_batched at DEFAULT_CONFIG on 4096 robots (N = 20, K = 64 path
  samples, M = 256 obstacles, each robot its own cloud, force, time offset
  and profile), with the tube kernel ops/csrc/tube_stage.cu (K2), the
  corridor kernel ops/csrc/corridor.cu (K3) and K1;
  slice 3, the Mehrotra predictor-corrector (SolverConfig.
  predictor_corrector=True) on the grid and the step, every iteration one
  Riccati factor K4a and two backsolves K4b of ops/csrc/lqr.cu, and the
  batched LQR solve solver/riccati.py::solve_lqr_batched through K5a and
  K5b of the same source.

Phases, one line each (any failure exits non-zero and nothing after it is
printed):

  0. device: needs torch.cuda; prints the card's name and power limit
  1. build: compiles the four kernel sources with nvcc, all at once;
     prints build seconds and the ptxas register / spill report of each
     entry function, K1's lanes and shared memory per CTA, K2's stage lanes,
     threads and shared memory per CTA (a team of 9 threads per lane) and
     K3's lanes per stage, threads and shared memory per CTA at M = 256,
     1024 and 2048
  2. K1 vs its plain PyTorch version on the card at B = 4096, one
     iteration from the initial state and one after 8 plain iterations:
     f64 |d| <= 1e-9 (1 + |ref|) with identical it/done; f32 from the
     initial state |d| <= 1e-3 (1 + |ref|) on the lanes whose done flag
     agrees; f32 in mid-solve the kernel's error against the f64 step from
     the same state within 1.25x the plain f32 step's (+1e-3); f32 done
     flags agreeing on >= 99.9% of lanes; K1 on a permutation of the
     lanes and on the 256 lanes a tier would take, launched alone, bit for
     bit equal to the same lanes of the full launch
  3. slice 1 main path at f32: solved fraction >= 0.999; K1 launches equal
     to the host-loop iterations stepped (> 0), no K4; the first 64 lanes
     re-solved by the plain path at f64 on the CPU within 1e-3 in u (at
     most one of the card's solved lanes missing); the grid solved through
     the plain versions on the card: solved fraction within 0.005, exit
     codes agreeing on >= 99.5% of lanes
  4. K1 times: ms per iteration (CUDA events) at B = 4096, 1024, 256 and
     1, each beside its bound from bytes and operations and the share of
     it; the plain version at 4096; grid-solve ms per call and solves/s
     over 5 fresh seed sets, mean iterations
  5. K2 vs its plain version at L = B N = 81,920 stage lanes, on random
     tube-regime lanes and on the main path's own stage lanes: f64
     |d| <= 1e-10 (1 + |ref|); f32 max |d| Phi <= 2e-5, Mp <= 2e-6,
     Qd <= 1e-6, Q1 <= 1e-6
  6. K3 vs its plain version: f64, A and b within 1e-9 on every row, on
     generic random inputs at B = 256, M = 256 and at B = 64, M = 2048, and
     on the main path's own segments and clouds (B = 4096, M = 256); f32
     at the main path's inputs, the share of (robot, stage) whose rows
     match within 1e-4 (printed, not barred: argmin ties flip planes at f32)
  7. slice 2 main path at f32, on the easy workload and on one where every
     4th robot has drifted from its plan: K2 and K3 launched once each, K1
     once per host-loop step; every output finite on the accepted robots;
     the f64 certificate on the CPU (no obstacle inside any tightened
     polytope, accepted trajectories within 1e-4 of their corridors, the
     card's NLP of robots 0-63 re-solved by the plain solver at f64 within
     1e-3 in u); the step through the plain versions on the card, its
     exit-code agreement printed and its solved fraction within 0.005
  8. slice 2 times: K2 and K3 ms per call against their plain versions,
     each beside its bound and the share of it (K3's bound from the work
     this run's data needs: ops/corridor_kernel.py::decompose_stages_work);
     K3 at M = CorridorConfig.max_obstacles (2048), its geometry there;
     nmpc_step_batched ms per call and steps/s over 5 pre-staged fresh
     input sets of each workload; engine/pipeline.py::nmpc_step at B = 1,
     p50 / p99 over 30 calls, in the engine/workloads.py::small_cfg
     configuration (reduced caps) and in DEFAULT_CONFIG
  9. K4 vs its plain version on the predictor-corrector grid's own calls
     (B = 4096, nh = 30), from the initial IPM state and after 8 plain
     iterations: f64 |d| <= 1e-9 (1 + |ref|) on every factor and backsolve
     output; f32 held against the plain version at f64, the kernel's error
     within 1.25x the plain f32 one's (+1e-3); K4 at f64 with nh = 18 on
     256 lanes; K5 on random well-conditioned blocks at B = 4096, N = 20:
     f64 within 1e-9 (1 + |ref|), f32 within 1e-4 (1 + |ref|), the f64
     kernel solution's KKT residuals within 1e-8; solve_lqr_batched
     launching K5a and K5b once each
  10. slice 3 main path at f32: the predictor-corrector grid with phase
     3's checks, except that K4a launches = host-loop steps, K4b = twice
     that, no K1, and the solved fraction is printed, not barred; then
     nmpc_step_batched with the
     predictor-corrector on phase 7's two workloads with phase 7's checks
     and the same launch and agreement bars
  11. slice 3 times: K4a, K4b, K5a and K5b ms per call against their plain
     versions at B = 4096; the predictor-corrector grid's ms per call,
     solves/s and mean iterations beside phase 4's monotone ones; the
     predictor-corrector step's ms per call and steps/s; nmpc_step at B = 1
     in DEFAULT_CONFIG with the predictor-corrector, p50 / p99 over 30 calls

The {"kernels"} line's bound_ms is the larger of the bytes the kernel must
move (inputs read once, outputs written once) over the H100's 3.35 TB/s
and its operations over 67 TFLOP/s (f32, no tensor cores), computed from
this run's inputs (K2: the doublings its lanes take; K3: the sets of the
rounds that run on its data); library_ms is null for all seven kernels (no single
PyTorch call computes any of them).  max_abs_err is, for every kernel, the
f32 kernel against its plain version on the main path's inputs at the
main path's shape (K1: the grid's initial IPM state; K2: the step's stage lanes; K3:
the step's segments and clouds; K4: the predictor-corrector grid's initial
calls; K5: the random blocks of phase 9).

Then the script's total seconds, a {"kernels": [...]} JSON line, the card's
name and power limit, and last {"ok": true, "device": ...}.  Imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu_torch.engine import (
    batch,
    pipeline,
    pipeline_batch,
    reference,
    workloads,
)
from forces_resilient_planner_tpu_torch.ops import (
    _build,
    corridor_kernel,
    ipm_kernel,
    lqr_kernel,
    tube_kernel,
)
from forces_resilient_planner_tpu_torch.solver import ipm_lanes, nlp, riccati
from forces_resilient_planner_tpu_torch.solver.problems import hover_warm_start
from forces_resilient_planner_tpu_torch.tube import lyapunov

CSRC = "forces_resilient_planner_tpu_torch/ops/csrc/"
KERNEL_SOURCE = CSRC + "ipm_iteration.cu"
KERNEL_REPLACES = "forces_resilient_planner_tpu/ops/ipm_pallas.py:218"
LQR_PALLAS = "forces_resilient_planner_tpu/ops/lqr_pallas.py:"
# the Riccati kernels of ops/csrc/lqr.cu (ops/lqr_kernel.py's LAUNCHES
# keys): their label and the Pallas kernel body each replaces
LQR_KERNELS = {
    "lqr_factor_fused": ("K4a", LQR_PALLAS + "269"),
    "lqr_backsolve_fused": ("K4b", LQR_PALLAS + "316"),
    "lqr_factor": ("K5a", LQR_PALLAS + "100"),
    "lqr_backsolve": ("K5b", LQR_PALLAS + "132"),
}
MAX_ITERS = 60.0
KEYS = pipeline_batch.PIPELINE_ARG_KEYS
STEP_B, STEP_K, STEP_M = 4096, 64, 256
LQR_B, LQR_N = 4096, 20


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def bench_lanes(cfg, seed, dtype, device):
    """The bench grid of `seed`, lane-major, with its initial IPM state."""
    goals, forces = workloads.bench_seeds(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    x0 = np.zeros(9)
    x0[2] = 1.2
    weights = nlp.make_stage_weights(
        cfg.weights, cfg.model.N, dtype=dtype, device=device
    )
    scen = batch._expand_scenarios_device(
        cfg, t(x0), t(goals), t(forces), t(workloads.HALVES), weights
    )
    params = ipm_lanes.lanes_params(scen.params)
    Z0 = scen.Z0.movedim(0, -1).contiguous()
    st = ipm_lanes._init_state(Z0, params, cfg.model, cfg.solver)
    Z, lam, s, mu_d, mu, it, done, err = st
    scal = torch.stack([mu, it.to(dtype), done.to(dtype), err])
    return [Z, lam, s, mu_d, scal], params


def iter_args(state, params, cfg):
    B = state[0].shape[-1]
    mi = torch.full((B,), MAX_ITERS, dtype=state[0].dtype,
                    device=state[0].device)
    return (*state, params.weights, params.ref_pos, params.ref_yaw,
            params.corridor_A, params.corridor_b, params.f_ext, params.xinit,
            mi, cfg.model, cfg.solver)


def max_rel(x, y, mask):
    """max |x - y| / (1 + |y|) over the lanes in mask."""
    return ((x - y).abs() / (1.0 + y.abs()))[..., mask].max().item()


def to_f64(state, params):
    def conv(a):
        return a.double()
    return ([conv(a) for a in state],
            ipm_lanes._map_params(conv, params))


def compare_step(state, params, cfg, rel_tol, done_frac, against_f64):
    """One kernel iteration against one plain iteration on the same inputs.

    against_f64=False: |kernel - plain| <= rel_tol (1 + |plain|) on every
    element of the lanes whose done flag agrees.  against_f64=True (f32 in
    mid-solve, where two plain f32 runs of the same code on two devices
    already differ by more than 1e-3): both are held against the f64 step
    from the same state, and the kernel's max relative error must be within
    1.25x the plain f32 step's, plus rel_tol.
    Returns (max rel kernel-vs-plain, max abs kernel-vs-plain, done share).
    """
    args = iter_args(state, params, cfg)
    ref = ipm_kernel.ipm_iteration_reference(*args)
    got = ipm_kernel.ipm_iteration_fused(*args)
    truth = None
    if against_f64:
        truth = ipm_kernel.ipm_iteration_reference(
            *iter_args(*to_f64(state, params), cfg))
    torch.cuda.synchronize()
    done_agree = (ref[4][2] == got[4][2])
    frac = done_agree.double().mean().item()
    if not torch.equal(ref[4][1], got[4][1]):
        fail("kernel and plain iteration counts differ")
    if frac < done_frac:
        fail(f"done flags agree on {frac:.6f} of lanes < {done_frac}")
    rel_all, abs_all = 0.0, 0.0
    for i, name in enumerate(("Z", "lam", "s", "mu_d")):
        r, g = ref[i], got[i]
        if not torch.isfinite(g).all():
            fail(f"{name}: non-finite kernel output")
        rel = max_rel(g, r, done_agree)
        rel_all = max(rel_all, rel)
        abs_all = max(abs_all, (g - r).abs()[..., done_agree].max().item())
        if truth is None:
            if rel > rel_tol:
                fail(f"{name}: max rel deviation {rel:.3e} > {rel_tol}")
            continue
        e_ker = max_rel(g.double(), truth[i], done_agree)
        e_plain = max_rel(r.double(), truth[i], done_agree)
        say(f"  {name}: max rel error vs the f64 step: kernel {e_ker:.3e}, "
            f"plain f32 {e_plain:.3e}; kernel vs plain {rel:.3e}")
        if e_ker > 1.25 * e_plain + rel_tol:
            fail(f"{name}: kernel error vs f64 {e_ker:.3e} > 1.25 x plain "
                 f"{e_plain:.3e} + {rel_tol}")
    return rel_all, abs_all, frac


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM published peaks: HBM3 bytes/s, and FLOP/s outside the
# tensor cores (the kernels use none)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
NXB, NU = 13, 4
NTRI = NXB * (NXB + 1) // 2


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in objs (tuples and named tuples walked)."""
    total = 0
    for o in objs:
        if torch.is_tensor(o):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
    return total


def bound(nbytes, flops, dtype=torch.float32):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth
    and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def riccati_factor_flops(N, nh=0):
    """Per lane, multiply-add = 2: each gap stage's Abar^T P, Bbar^T P,
    their products with Abar and Bbar, Sh^T K over P's upper triangle, and
    with nh corridor rows the 3x3 corridor block of the stage QP."""
    macs = (2 * NXB ** 3 + 2 * NU * NXB * NXB + NU * NU * NXB
            + 2 * NU * NTRI + 9 * nh)
    return 2 * (N - 1) * macs


def riccati_solve_flops(N):
    """Per lane: P c, Abar^T Pc, Bbar^T Pc, K^T quh (backsolve); K dx, Abar
    dx, Bbar du (rollout); P dx (costates), per gap stage."""
    macs = 3 * NXB * NXB + 2 * NU * NXB + NXB * NU + NU * NXB
    return 2 * (N - 1) * macs


def k1_flops(N):
    """One K1 iteration per lane: the factor (with the corridor block) and
    the solve, the Jacobian products Ax, Bx per gap stage; per stage the
    corridor products of the stationarity and the RHS, J_eq^T lam, and ~12
    operations for each of the 64 rows in the three row passes (ratios,
    NaN guard, update)."""
    dyn = 2 * (81 * 9 + 36 * 9)
    stage = 2 * (2 * 3 * 30 + 13 * 9 + NXB * NXB) + 64 * 12 * 3
    return (riccati_factor_flops(N, 30) + riccati_solve_flops(N)
            + (N - 1) * dyn + N * stage)


def corridor_flops(args, ccfg):
    """K3 per call from this run's data: the bbox filter of every stage's
    cloud, then each executed shrink and peel round's set times the
    operations of one evaluation, plus each round's scalar chain
    (ops/corridor_kernel.py::decompose_stages_work).  Returns (operations,
    the counts)."""
    work = corridor_kernel.decompose_stages_work(*args, ccfg)
    return corridor_kernel.work_operations(work), work


# ---------------------------------------------------------------------------
# slice 2: the batched full NMPC step
# ---------------------------------------------------------------------------

def step_inputs(seed, B, dtype, device, K=STEP_K, M=STEP_M, cfg=DEFAULT_CONFIG,
                drift=False):
    """The bench's full-step workload (bench.py:277-296,
    __graft_entry__._example_inputs) with per-robot variety drawn from
    `seed`: each robot its own obstacle cloud from the same distribution,
    f_ext in [-1, 1]^3, t_offset in [0, 0.3], every 8th robot on the final
    profile, its deque perturbed by 1e-4.  drift=True: every 4th robot has
    drifted from its last plan, its whole deque shifted by N(0, 0.3) m in
    position and N(0, 1) m/s in velocity (more iterations; some robots end
    at max_iters, the NaN guard or no progress)."""
    rng = np.random.default_rng(seed)
    N = cfg.model.N
    x0 = np.zeros(9)
    x0[2] = 1.2
    Z = hover_warm_start(torch.as_tensor(x0), cfg.model).numpy()
    out = np.concatenate([Z, Z[-1:]], axis=0)
    t = np.arange(K) * cfg.model.dt
    path = np.stack([1.2 * t, 0.3 * t, np.full(K, 1.2)], -1)
    obs = rng.uniform([-1, -3, 0], [5, 3, 2.5], (B, M, 3))
    obs = np.where(np.abs(obs[..., 1:2]) < 0.8, obs + np.array([0, 2.0, 0]),
                   obs)
    out = out[None] + rng.normal(0, 1e-4, (B, N + 1, 17))
    if drift:
        moved = np.arange(B) % 4 == 1
        d = np.random.default_rng(seed + 77)
        out[moved, :, 8:11] += d.normal(0, 0.3, (moved.sum(), 1, 3))
        out[moved, :, 11:14] += d.normal(0, 1.0, (moved.sum(), 1, 3))
    args = dict(
        mpc_output=out,
        kino_path=np.broadcast_to(path, (B, K, 3)),
        kino_size=np.full(B, K),
        t_offset=rng.uniform(0.0, 0.3, B),
        state_mpc=np.broadcast_to(x0, (B, 9)),
        f_ext=rng.uniform(-1.0, 1.0, (B, 3)),
        end_pt=np.broadcast_to(path[-1], (B, 3)),
        obstacles=obs,
        obstacle_mask=np.ones((B, M), bool),
        use_final=np.arange(B) % 8 == 7,
    )
    return pipeline_batch.pipeline_inputs_from_numpy(args, dtype=dtype,
                                                     device=device)


def step(inputs, cfg=DEFAULT_CONFIG):
    return pipeline_batch.nmpc_step_batched(*[inputs[k] for k in KEYS],
                                            cfg=cfg)


@contextlib.contextmanager
def plain_routes():
    """Every kernel wrapper replaced by its plain PyTorch version."""
    with contextlib.ExitStack() as stack:
        for module, name, plain in (
            (tube_kernel, "tube_stage_lanes", tube_kernel.tube_stage_reference),
            (corridor_kernel, "decompose_stages_lanes",
             corridor_kernel.decompose_stages_reference),
            (ipm_kernel, "ipm_iteration_fused",
             ipm_kernel.ipm_iteration_reference),
            (lqr_kernel, "lqr_factor_fused_lanes",
             lqr_kernel.lqr_factor_fused_reference),
            (lqr_kernel, "lqr_backsolve_fused_lanes",
             lqr_kernel.lqr_backsolve_fused_reference),
        ):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def tube_check(x, u, device):
    """K2 vs plain on the stage lanes x (L, 9), u (L, 4) (numpy) at f64 and
    f32.  Returns the f32 max |d| over outputs and a report."""
    cfg = DEFAULT_CONFIG
    f32_bounds = {"Qd": 1e-6, "Mp": 2e-6, "Phi": 2e-5, "Q1": 1e-6}
    worst32, msg = 0.0, []
    for dtype in (torch.float64, torch.float32):
        xt = torch.as_tensor(x, dtype=dtype, device=device)
        ut = torch.as_tensor(u, dtype=dtype, device=device)
        ref = tube_kernel.tube_stage_reference(xt, ut, cfg.model, cfg.tube)
        got = tube_kernel.tube_stage_lanes(xt, ut, cfg.model, cfg.tube)
        torch.cuda.synchronize()
        for name, g, r in zip(f32_bounds, got, ref):
            if not torch.isfinite(g).all():
                fail(f"K2 {name} {dtype}: non-finite kernel output")
            d = (g - r).abs()
            if dtype == torch.float64:
                rel = (d / (1 + r.abs())).max().item()
                if rel > 1e-10:
                    fail(f"K2 {name} f64: max rel {rel:.3e} > 1e-10")
                msg.append(f"{name} f64 rel {rel:.2e}")
            else:
                err = d.max().item()
                if err > f32_bounds[name]:
                    fail(f"K2 {name} f32: max abs {err:.3e} > "
                         f"{f32_bounds[name]}")
                worst32 = max(worst32, err)
                msg.append(f"{name} f32 abs {err:.2e}")
    return worst32, "; ".join(msg)


def random_segments(B, N, M, seed):
    """Generic random stage segments and clouds (the inputs of
    tools/kernel_parity_debug.py:86-93)."""
    rng = np.random.default_rng(seed)
    p1 = rng.uniform([-1, -1, 0.8], [1, 1, 1.6], (B, N, 3))
    yaw = rng.uniform(-np.pi, np.pi, (B, N))
    p2 = p1 + 0.1 * np.stack([np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)],
                             -1)
    obs = rng.uniform([-3, -3, -0.5], [3, 3, 3], (B, M, 3))
    mask = rng.uniform(size=(B, M)) < 0.9
    return p1, p2, obs, mask


def corridor_rows(args, device):
    """K3 and its plain version on the same inputs: per-(robot, stage) max
    |dA|, |db| over the rows."""
    ccfg, nh = DEFAULT_CONFIG.corridor, DEFAULT_CONFIG.model.nh
    Ag, bg = corridor_kernel.decompose_stages_lanes(*args, ccfg, nh)
    Ar, br = corridor_kernel.decompose_stages_reference(*args, ccfg, nh)
    torch.cuda.synchronize()
    if not (torch.isfinite(Ag).all() and torch.isfinite(bg).all()):
        fail("K3: non-finite kernel output")
    return (Ag - Ar).abs().amax(dim=(-1, -2)), (bg - br).abs().amax(dim=-1)


def certificate(res, inputs, cfg, lanes=64, chunk=128):
    """The f64 audit of tools/tpu_parity_check.py:438-530 in torch on the
    CPU: obstacle penetration into the tightened polytopes, the accepted
    trajectories' corridor violation, and the card's NLP of the first
    `lanes` robots re-solved by the port's plain solver at f64."""
    N = cfg.model.N
    A = res.corridor_A.double().cpu()
    bt = res.corridor_b_tight.double().cpu()
    obs = inputs["obstacles"].double().cpu()
    mask = inputs["obstacle_mask"].cpu()
    ec = res.exit_code.cpu()
    out = res.mpc_output.double().cpu()
    act = A.norm(dim=-1) > 1e-9
    max_pen, n_pen = 0.0, 0
    for i in range(0, A.shape[0], chunk):
        sl = slice(i, i + chunk)
        s = torch.einsum("bnkj,bmj->bnmk", A[sl], obs[sl]) - bt[sl, :, None]
        s = torch.where(act[sl, :, None], s, -torch.inf)
        depth = torch.where(mask[sl, None], -s.amax(dim=-1), -torch.inf)
        pen = depth.clamp(min=0.0)
        max_pen = max(max_pen, pen.max().item())
        n_pen += int((pen.amax(dim=-1) > 0).sum())
    solved = ec == 1
    pos = out[:, :N, 8:11]
    viol = torch.einsum("bnkj,bnj->bnk", A, pos) - bt
    viol = torch.where(act, viol, -torch.inf)[solved]
    max_viol = viol.max().item() if solved.any() else float("-inf")

    sl = slice(0, lanes)
    inp = {k: v[sl].cpu() for k, v in inputs.items()}
    prev = inp["mpc_output"].double()
    ref64 = type(res.ref)(*(t[sl].double().cpu() for t in res.ref))
    params = pipeline_batch.pack_nlp_params(
        ref64, A[sl], bt[sl], inp["f_ext"].double(), prev, inp["use_final"],
        cfg)
    r64 = ipm_lanes.solve_batch_lanes_tiered(
        prev[:, 1:N + 1], params, cfg.model, cfg.solver)
    both = (r64.exit_code == 1) & solved[sl]
    du = (r64.Z[:, :, 0:4] - out[sl, :N, 0:4]).abs().amax(dim=(1, 2))
    du_max = du[both].max().item() if both.any() else float("inf")
    return max_pen, n_pen, max_viol, int(both.sum()), du_max


def stage_segments(inputs, cfg):
    """The corridor kernel's inputs on the main path: every stage's
    reference point, its second seed point, and the robot's cloud."""
    ref = reference.sample_references(
        inputs["kino_path"], inputs["kino_size"], inputs["t_offset"],
        inputs["mpc_output"][:, 1, 16], inputs["mpc_output"][:, 1, 8:11],
        N=cfg.model.N, Ts=cfg.model.dt)
    return (ref.ref_pos.contiguous(),
            pipeline.corridor_seed2(ref, cfg).contiguous(),
            inputs["obstacles"], inputs["obstacle_mask"])


def corridor_f64(args, device, label):
    """K3 vs plain at f64: A and b within 1e-9 on every row."""
    dA, db = corridor_rows(args, device)
    worst = max(dA.max().item(), db.max().item())
    if worst > 1e-9:
        fail(f"K3 f64 {label}: max row |d| {worst:.3e} > 1e-9 on "
             f"{int(((dA > 1e-9) | (db > 1e-9)).sum())} (robot, stage)")
    say(f"phase 6 K3 vs plain f64, {label}: max |dA| {dA.max().item():.2e}, "
        f"max |db| {db.max().item():.2e} (bar 1e-9 on every row)")


def reset_counts():
    """Every kernel's launch count and the host-loop step count to 0."""
    torch.cuda.synchronize()
    tube_kernel.LAUNCHES = corridor_kernel.LAUNCHES = 0
    ipm_kernel.LAUNCHES = 0
    for name in lqr_kernel.LAUNCHES:
        lqr_kernel.LAUNCHES[name] = 0
    ipm_lanes.STEPS = 0


def launch_counts():
    """(K1, K2, K3, K4a, K4b) launches."""
    return (ipm_kernel.LAUNCHES, tube_kernel.LAUNCHES,
            corridor_kernel.LAUNCHES, lqr_kernel.LAUNCHES["lqr_factor_fused"],
            lqr_kernel.LAUNCHES["lqr_backsolve_fused"])


def solver_launches_ok(counts, steps, scfg) -> bool:
    """Monotone with 30 corridor rows: one K1 per host-loop step and no K4;
    predictor-corrector: one K4a and two K4b per step and no K1."""
    l1, l4a, l4b = counts[0], counts[3], counts[4]
    if scfg.predictor_corrector:
        return l1 == 0 and l4a == steps > 0 and l4b == 2 * steps
    return l1 == steps > 0 and l4a == l4b == 0


def check_grid(dev, cfg, phase, solved_min=None):
    """Phase 3 (phase 10 with the predictor-corrector): the bench grid of
    seed 1 solved at f32 through the kernels, its launch counts (one K1 per
    host-loop step, or one K4a and two K4b), finite Z and finite accepted
    outputs, the solved fraction (>= solved_min when given, else printed),
    lanes 0-63 re-solved at f64 on the CPU (at most one of the card's
    solved lanes missing, u within 1e-3), and the same solve through the
    plain versions on the card: solved fraction within 0.005, exit codes
    agreeing on >= 99.5% of lanes.  Returns the launch counts (K1, K2, K3,
    K4a, K4b)."""
    goals, forces = workloads.bench_seeds(1)
    reset_counts()
    res = batch.solve_scenario_grid(cfg, goals, forces, workloads.HALVES,
                                    dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    counts, steps = launch_counts(), ipm_lanes.STEPS
    if "jax" in sys.modules:
        fail("jax was imported")
    if not solver_launches_ok(counts, steps, cfg.solver):
        fail(f"grid launches K1 {counts[0]}, K4a {counts[3]}, K4b {counts[4]} "
             f"vs host-loop steps {steps}")
    ec = res.exit_code.cpu()
    acc = ec == 1
    B = ec.numel()
    if B != workloads.N_GOALS * workloads.N_FORCES * len(workloads.HALVES):
        fail(f"grid has {B} lanes")
    if not torch.isfinite(res.Z).all():
        fail("non-finite Z")
    for name in ("lam", "s", "mu_d", "kkt_error"):
        if not torch.isfinite(getattr(res, name)[acc.to(dev)]).all():
            fail(f"non-finite {name} on accepted lanes")
    solved = acc.double().mean().item()
    if solved_min is not None and solved < solved_min:
        fail(f"solved fraction {solved:.6f} < {solved_min}")

    ref64 = batch.solve_scenario_grid(cfg, goals[:4], forces, workloads.HALVES,
                                      dtype=torch.float64, device="cpu")
    both = (ref64.exit_code == 1) & acc[:64]
    du = (res.Z[:64, :, 0:4].double().cpu() - ref64.Z[:, :, 0:4]).abs()
    du_max = du[both].max().item() if both.any() else float("inf")
    if both.sum() < acc[:64].sum() - 1 or du_max > 1e-3:
        fail(f"f64 CPU re-solve: {int(both.sum())} lanes solved by both of "
             f"{int(acc[:64].sum())}, max |du| {du_max:.3e} (bar 1e-3)")

    with plain_routes():
        plain = batch.solve_scenario_grid(cfg, goals, forces, workloads.HALVES,
                                          dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    if launch_counts() != counts:
        fail("the plain grid solve launched a kernel")
    ec_p = plain.exit_code.cpu()
    solved_p = (ec_p == 1).double().mean().item()
    agree = (ec_p == ec).double().mean().item()
    codes = {int(c): int((ec == c).sum()) for c in ec.unique()}
    label = ("main path" if not cfg.solver.predictor_corrector else
             "predictor-corrector grid")
    say(f"phase {phase} {label} B={B} f32: solved {solved:.6f}"
        f"{' (not barred)' if solved_min is None else ''}, exit codes "
        f"{codes}, launches K1 {counts[0]} K4a {counts[3]} K4b {counts[4]}, "
        f"host-loop steps {steps}, mean iters "
        f"{res.iters.double().mean().item():.3f}, max iters "
        f"{int(res.iters.max())}; f64 CPU re-solve of lanes 0-63: max |du| "
        f"{du_max:.3e} over {int(both.sum())} lanes; plain versions on the "
        f"card: solved {solved_p:.6f}, exit codes agree on {agree:.6f}")
    if abs(solved - solved_p) > 0.005:
        fail(f"grid solved {solved:.6f} vs plain {solved_p:.6f}")
    if agree < 0.995:
        fail(f"grid exit codes agree on {agree:.6f} < 0.995 of lanes")
    return counts


def check_step(inputs, dev, label, cfg=DEFAULT_CONFIG, phase=7,
               agree_min=None):
    """Phase 7 (phase 10 with the predictor-corrector) on one input set: the
    step through the kernels with its launch counts, finiteness, the f64
    audit, and the same step through the plain versions on the card, its
    solved fraction within 0.005 and, when agree_min is given, its exit
    codes agreeing on at least that share of robots.  Returns the launch
    counts (K1, K2, K3, K4a, K4b)."""
    B = inputs["mpc_output"].shape[0]
    reset_counts()
    res = step(inputs, cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    l1, l2, l3, l4a, l4b = counts
    steps = ipm_lanes.STEPS
    if "jax" in sys.modules:
        fail("jax was imported")
    if not (l2 == 1 and l3 == 1 and solver_launches_ok(counts, steps,
                                                       cfg.solver)):
        fail(f"launches: K2 {l2}, K3 {l3} (want 1 each), K1 {l1}, K4a {l4a}, "
             f"K4b {l4b} vs host-loop steps {steps}")
    ec = res.exit_code.cpu()
    acc = ec == 1
    solved = acc.double().mean().item()
    if not torch.isfinite(res.mpc_output).all():
        fail("non-finite mpc_output")
    for name in ("corridor_A", "corridor_b", "corridor_b_tight", "tube_E",
                 "kkt_error"):
        if not torch.isfinite(getattr(res, name)[acc.to(dev)]).all():
            fail(f"non-finite {name} on accepted robots")
    if not all(torch.isfinite(t).all() for t in res.ref):
        fail("non-finite references")
    pen, n_pen, viol, n_both, du = certificate(res, inputs, cfg)
    solved64 = int(acc[:64].sum())
    codes = {int(c): int((ec == c).sum()) for c in ec.unique()}
    say(f"phase {phase} main path nmpc_step_batched B={B} f32{label}: solved "
        f"{solved:.6f}, exit codes {codes}, launches K2 {l2} K3 {l3} K1 {l1} "
        f"K4a {l4a} K4b {l4b}, host-loop steps {steps}, mean iters "
        f"{res.iters.double().mean().item():.3f}; f64 audit: max "
        f"obstacle penetration {pen} m ({n_pen} stages), max accepted "
        f"corridor violation {viol:.3e}, re-solve of robots 0-63 max |du| "
        f"{du:.3e} over {n_both} robots (card solved {solved64})")
    if pen != 0.0:
        fail(f"obstacle penetration {pen} m into a tightened corridor")
    if viol > 1e-4:
        fail(f"accepted trajectories violate their corridors by {viol:.3e}")
    if n_both < 0.95 * solved64 or du > 1e-3:
        fail(f"f64 re-solve: {n_both} robots solved by both of {solved64}, "
             f"max |du| {du:.3e} (bar 1e-3)")

    with plain_routes():
        plain = step(inputs, cfg)
    torch.cuda.synchronize()
    if launch_counts() != counts:
        fail("the plain step launched a kernel")
    ec_p = plain.exit_code.cpu()
    solved_p = (ec_p == 1).double().mean().item()
    agree = (ec_p == ec).double().mean().item()
    say(f"phase {phase} plain versions on the card{label}: solved "
        f"{solved_p:.6f} (kernel path {solved:.6f}), exit codes agree on "
        f"{agree:.6f} of robots")
    if abs(solved - solved_p) > 0.005:
        fail(f"solved fraction {solved:.6f} vs plain {solved_p:.6f}")
    if agree_min is not None and agree < agree_min:
        fail(f"exit codes agree on {agree:.6f} < {agree_min} of robots")
    return counts


def one_robot_latency(cfg, label, M, dev, card, calls=30, phase=8):
    """engine/pipeline.py::nmpc_step (B = 1) p50 / p99 over `calls` calls,
    each with a fresh 1e-3 perturbation of the state and force."""
    f32 = torch.float32
    one = step_inputs(7, 1, f32, dev, M=M, cfg=cfg)
    one = {k: v[0] for k, v in one.items()}
    rng = np.random.default_rng(0)

    def single(a):
        return pipeline.nmpc_step(*[a[k] for k in KEYS], cfg=cfg)

    single(one)
    torch.cuda.synchronize()
    lat, ec = [], []
    for _ in range(calls):
        a = dict(one)
        a["state_mpc"] = one["state_mpc"] + torch.as_tensor(
            rng.normal(0, 1e-3, 9), dtype=f32, device=dev)
        a["f_ext"] = one["f_ext"] + torch.as_tensor(
            rng.normal(0, 1e-3, 3), dtype=f32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = single(a)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        ec.append(int(r.exit_code))
    lat = 1e3 * np.asarray(lat)
    say(f"phase {phase} nmpc_step B=1 {label} M={M} f32 [{card}]: p50 "
        f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} "
        f"ms over {calls} calls, solved {np.mean(np.asarray(ec) == 1):.3f}")


def run_slice2(dev, card):
    """Phases 5-8; returns the {"kernels"} entries of K2 and K3."""
    cfg = DEFAULT_CONFIG
    N, B = cfg.model.N, STEP_B
    f32 = torch.float32

    inputs = step_inputs(1, B, f32, dev)
    in64 = step_inputs(1, B, torch.float64, dev)

    # ---- phase 5: K2 vs plain at L = B N ----------------------------------
    rng = np.random.default_rng(9)
    x = rng.normal(0, 0.4, (B * N, 9))
    u = np.array([0, 0, 0, 7.3]) + rng.normal(0, 0.5, (B * N, 4))
    _, msg = tube_check(x, u, dev)
    say(f"phase 5 K2 vs plain L={B * N}, random tube-regime lanes: {msg}")
    Z = in64["mpc_output"][:, :N].reshape(B * N, 17).cpu().numpy()
    err2, msg = tube_check(Z[:, 8:17], Z[:, 0:4], dev)
    say(f"phase 5 K2 vs plain L={B * N}, the main path's stage lanes: {msg}")

    # ---- phase 6: K3 vs plain ---------------------------------------------
    for Bc, M in ((256, 256), (64, 2048)):
        p1, p2, obs, mask = random_segments(Bc, N, M, 31)
        args = [torch.as_tensor(a, dtype=torch.float64, device=dev)
                for a in (p1, p2, obs)] + [torch.as_tensor(mask, device=dev)]
        corridor_f64(args, dev, f"generic B={Bc} N={N} M={M}")
    corridor_f64(stage_segments(in64, cfg), dev,
                 f"the main path's B={B} N={N} M={STEP_M}")
    args3 = stage_segments(inputs, cfg)
    dA, db = corridor_rows(args3, dev)
    err3 = max(dA.max().item(), db.max().item())
    share = ((dA <= 1e-4) & (db <= 1e-4)).double().mean().item()
    say(f"phase 6 K3 vs plain f32 B={B} N={N} M={STEP_M}: rows within 1e-4 "
        f"on {share:.6f} of (robot, stage); max |dA| {dA.max().item():.2e}, "
        f"max |db| {db.max().item():.2e} (f32 argmin ties; not barred)")
    del in64

    # ---- phase 7: the slice-2 main path -----------------------------------
    _, l2, l3, _, _ = check_step(inputs, dev, "")
    check_step(step_inputs(2, B, f32, dev, drift=True), dev,
               ", every 4th robot drifted")

    # ---- phase 8: times ---------------------------------------------------
    Z = inputs["mpc_output"][:, :N]
    x = Z[..., 8:17].reshape(B * N, 9).contiguous()
    u = Z[..., 0:4].reshape(B * N, 4).contiguous()
    targs = (x, u, cfg.model, cfg.tube)
    ms2 = cuda_ms(lambda: tube_kernel.tube_stage_lanes(*targs), 10)
    ms2p = cuda_ms(lambda: tube_kernel.tube_stage_reference(*targs), 3)
    cargs = (*args3, cfg.corridor, cfg.model.nh)
    ms3 = cuda_ms(lambda: corridor_kernel.decompose_stages_lanes(*cargs), 5)
    ms3p = cuda_ms(lambda: corridor_kernel.decompose_stages_reference(*cargs),
                   2)
    Phi = tube_kernel.tube_stage_reference(*targs)[2]
    ops2 = tube_kernel.tube_stage_operations(Phi, cfg.model.dt,
                                             lyapunov.taylor_n_terms(f32))
    b2 = bound(tensor_bytes(x, u, tube_kernel.tube_stage_reference(*targs)),
               ops2)
    ops3, work3 = corridor_flops(args3, cfg.corridor)
    b3 = bound(tensor_bytes(args3, corridor_kernel.decompose_stages_reference(
        *cargs)), ops3)
    say(f"phase 8 kernels f32 [{card}]: K2 {ms2:.3f} ms vs plain {ms2p:.3f} "
        f"ms at L={B * N}, bound {b2[0]:.4f} ms by {b2[1]} "
        f"({1e-9 * ops2:.3f} GFLOP), {100 * b2[0] / ms2:.2f}% of the bound; "
        f"K3 {ms3:.3f} ms vs plain {ms3p:.3f} ms at B={B} N={N} M={STEP_M}, "
        f"bound {b3[0]:.4f} ms by {b3[1]} ({1e-9 * ops3:.4f} GFLOP of work "
        f"{work3}), {100 * b3[0] / ms3:.2f}% of the bound")
    # K3 at the configuration's own obstacle buffer (CorridorConfig.
    # max_obstacles), where its groups widen
    Mx = cfg.corridor.max_obstacles
    big = stage_segments(step_inputs(1, B, f32, dev, M=Mx), cfg)
    lib3 = _build.load(corridor_kernel.SOURCE, corridor_kernel._bind)
    msx = cuda_ms(lambda: corridor_kernel.decompose_stages_lanes(
        *big, cfg.corridor, cfg.model.nh), 5)
    lanes, threads, smem = corridor_kernel.launch_geometry(lib3, N, Mx, f32)
    say(f"phase 8 K3 f32 [{card}] at B={B} N={N} M={Mx}: {msx:.3f} ms "
        f"({lanes} lanes per stage, {threads} threads, {smem} B of shared "
        "memory per CTA)")
    del big

    for drift, label in ((False, ""), (True, ", every 4th robot drifted")):
        step_times(cfg, dev, drift, label, card, 8)

    small = workloads.small_cfg()
    one_robot_latency(small, "small_cfg (reduced caps)",
                      small.corridor.max_obstacles, dev, card)
    one_robot_latency(cfg, "DEFAULT_CONFIG", STEP_M, dev, card)

    return [
        {"name": "tube_stage", "route": "cuda", "source": CSRC + "tube_stage.cu",
         "replaces": "forces_resilient_planner_tpu/ops/tube_pallas.py:65",
         "launches": l2, "max_abs_err": err2, "ms": ms2, "plain_ms": ms2p,
         "bound_ms": b2[0], "bound_by": b2[1], "library_ms": None},
        {"name": "corridor", "route": "cuda", "source": CSRC + "corridor.cu",
         "replaces": "forces_resilient_planner_tpu/ops/corridor_pallas.py:98",
         "launches": l3, "max_abs_err": err3, "ms": ms3, "plain_ms": ms3p,
         "bound_ms": b3[0], "bound_by": b3[1], "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# slice 3: the Mehrotra predictor-corrector and the Riccati kernels
# ---------------------------------------------------------------------------

def with_pc(cfg):
    """cfg with the Mehrotra predictor-corrector on."""
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, predictor_corrector=True))


def lane_state(state):
    """bench_lanes' packed state as lane_step's (Z, lam, s, mu_d, mu, it,
    done, err)."""
    Z, lam, s, mu_d, scal = state
    return (Z, lam, s, mu_d, scal[0], scal[1].to(torch.int32),
            scal[2] > 0.5, scal[3])


def record_k4(st, params, cfg):
    """One plain lane_step from st with the K4 wrappers' arguments recorded.
    Returns the factor's arguments and the list of each backsolve's
    arguments (against the plain factor)."""
    calls = []

    def recorded(plain):
        def wrapper(*args):
            calls.append(args)
            return plain(*args)
        return wrapper

    with mock.patch.object(
            lqr_kernel, "lqr_factor_fused_lanes",
            recorded(lqr_kernel.lqr_factor_fused_reference)), \
        mock.patch.object(
            lqr_kernel, "lqr_backsolve_fused_lanes",
            recorded(lqr_kernel.lqr_backsolve_fused_reference)):
        ipm_lanes.lane_step(st, params, cfg.model, cfg.solver, int(MAX_ITERS))
    return calls[0], calls[1:]


def as_f64(args):
    """args with every tensor (and every field of a factor) in float64."""
    return tuple(
        riccati.LQRFactor(*(t.double() for t in a))
        if isinstance(a, riccati.LQRFactor)
        else a.double() if torch.is_tensor(a) else a
        for a in args)


def rel_dev(x, y):
    """max |x - y| / (1 + |y|)"""
    return ((x - y).abs() / (1.0 + y.abs())).max().item()


def k4_jobs(fac_args, solve_args):
    """(label, kernel wrapper, plain version, args) of K4a and each K4b."""
    return [("K4a", lqr_kernel.lqr_factor_fused_lanes,
             lqr_kernel.lqr_factor_fused_reference, fac_args)] + [
        (f"K4b rhs {i + 1}", lqr_kernel.lqr_backsolve_fused_lanes,
         lqr_kernel.lqr_backsolve_fused_reference, args)
        for i, args in enumerate(solve_args)]


def hold_kernels(jobs, rel_tol, against_f64):
    """Each job's kernel against its plain version on the same arguments.

    against_f64=False: every output within rel_tol (1 + |plain|).
    against_f64=True (f32 inputs): both held against the plain version at
    f64 on the same values; per output the kernel's max relative error must
    be within 1.25x the plain f32 one's, plus rel_tol.
    Returns {label: max |kernel - plain|} and a report."""
    worst, report = {}, []
    for label, kernel, plain, args in jobs:
        got = kernel(*args)
        ref = plain(*args)
        truth = plain(*as_f64(args)) if against_f64 else None
        torch.cuda.synchronize()
        worst[label], rel_all, e_k_all, e_p_all = 0.0, 0.0, 0.0, 0.0
        for name, g, r in zip(got._fields, got, ref):
            if not torch.isfinite(g).all():
                fail(f"{label} {name}: non-finite kernel output")
            worst[label] = max(worst[label], (g - r).abs().max().item())
            rel = rel_dev(g, r)
            rel_all = max(rel_all, rel)
            if truth is None:
                if rel > rel_tol:
                    fail(f"{label} {name}: max rel {rel:.3e} > {rel_tol}")
                continue
            t = getattr(truth, name)
            e_k, e_p = rel_dev(g.double(), t), rel_dev(r.double(), t)
            e_k_all, e_p_all = max(e_k_all, e_k), max(e_p_all, e_p)
            if e_k > 1.25 * e_p + rel_tol:
                fail(f"{label} {name}: kernel error vs f64 {e_k:.3e} > 1.25 x "
                     f"plain {e_p:.3e} + {rel_tol}")
        report.append(
            f"{label} max rel {rel_all:.2e}" if truth is None else
            f"{label} vs f64: kernel {e_k_all:.2e}, plain {e_p_all:.2e}")
    return worst, "; ".join(report)


def check_k4(dev, cfg_pc):
    """Phase 9, K4: the PC grid's own K4 calls (bench grid of seed 1, B =
    4096) from the initial IPM state and after 8 plain PC iterations, at f64
    and f32; then nh = 18 at f64 on 256 lanes.  Returns the f32 max
    |kernel - plain| of K4a and K4b from the initial state and the f32
    initial-state arguments (for the times)."""
    errs, f32_args = {}, None
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        rel_tol = 1e-9 if f64 else 1e-3
        bar = (f"{rel_tol:g} (1+|ref|)" if f64 else
               f"1.25x the plain f32 error vs f64 + {rel_tol:g}")
        state, params = bench_lanes(cfg_pc, 1, dtype, dev)
        st = lane_state(state)
        B = st[0].shape[-1]
        fa, sa = record_k4(st, params, cfg_pc)
        w0, rep0 = hold_kernels(k4_jobs(fa, sa), rel_tol, not f64)
        for _ in range(8):
            st = ipm_lanes.lane_step(st, params, cfg_pc.model, cfg_pc.solver,
                                     int(MAX_ITERS), plain=True)
        w8, rep8 = hold_kernels(k4_jobs(*record_k4(st, params, cfg_pc)),
                                rel_tol, not f64)
        say(f"phase 9 K4 vs plain {str(dtype)[6:]} B={B} nh=30, the PC grid's "
            f"calls: initial state: {rep0}; after 8 plain PC iterations: "
            f"{rep8} (bar {bar})")
        if f64:
            nh, lanes = 18, 256

            def cut(a):
                return a[..., :lanes].contiguous()

            fa18 = (*(cut(a) for a in fa[:5]), cut(fa[5][:, :34 + nh]),
                    cut(fa[6][:, :nh]), cut(fa[7]), cut(fa[8]), *fa[9:])
            fac18 = lqr_kernel.lqr_factor_fused_reference(*fa18)
            sa18 = [(fac18, *(cut(a) for a in args[1:])) for args in sa]
            _, rep = hold_kernels(k4_jobs(fa18, sa18), rel_tol, False)
            say(f"phase 9 K4 vs plain float64 B={lanes} nh={nh}: {rep} (bar "
                f"{bar})")
        else:
            errs = {"lqr_factor_fused": w0["K4a"],
                    "lqr_backsolve_fused": max(v for k, v in w0.items()
                                               if k != "K4a")}
            f32_args = (fa, sa)
    return errs, f32_args


def random_lqr(rng, N, Bn):
    """Well-conditioned random LQR data, lane-major numpy (Q, R, S, qx, qu,
    A, B, c, dx0): tools/kernel_parity_debug.py::_random_lqr."""
    nxb, nu = lqr_kernel.NXB, lqr_kernel.NU

    def spd(n):
        M = rng.standard_normal((N, n, n, Bn))
        return (np.einsum("nikb,njkb->nijb", M, M) / n
                + np.eye(n)[None, :, :, None])

    Q = spd(nxb)
    R = spd(nu)
    S = 0.1 * rng.standard_normal((N, nu, nxb, Bn))
    qx = rng.standard_normal((N, nxb, Bn))
    qu = rng.standard_normal((N, nu, Bn))
    A = np.eye(nxb)[None, :, :, None] + 0.05 * rng.standard_normal(
        (N - 1, nxb, nxb, Bn))
    B = 0.1 * rng.standard_normal((N - 1, nxb, nu, Bn))
    c = 0.01 * rng.standard_normal((N - 1, nxb, Bn))
    dx0 = rng.standard_normal((9, Bn))
    return Q, R, S, qx, qu, A, B, c, dx0


def kkt_residuals(args, sol):
    """Max |residual| of each KKT condition of the LQR at the solution
    (tools/kernel_parity_debug.py::check_lqr_kkt); lane-major args and
    solution, numpy or CPU tensors."""
    Q, R, S, qx, qu, A, B, c, dx0 = (np.moveaxis(np.asarray(a), -1, 0)
                                     for a in args)
    dxb, du, nu = (np.moveaxis(np.asarray(a), -1, 0) for a in sol[:3])
    pred = (np.einsum("bnij,bnj->bni", A, dxb[:, :-1])
            + np.einsum("bnij,bnj->bni", B, du[:, :-1]) + c)
    r_u = (np.einsum("bnij,bnj->bni", R[:, :-1], du[:, :-1])
           + np.einsum("bnij,bnj->bni", S[:, :-1], dxb[:, :-1])
           + qu[:, :-1] + np.einsum("bnji,bnj->bni", B, nu[:, 1:]))
    r_uT = (np.einsum("bij,bj->bi", R[:, -1], du[:, -1])
            + np.einsum("bij,bj->bi", S[:, -1], dxb[:, -1]) + qu[:, -1])
    return {
        "init": np.abs(dxb[:, 0, :9] - dx0).max(),
        "dynamics": np.abs(pred - dxb[:, 1:]).max(),
        "stationarity": np.abs(r_u).max(),
        "terminal": np.abs(r_uT).max(),
        "dtheta costate": np.abs(nu[:, 0, 9:]).max(),
    }


def check_k5(dev):
    """Phase 9, K5: random well-conditioned blocks at B = 4096, N = 20,
    against the plain factor and backsolve (f64 within 1e-9 (1+|ref|), f32
    within 1e-4 (1+|ref|)); the f64 kernel solution's KKT residuals within
    1e-8; then the path, riccati.solve_lqr_batched at f32, counted.
    Returns the f32 max |kernel - plain|, the path's launches and the f32
    arguments (for the times)."""
    args = random_lqr(np.random.default_rng(0), LQR_N, LQR_B)
    for dtype, rel_tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        t = [torch.as_tensor(a, dtype=dtype, device=dev) for a in args]
        Q, R, S, qx, qu, A, B, c, dx0 = t
        fac = lqr_kernel.lqr_factor_reference(Q, R, S, A, B)
        worst, rep = hold_kernels([
            ("K5a", lqr_kernel.lqr_factor_lanes,
             lqr_kernel.lqr_factor_reference, (Q, R, S, A, B)),
            ("K5b", lqr_kernel.lqr_backsolve_lanes,
             lqr_kernel.lqr_backsolve_reference,
             (fac, A, B, c, qx, qu, dx0)),
        ], rel_tol, False)
        msg = ""
        if dtype == torch.float64:
            res = kkt_residuals(args, [a.cpu() for a in
                                       riccati.solve_lqr_batched(*t)])
            if max(res.values()) > 1e-8:
                fail(f"K5 f64 KKT residuals {res} > 1e-8")
            msg = "; KKT residuals of the kernel solution: " + ", ".join(
                f"{k} {v:.1e}" for k, v in res.items()) + " (bar 1e-8)"
        say(f"phase 9 K5 vs plain {str(dtype)[6:]} B={LQR_B} N={LQR_N} random "
            f"blocks: {rep} (bar {rel_tol:g} (1+|ref|)){msg}")
    reset_counts()
    riccati.solve_lqr_batched(*t)
    torch.cuda.synchronize()
    launches = {k: lqr_kernel.LAUNCHES[k] for k in ("lqr_factor",
                                                     "lqr_backsolve")}
    if any(v != 1 for v in launches.values()):
        fail(f"riccati.solve_lqr_batched launched {launches} (want 1 each)")
    say(f"phase 9 the batched-LQR path riccati.solve_lqr_batched f32: "
        f"launches K5a {launches['lqr_factor']} K5b "
        f"{launches['lqr_backsolve']}")
    return ({"lqr_factor": worst["K5a"], "lqr_backsolve": worst["K5b"]},
            launches, t)


def grid_times(cfg, dev):
    """solve_scenario_grid at f32 over 5 fresh bench seed sets after a
    warm-up: (ms per call, mean iterations)."""
    batch.solve_scenario_grid(cfg, *workloads.bench_seeds(1000), workloads.HALVES,
                              device=dev)
    lat, iters = [], []
    for seed in range(1001, 1006):
        g, f = workloads.bench_seeds(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = batch.solve_scenario_grid(cfg, g, f, workloads.HALVES, device=dev)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        iters.append(r.iters.double().mean().item())
    return 1e3 * np.asarray(lat), float(np.mean(iters))


def step_times(cfg, dev, drift, label, card, phase):
    """nmpc_step_batched at f32 over 5 pre-staged fresh input sets."""
    B = STEP_B
    sets = [step_inputs(seed, B, torch.float32, dev, drift=drift)
            for seed in range(1001, 1006)]
    torch.cuda.synchronize()
    lat, solved_t, iters = [], [], []
    for a in sets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = step(a, cfg)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        solved_t.append((r.exit_code == 1).double().mean().item())
        iters.append(r.iters.double().mean().item())
    lat_ms = 1e3 * np.asarray(lat)
    say(f"phase {phase} nmpc_step_batched B={B} f32{label} [{card}]: "
        f"{lat_ms.mean():.2f} ms/call (min {lat_ms.min():.2f}, max "
        f"{lat_ms.max():.2f}), {B / lat_ms.mean() * 1e3:.1f} steps/s, "
        f"solved {np.mean(solved_t):.6f}, mean iters {np.mean(iters):.3f}")


def run_slice3(dev, card, mono_grid):
    """Phases 9-11; mono_grid = phase 4's (ms per call, mean iterations).
    Returns the {"kernels"} entries of K4a, K4b, K5a and K5b."""
    cfg_pc = with_pc(workloads.bench_config())
    f32 = torch.float32

    # ---- phase 9: K4 and K5 vs plain --------------------------------------
    errs, (fa, sa) = check_k4(dev, cfg_pc)
    errs5, launches, k5 = check_k5(dev)
    errs.update(errs5)

    # ---- phase 10: the predictor-corrector main path ----------------------
    counts = check_grid(dev, cfg_pc, 10)
    launches.update(lqr_factor_fused=counts[3],
                    lqr_backsolve_fused=counts[4])
    step_pc = with_pc(DEFAULT_CONFIG)
    for drift, label in ((False, ""), (True, ", every 4th robot drifted")):
        check_step(step_inputs(1 + drift, STEP_B, f32, dev, drift=drift), dev,
                   f", predictor-corrector{label}", step_pc, 10, 0.995)

    # ---- phase 11: times --------------------------------------------------
    Q, R, S, qx, qu, A, B, c, dx0 = k5
    fac5 = lqr_kernel.lqr_factor_reference(Q, R, S, A, B)
    calls = {
        "lqr_factor_fused": fa,
        "lqr_backsolve_fused": sa[0],
        "lqr_factor": (Q, R, S, A, B),
        "lqr_backsolve": (fac5, A, B, c, qx, qu, dx0),
    }
    flops = {
        "lqr_factor_fused": riccati_factor_flops(LQR_N, fa[5].shape[1] - 34),
        "lqr_backsolve_fused": riccati_solve_flops(LQR_N),
        "lqr_factor": riccati_factor_flops(LQR_N),
        "lqr_backsolve": riccati_solve_flops(LQR_N),
    }
    ms, plain_ms, bounds = {}, {}, {}
    for name, args in calls.items():
        kernel = getattr(lqr_kernel, name + "_lanes")
        plain = getattr(lqr_kernel, name + "_reference")
        ms[name] = cuda_ms(lambda: kernel(*args), 20)
        plain_ms[name] = cuda_ms(lambda: plain(*args), 3)
        bounds[name] = bound(tensor_bytes(args, plain(*args)),
                             LQR_B * flops[name])
    say(f"phase 11 kernels f32 B={LQR_B} N={LQR_N} [{card}]: " + "; ".join(
        f"{LQR_KERNELS[n][0]} {ms[n]:.3f} ms vs plain {plain_ms[n]:.3f} ms, "
        f"bound {bounds[n][0]:.4f} ms by {bounds[n][1]}"
        for n in calls) + " (K4: the PC grid's initial-state calls, K5: the "
        "random blocks)")
    lat_ms, iters = grid_times(cfg_pc, dev)
    mono_ms, mono_iters = mono_grid
    Bg = workloads.N_GOALS * workloads.N_FORCES * len(workloads.HALVES)
    say(f"phase 11 PC grid solve B={Bg} f32 [{card}]: {lat_ms.mean():.2f} "
        f"ms/call (min {lat_ms.min():.2f}, max {lat_ms.max():.2f}), "
        f"{Bg / lat_ms.mean() * 1e3:.1f} solves/s, mean iters {iters:.3f}; "
        f"monotone (phase 4): {mono_ms:.2f} ms/call, "
        f"{Bg / mono_ms * 1e3:.1f} solves/s, mean iters {mono_iters:.3f}")
    for drift, label in ((False, ""), (True, ", every 4th robot drifted")):
        step_times(step_pc, dev, drift, f", predictor-corrector{label}", card,
                   11)
    one_robot_latency(step_pc, "DEFAULT_CONFIG predictor-corrector", STEP_M,
                      dev, card, phase=11)

    return [
        {"name": name, "route": "cuda", "source": CSRC + "lqr.cu",
         "replaces": LQR_KERNELS[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": ms[name],
         "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name in LQR_KERNELS
    ]


def lane_position_check(state, params, cfg, seed):
    """K1 on a permutation of the lanes gives the permuted outputs bit for
    bit, and the 256 lanes that the tier schedule would compact (the
    unconverged first) launched alone equal the same lanes of the full
    launch (utils/lanes.py: the tiered solve's bit-exactness)."""
    B = state[0].shape[-1]
    full = ipm_kernel.ipm_iteration_fused(*iter_args(state, params, cfg))
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(B, generator=gen).to(state[0].device)
    tier = ipm_lanes._compact_order(state[4][2] > 0.5)[:256]
    for label, idx in (("a permutation of the lanes", perm),
                       ("the 256-lane tier alone", tier)):
        sub = [a[..., idx].contiguous() for a in state]
        sub_p = ipm_lanes._map_params(lambda a: a[..., idx].contiguous(),
                                      params)
        got = ipm_kernel.ipm_iteration_fused(*iter_args(sub, sub_p, cfg))
        torch.cuda.synchronize()
        for name, g, r in zip(("Z", "lam", "s", "mu_d", "scal"), got, full):
            r = r[..., idx]
            if not (torch.equal(g.isnan(), r.isnan())
                    and torch.equal(g.nan_to_num(), r.nan_to_num())):
                fail(f"K1 on {label}: {name} differs from the full launch")
    return (f"bit-identical on a permutation of the {B} lanes and on "
            f"{tier.numel()} tier lanes launched alone")


def check_k1(cfg, dev):
    """Phase 2: K1 against its plain version at B = 4096 from the grid's
    initial state and after 8 plain iterations, f64 and f32, and the lane-
    position check; returns {dtype: max |kernel - plain| from the initial
    state}."""
    errs = {}
    for dtype, rel_tol, done_frac in ((torch.float64, 1e-9, 1.0),
                                      (torch.float32, 1e-3, 0.999)):
        state, params = bench_lanes(cfg, 1, dtype, dev)
        r0 = compare_step(state, params, cfg, rel_tol, done_frac, False)
        for _ in range(8):
            state = list(ipm_kernel.ipm_iteration_reference(
                *iter_args(state, params, cfg)))
        r8 = compare_step(state, params, cfg, rel_tol, done_frac,
                          dtype == torch.float32)
        errs[dtype] = r0[1]
        say(f"phase 2 kernel vs plain {str(dtype)[6:]} B={state[0].shape[-1]}:"
            f" init max rel {r0[0]:.3e} abs {r0[1]:.3e} done-agree {r0[2]:.6f};"
            f" after 8 plain iters max rel {r8[0]:.3e} abs {r8[1]:.3e}"
            f" done-agree {r8[2]:.6f} (bound {rel_tol:g} (1+|ref|))")
        say(f"phase 2 K1 lane position {str(dtype)[6:]}, after 8 plain "
            f"iters: {lane_position_check(state, params, cfg, 8)}")
    return errs


def time_k1(cfg, dev, card):
    """Phase 4, K1: ms per iteration at B = 4096, 1024, 256 and 1 (the
    first lanes of the grid of seed 2 at its initial state, every lane
    active) with CUDA events, each beside its bound; the plain version at
    4096.  Returns (ms, plain ms, bound ms, bound by) at B = 4096."""
    state, params = bench_lanes(cfg, 2, torch.float32, dev)
    args = iter_args(state, params, cfg)
    ms_plain = cuda_ms(lambda: ipm_kernel.ipm_iteration_reference(*args), 5)
    k1_times = {}
    for Bw in (4096, 1024, 256, 1):
        sub = [a[..., :Bw].contiguous() for a in state]
        sub_p = ipm_lanes._map_params(lambda a: a[..., :Bw].contiguous(),
                                      params)
        a = iter_args(sub, sub_p, cfg)
        ms = cuda_ms(lambda: ipm_kernel.ipm_iteration_fused(*a), 20)
        ms2 = cuda_ms(lambda: ipm_kernel.ipm_iteration_fused(*a), 20)
        bms, by = bound(tensor_bytes(a[:13]) + tensor_bytes(a[:5]),
                        Bw * k1_flops(cfg.model.N))
        k1_times[Bw] = (min(ms, ms2), bms, by)
        say(f"phase 4 K1 per iteration B={Bw} f32 [{card}]: {ms:.4f} ms "
            f"(repeat {ms2:.4f} ms); bound {bms:.4f} ms by {by} "
            f"({1e-6 * tensor_bytes(a[:13], a[:5]):.3f} MB, "
            f"{1e-9 * Bw * k1_flops(cfg.model.N):.4f} GFLOP), "
            f"{100 * bms / min(ms, ms2):.2f}% of the bound")
    ms_kernel, bound_ms, bound_by = k1_times[4096]
    say(f"phase 4 per iteration B=4096 f32 [{card}]: kernel {ms_kernel:.3f} "
        f"ms, plain PyTorch {ms_plain:.3f} ms")
    return ms_kernel, ms_plain, bound_ms, bound_by


def device_phase():
    """Phase 0: the card, or None without one."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return None
    if "jax" in sys.modules:
        fail("jax was imported")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"phase 0 device: {kind} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return dev, card, kind


def build_phase():
    """Phase 1: every kernel source built, one nvcc each, all at once."""
    t0 = time.perf_counter()
    for source, built in _build.build().items():
        ptxas = [ln.strip() for ln in built.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry function" in ln]
        say(f"phase 1 build {source}: {built.seconds:.1f} s -> "
            f"{built.path.name}; " + " | ".join(ptxas))
    say(f"phase 1 build: all sources in {time.perf_counter() - t0:.1f} s")
    N = workloads.bench_config().model.N
    geo = []
    for dtype in (torch.float32, torch.float64):
        lanes, smem, stride = ipm_kernel.launch_geometry(dtype, N)
        geo.append(f"{str(dtype)[6:]} {lanes} lanes x {smem // lanes} B = "
                   f"{smem} B of shared memory per CTA, "
                   f"{ipm_kernel.TEAM * lanes} threads")
    say(f"phase 1 K1 ({KERNEL_SOURCE}) at N = {N}: " + "; ".join(geo)
        + " (registers and spills: the ipm_iteration.cu line above)")
    lib2 = _build.load(tube_kernel.SOURCE, tube_kernel._bind)
    geo = []
    for dtype in (torch.float32, torch.float64):
        lanes, threads, smem = tube_kernel.launch_geometry(lib2, dtype)
        geo.append(f"{str(dtype)[6:]} {lanes} stage lanes x 9 threads "
                   f"({threads} threads, {smem} B of shared memory) per CTA")
    say("phase 1 K2 (tube_stage.cu): " + "; ".join(geo)
        + " (registers and spills: the tube_stage.cu line above)")
    lib3 = _build.load(corridor_kernel.SOURCE, corridor_kernel._bind)
    geo = []
    for dtype in (torch.float32, torch.float64):
        for M in (STEP_M, 1024, 2048):
            lanes, threads, smem = corridor_kernel.launch_geometry(
                lib3, N, M, dtype)
            geo.append(f"{str(dtype)[6:]} M={M}: {lanes} lanes per stage, "
                       f"{threads} threads, {smem} B of shared memory")
    say(f"phase 1 K3 (corridor.cu) per CTA (one scenario, N = {N}): "
        + "; ".join(geo) + " (registers: the corridor.cu line above)")


def main() -> int:
    t_start = time.perf_counter()
    # ---- phase 0: device ------------------------------------------------
    found = device_phase()
    if found is None:
        return 1
    dev, card, kind = found

    # ---- phase 1: build ---------------------------------------------------
    build_phase()

    cfg = workloads.bench_config()

    # ---- phase 2: kernel vs plain at B = 4096 -----------------------------
    errs = check_k1(cfg, dev)

    # ---- phase 3: main path ---------------------------------------------
    launches = check_grid(dev, cfg, 3, solved_min=0.999)[0]
    B = workloads.N_GOALS * workloads.N_FORCES * len(workloads.HALVES)

    # ---- phase 4: times ---------------------------------------------------
    ms_kernel, ms_plain, bound_ms, bound_by = time_k1(cfg, dev, card)
    lat_ms, iters = grid_times(cfg, dev)
    say(f"phase 4 grid solve B={B} f32 [{card}]: {lat_ms.mean():.2f} ms/call "
        f"(min {lat_ms.min():.2f}, max {lat_ms.max():.2f}), "
        f"{B / lat_ms.mean() * 1e3:.1f} solves/s, mean iters {iters:.3f}")

    slice2 = run_slice2(dev, card)
    slice3 = run_slice3(dev, card, (lat_ms.mean(), iters))

    say(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    # max_abs_err: f32 kernel vs plain from the initial state, the check
    # held elementwise (the mid-solve one is printed in phase 2)
    print(json.dumps({"kernels": [{
        "name": "ipm_iteration", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": errs[torch.float32], "ms": ms_kernel,
        "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }, *slice2, *slice3]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
