"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the bench headline: a 256 goals x 16 forces
x 1 box = 4096-scenario grid at N = 20, solved by
engine/batch.py::solve_scenario_grid with the bench tier schedule, every
monotone IPM iteration launched as the hand-written CUDA kernel
ops/csrc/ipm_iteration.cu.  Phases, one line each (any failure exits
non-zero and nothing after it is printed):

  0. device: needs torch.cuda; prints the card's name and power limit
  1. build: compiles the kernel with nvcc, prints build seconds and the
     ptxas register / spill report
  2. kernel vs its plain PyTorch version on the card at B = 4096, one
     iteration from the initial state and one after 8 plain iterations:
     f64 |d| <= 1e-9 (1 + |ref|) with identical it/done; f32 from the
     initial state |d| <= 1e-3 (1 + |ref|) on the lanes whose done flag
     agrees; f32 in mid-solve the kernel's error against the f64 step from
     the same state within 1.25x the plain f32 step's (+1e-3); f32 done
     flags agreeing on >= 99.9% of lanes
  3. main path at f32: solved fraction >= 0.999; kernel launches equal to
     the host-loop iterations stepped (> 0); the first 64 lanes re-solved
     by the plain path at f64 on the CPU within 1e-3 in u; the grid solved
     through the plain version on the card agreeing on exit codes for
     >= 99.5% of lanes
  4. times: kernel and plain ms per iteration, grid-solve ms per call and
     solves/s over 5 fresh seed sets, mean iterations

Then a {"kernels": [...]} JSON line, and last {"ok": true, "device": ...}.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

import bench
from forces_resilient_planner_tpu_torch.engine import batch
from forces_resilient_planner_tpu_torch.ops import _build, ipm_kernel
from forces_resilient_planner_tpu_torch.solver import ipm_lanes, nlp

KERNEL_SOURCE = "forces_resilient_planner_tpu_torch/ops/csrc/ipm_iteration.cu"
KERNEL_REPLACES = "forces_resilient_planner_tpu/ops/ipm_pallas.py:218"
MAX_ITERS = 60.0


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
    goals, forces = bench.bench_seeds(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    x0 = np.zeros(9)
    x0[2] = 1.2
    weights = nlp.make_stage_weights(
        cfg.weights, cfg.model.N, dtype=dtype, device=device
    )
    scen = batch._expand_scenarios_device(
        cfg, t(x0), t(goals), t(forces), t(bench.HALVES), weights
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


def main() -> int:
    # ---- phase 0: device ------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
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

    # ---- phase 1: build ---------------------------------------------------
    built = _build.load()
    ptxas = [ln.strip() for ln in built.ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"phase 1 build: {built.seconds:.1f} s -> {built.path.name}; "
        + " | ".join(ptxas))

    cfg = bench.bench_config()

    # ---- phase 2: kernel vs plain at B = 4096 -----------------------------
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

    # ---- phase 3: main path ---------------------------------------------
    goals, forces = bench.bench_seeds(1)
    ipm_kernel.LAUNCHES = 0
    ipm_lanes.STEPS = 0
    res = batch.solve_scenario_grid(
        cfg, goals, forces, bench.HALVES, dtype=torch.float32, device=dev
    )
    torch.cuda.synchronize()
    launches, steps = ipm_kernel.LAUNCHES, ipm_lanes.STEPS
    if "jax" in sys.modules:
        fail("jax was imported")
    ec = res.exit_code.cpu().numpy()
    B = ec.size
    solved = float((ec == 1).mean())
    if B != bench.N_GOALS * bench.N_FORCES * len(bench.HALVES):
        fail(f"grid has {B} lanes")
    if not torch.isfinite(res.Z).all():
        fail("non-finite Z")
    if solved < 0.999:
        fail(f"solved fraction {solved:.6f} < 0.999")
    if not (launches == steps and launches > 0):
        fail(f"kernel launches {launches} != host-loop steps {steps} (or 0)")

    ref64 = batch.solve_scenario_grid(
        cfg, goals[:4], forces, bench.HALVES, dtype=torch.float64,
        device="cpu",
    )
    both = (ref64.exit_code.numpy() == 1) & (ec[:64] == 1)
    du = (res.Z[:64, :, 0:4].double().cpu() - ref64.Z[:, :, 0:4]).abs()
    du_max = du[torch.from_numpy(both)].max().item()
    if both.sum() < 63 or du_max > 1e-3:
        fail(f"f64 CPU re-solve: {both.sum()} of 64 lanes solved by both, "
             f"max |du| {du_max:.3e} (bar 1e-3)")

    with mock.patch.object(ipm_kernel, "ipm_iteration_fused",
                           ipm_kernel.ipm_iteration_reference):
        plain = batch.solve_scenario_grid(
            cfg, goals, forces, bench.HALVES, dtype=torch.float32, device=dev
        )
    torch.cuda.synchronize()
    if ipm_kernel.LAUNCHES != launches:
        fail("the plain solve launched the kernel")
    ec_agree = float((plain.exit_code.cpu().numpy() == ec).mean())
    if ec_agree < 0.995:
        fail(f"kernel and plain grid exit codes agree on {ec_agree:.6f} < 0.995")
    say(f"phase 3 main path B={B} f32: solved {solved:.6f}, kernel launches "
        f"{launches} = host-loop steps {steps}, mean iters "
        f"{res.iters.double().mean().item():.3f}; f64 CPU re-solve of lanes "
        f"0-63: max |du| {du_max:.3e} over {both.sum()} lanes; plain-path "
        f"exit-code agreement {ec_agree:.6f}")

    # ---- phase 4: times ---------------------------------------------------
    state, params = bench_lanes(cfg, 2, torch.float32, dev)
    args = iter_args(state, params, cfg)
    ms_kernel = cuda_ms(lambda: ipm_kernel.ipm_iteration_fused(*args), 20)
    ms_plain = cuda_ms(lambda: ipm_kernel.ipm_iteration_reference(*args), 5)
    ms_kernel2 = cuda_ms(lambda: ipm_kernel.ipm_iteration_fused(*args), 20)
    say(f"phase 4 per iteration B=4096 f32 [{card}]: kernel {ms_kernel:.3f} "
        f"ms (repeat {ms_kernel2:.3f} ms), plain PyTorch {ms_plain:.3f} ms")

    batch.solve_scenario_grid(  # warm-up
        cfg, *bench.bench_seeds(1000), bench.HALVES, device=dev)
    lat, iters = [], []
    for seed in range(1001, 1006):
        g, f = bench.bench_seeds(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = batch.solve_scenario_grid(cfg, g, f, bench.HALVES, device=dev)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        iters.append(r.iters.double().mean().item())
    lat_ms = 1e3 * np.asarray(lat)
    say(f"phase 4 grid solve B={B} f32 [{card}]: {lat_ms.mean():.2f} ms/call "
        f"(min {lat_ms.min():.2f}, max {lat_ms.max():.2f}), "
        f"{B / lat_ms.mean() * 1e3:.1f} solves/s, mean iters "
        f"{np.mean(iters):.3f}")

    # max_abs_err: f32 kernel vs plain from the initial state, the check
    # held elementwise (the mid-solve one is printed in phase 2)
    print(json.dumps({"kernels": [{
        "name": "ipm_iteration", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": errs[torch.float32], "ms": ms_kernel,
        "plain_ms": ms_plain,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
