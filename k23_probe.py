"""Time the tube kernel (K2), the tube chain, stage 1's references and the
corridor kernel (K3) on the card through their public wrappers, optionally
the Riccati kernels K4a and K4b of the predictor-corrector and K5a and K5b
of the batched LQR, and optionally the end-to-end paths around them.

    python3 k23_probe.py [--reps R] [--m M [M ...]] [--k3-split] [--k4] [--k5]
                         [--e2e]
    python3 k23_probe.py --against DIR --order PCCP [the options above]

Run from the root of a checkout; needs an NVIDIA GPU.  One run prints one
JSON line: the card, K2 ms per call at L = 4096 x 20 stage lanes (the full
step's f32 inputs, chip_smoke.step_inputs), the tube chain ms per call on
K2's outputs there at B = 4096 and B = 1 (N = 20) beside its bound
(utils/measure.py::bound of the bytes it must move and
tube_kernel.tube_chain_operations), engine/reference.py::
sample_references ms per call on the same step's inputs at B = 4096 and
B = 1 (in a checkout with the references kernel: its time on the card
alone, `device_ms` (utils/measure.py::device_ms), beside its bound,
chip_smoke.reference_bound, and the plain version's ms and
max |kernel - plain|) and, for each M of --m (default
256), K3 ms per call on the full step's segments with M obstacles per robot
(B = 4096, N = 20) and on chip_smoke.random_segments at B = 64 (phase 6's
generic case); each time is CUDA events over R calls after a warm-up,
taken twice, beside the f32 max |kernel - plain| on the same inputs.
--k3-split adds K3's time at the first M with no peel rows
(max_obs_planes = 0) and with every obstacle masked out.  --k4 adds K4a's and
K4b's times on the predictor-corrector grid's own initial-state calls
(chip_smoke.record_k4: the bench grid of seed 1, B = 4096, f32) at B = 4096,
1024, 256 and 1, each beside its f32 max |kernel - plain|.  --k5 adds
K5a's and K5b's times on phase 9's random blocks (chip_smoke.random_lqr,
seed 0, N = 20, f32) at B = 4096, 1024, 256 and 1, each beside its f32
max |kernel - plain|.  --e2e adds
chip_smoke.py's timings of nmpc_step_batched (easy and drifted), the bench
grid and nmpc_step at B = 1, and with --k4 the predictor-corrector grid.

--root DIR imports the port and chip_smoke.py from the checkout at DIR (for
example an earlier commit unpacked with `git archive`): the probe calls only
the kernels' wrappers and plain versions and chip_smoke.py helpers that
every version of the port since the full step (--k4, --k5: since the
predictor-corrector and the batched LQR) has, so it times either.
--against DIR runs the probe once per letter of --order, each in a fresh
process: C this checkout, P the one at DIR.  Compare two versions only
within one such call, in turns.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them (here, not
    from chip_smoke.py, so that every version of it times)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def probe(args) -> None:
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k23_probe needs an NVIDIA GPU")
    import chip_smoke
    from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG
    from forces_resilient_planner_tpu_torch.engine import workloads
    from forces_resilient_planner_tpu_torch.ops import (
        corridor_kernel,
        lqr_kernel,
        tube_kernel,
    )

    dev = torch.device("cuda:0")
    f32 = torch.float32
    cfg = DEFAULT_CONFIG
    N, B = cfg.model.N, chip_smoke.STEP_B

    def timed(kernel, plain, a):
        """ms per call, twice; with `plain`, the f32 max |kernel - plain|"""
        out = {"ms": [chip_smoke.cuda_ms(lambda: kernel(*a), args.reps)
                      for _ in range(2)]}
        if plain is not None:
            got, ref = kernel(*a), plain(*a)
            out["max_abs_err"] = max((g - r).abs().max().item()
                                     for g, r in zip(got, ref))
        return out

    out = {"root": args.root or ".", "card": card_line()}
    inputs = chip_smoke.step_inputs(1, B, f32, dev)
    Z = inputs["mpc_output"][:, :N]
    targs = (Z[..., 8:17].reshape(B * N, 9).contiguous(),
             Z[..., 0:4].reshape(B * N, 4).contiguous(), cfg.model, cfg.tube)
    out["K2"] = timed(tube_kernel.tube_stage_lanes,
                      tube_kernel.tube_stage_reference, targs)
    if hasattr(tube_kernel, "tube_chain_lanes"):     # not in earlier checkouts
        Qd, Mp, _, Q1 = tube_kernel.tube_stage_lanes(*targs)
        for Bw in (B, 1):
            a = (Qd.reshape(B, N, 9, 9)[:Bw], Mp.reshape(B, N, 9, 9)[:Bw],
                 Q1.reshape(B, N, 3, 3)[:Bw], cfg.tube)
            t = timed(tube_kernel.tube_chain_lanes,
                      tube_kernel.tube_chain_reference, a)
            ms, by = chip_smoke.chain_bound(*a[:3])
            t.update(bound_ms=ms, bound_by=by,
                     bound_share_pct=100 * ms / min(t["ms"]),
                     plain_ms=chip_smoke.cuda_ms(
                         lambda: tube_kernel.tube_chain_reference(*a), 3))
            out[f"chain B={Bw} N={N}"] = t
        del Qd, Mp, Q1
    from forces_resilient_planner_tpu_torch.engine import reference
    plain = getattr(reference, "sample_references_plain", None)
    for Bw in (B, 1):
        prev = inputs["mpc_output"][:Bw]
        a = (inputs["kino_path"][:Bw], inputs["kino_size"][:Bw],
             inputs["t_offset"][:Bw], prev[:, 1, 16], prev[:, 1, 8:11], N,
             cfg.model.dt)
        t = timed(reference.sample_references, plain, a)
        if plain is not None:                  # the kernel's checkout
            ms, by = chip_smoke.reference_bound(a[0], N)
            dev_ms = chip_smoke.device_ms(
                lambda: reference.sample_references(*a), 20)
            t.update(device_ms=dev_ms, bound_ms=ms, bound_by=by,
                     bound_share_pct=100 * ms / dev_ms,
                     plain_ms=chip_smoke.cuda_ms(lambda: plain(*a), 3))
        out[f"references B={Bw} N={N}"] = t
    del inputs, Z

    def cut(a, Bw):
        """a's first Bw lanes (a factor's fields each)"""
        if isinstance(a, tuple):
            return type(a)(*(cut(t, Bw) for t in a))
        return a[..., :Bw].contiguous() if torch.is_tensor(a) else a

    def k3(segs, ccfg=cfg.corridor, check=True):
        a = (*segs, ccfg, cfg.model.nh)
        return timed(corridor_kernel.decompose_stages_lanes,
                     corridor_kernel.decompose_stages_reference if check
                     else None, a)

    for M in args.m:
        segs = chip_smoke.stage_segments(
            chip_smoke.step_inputs(1, B, f32, dev, M=M), cfg)
        out[f"K3 B={B} M={M}"] = k3(segs)
        if args.k3_split and M == args.m[0]:
            out[f"K3 B={B} M={M} no peel"] = k3(segs, dataclasses.replace(
                cfg.corridor, max_obs_planes=0), check=False)
            out[f"K3 B={B} M={M} masked out"] = k3(
                (*segs[:3], torch.zeros_like(segs[3])), check=False)
        del segs
        rnd = chip_smoke.random_segments(64, N, M, 31)
        out[f"K3 B=64 M={M} random"] = k3(
            [torch.as_tensor(a, dtype=f32, device=dev) for a in rnd[:3]]
            + [torch.as_tensor(rnd[3], device=dev)])

    cfg_pc = chip_smoke.with_pc(workloads.bench_config())
    if args.k4:
        state, params = chip_smoke.bench_lanes(cfg_pc, 1, f32, dev)
        fa, sa = chip_smoke.record_k4(chip_smoke.lane_state(state), params,
                                      cfg_pc)
        del state, params
        for Bw in (4096, 1024, 256, 1):
            out[f"K4a B={Bw}"] = timed(
                lqr_kernel.lqr_factor_fused_lanes,
                lqr_kernel.lqr_factor_fused_reference,
                [cut(a, Bw) for a in fa])
            out[f"K4b B={Bw}"] = timed(
                lqr_kernel.lqr_backsolve_fused_lanes,
                lqr_kernel.lqr_backsolve_fused_reference,
                [cut(a, Bw) for a in sa[0]])
    if args.k5:
        Q, R, S, qx, qu, A, Bm, c, dx0 = (
            torch.as_tensor(a, dtype=f32, device=dev)
            for a in chip_smoke.random_lqr(np.random.default_rng(0),
                                           chip_smoke.LQR_N,
                                           chip_smoke.LQR_B))
        fac = lqr_kernel.lqr_factor_reference(Q, R, S, A, Bm)
        for Bw in (4096, 1024, 256, 1):
            out[f"K5a B={Bw}"] = timed(
                lqr_kernel.lqr_factor_lanes, lqr_kernel.lqr_factor_reference,
                [cut(a, Bw) for a in (Q, R, S, A, Bm)])
            out[f"K5b B={Bw}"] = timed(
                lqr_kernel.lqr_backsolve_lanes,
                lqr_kernel.lqr_backsolve_reference,
                [cut(a, Bw) for a in (fac, A, Bm, c, qx, qu, dx0)])
    print(json.dumps(out), flush=True)

    if args.e2e:
        chip_smoke.step(chip_smoke.step_inputs(0, B, f32, dev))
        torch.cuda.synchronize()
        card = out["card"]
        for drift, label in ((False, ""), (True, ", every 4th robot drifted")):
            chip_smoke.step_times(cfg, dev, drift, label, card, "e2e")
        lat, iters = chip_smoke.grid_times(workloads.bench_config(), dev)
        print(f"e2e grid solve f32 [{card}]: {lat.mean():.2f} ms/call (min "
              f"{lat.min():.2f}, max {lat.max():.2f}), mean iters "
              f"{iters:.3f}", flush=True)
        chip_smoke.one_robot_latency(cfg, "DEFAULT_CONFIG", chip_smoke.STEP_M,
                                     dev, card, phase="e2e")
        if args.k4:
            lat, iters = chip_smoke.grid_times(cfg_pc, dev)
            print(f"e2e PC grid solve f32 [{card}]: {lat.mean():.2f} ms/call "
                  f"(min {lat.min():.2f}, max {lat.max():.2f}), mean iters "
                  f"{iters:.3f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--m", type=int, nargs="+", default=[256])
    ap.add_argument("--k3-split", action="store_true")
    ap.add_argument("--k4", action="store_true")
    ap.add_argument("--k5", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--root", default="")
    ap.add_argument("--against", default="")
    ap.add_argument("--order", default="PCCP")
    args = ap.parse_args()
    if not args.against:
        probe(args)
        return 0
    if set(args.order) - {"P", "C"}:
        raise SystemExit("--order takes the letters P and C")
    passed = list(sys.argv[1:])
    for flag in ("--against", "--order"):
        if flag in passed:
            i = passed.index(flag)
            del passed[i:i + 2]
    for who in args.order:
        root = args.against if who == "P" else ""
        print(f"probe {who} {root or '.'}", flush=True)
        cmd = [sys.executable, str(Path(__file__).resolve()), *passed]
        if root:
            cmd += ["--root", root]
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
