"""Time the tube kernel (K2) and the corridor kernel (K3) on the card through
their public wrappers, and optionally the end-to-end paths around them.

    python3 k23_probe.py [--reps R] [--m M [M ...]] [--k3-split] [--e2e]
    python3 k23_probe.py --against DIR --order PCCP [the options above]

Run from the root of a checkout; needs an NVIDIA GPU.  One run prints one
JSON line: the card, K2 ms per call at L = 4096 x 20 stage lanes (the full
step's f32 inputs, chip_smoke.step_inputs) and, for each M of --m (default
256), K3 ms per call on the full step's segments with M obstacles per robot
(B = 4096, N = 20) and on chip_smoke.random_segments at B = 64 (phase 6's
generic case); each time is CUDA events over R calls after a warm-up,
taken twice, beside the f32 max |kernel - plain| on the same inputs.
--k3-split adds K3's time at the first M with no peel rows
(max_obs_planes = 0) and with every obstacle masked out.  --e2e adds chip_smoke.py's timings of
nmpc_step_batched (easy and drifted), the bench grid and nmpc_step at
B = 1.

--root DIR imports the port and chip_smoke.py from the checkout at DIR (for
example an earlier commit unpacked with `git archive`): the probe calls only
the kernels' wrappers and plain versions and chip_smoke.py helpers that
every version of the port since the full step has, so it times either.
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

    out = {"root": args.root or ".", "card": chip_smoke.card_line()}
    inputs = chip_smoke.step_inputs(1, B, f32, dev)
    Z = inputs["mpc_output"][:, :N]
    targs = (Z[..., 8:17].reshape(B * N, 9).contiguous(),
             Z[..., 0:4].reshape(B * N, 4).contiguous(), cfg.model, cfg.tube)
    out["K2"] = timed(tube_kernel.tube_stage_lanes,
                      tube_kernel.tube_stage_reference, targs)
    del inputs, Z

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--m", type=int, nargs="+", default=[256])
    ap.add_argument("--k3-split", action="store_true")
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
