"""Readings that set the limits of a cell's comparison with the reference.

    python3 benchmark/control.py --workload <cell> --mode program|control \
        --seeds <n> [<n> ...] [--seconds <s>] [--dtype bfloat16|float16|tf32 ...] \
        [--out <file.jsonl>]

program: for each seed, one run of the cell as benchmark/run.py makes it
(set-up, a window of --seconds, the check), its compared numbers: the
program's readings, of which the largest over a dozen seeds or more is a
limit's lower reading.
control: for each seed, the cell's set-up and then the plain reference
computed in --dtype put in the program's place, checked as a run checks
the program: bfloat16, the step below the configuration's float32;
float16, which keeps 10 mantissa bits to bfloat16's 7; tf32, float32
with the matmuls in TF32 (the step's reference multiplies matrices in
its tubes; the solver's reference multiplies none, so there tf32 is
float32).  The smallest of these readings is a limit's upper reading.
Every seed runs in this one process, which needs a CUDA device.  Not part
of a benchmark run.  One JSON line per seed on standard output and in
--out.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import run, spec  # noqa: E402
from benchmark.reference.config import from_groups  # noqa: E402

# --dtype: (the reference's dtype, matmuls in TF32)
DTYPES = {"bfloat16": (torch.bfloat16, False),
          "float16": (torch.float16, False),
          "tf32": (torch.float32, True)}


def readings(cell, mode: str, seed: int, seconds: float, device,
             dtype: str = "bfloat16") -> dict:
    if mode == "program":
        result, checks = run.run_cell(cell, seed, seconds, False, device,
                                      time.perf_counter())
        return {"values": {k: v for k, (v, _) in checks.items()},
                "metrics": {k: m["value"]
                            for k, m in result["metrics"].items()}}
    loop = spec.kind(cell.traffic["kind"]).Loop(
        spec.program_config(cell.config), from_groups(cell.config["groups"]),
        cell.traffic, seed, device)
    loop.release()
    dt, tf32 = DTYPES[dtype]
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return {"values": loop.control(dt)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dtype", choices=tuple(DTYPES), nargs="+",
                    default=["bfloat16"])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    dtypes = args.dtype if args.mode == "control" else [None]
    for seed, dtype in ((s, d) for s in args.seeds for d in dtypes):
        t0 = time.perf_counter()
        line = {"cell": cell.name, "mode": args.mode, "seed": seed,
                **({"dtype": dtype} if dtype else {}),
                **readings(cell, args.mode, seed, args.seconds, "cuda:0",
                           dtype),
                "wall_s": time.perf_counter() - t0}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
