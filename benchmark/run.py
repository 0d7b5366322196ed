"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    (or python3 -m benchmark.run ...)

Set-up (CUDA context, the kernels' libraries, the cell's inputs made from
the seed, its shapes warmed) is timed from the start of this process to
the first timed call.  The window then runs calls back to back for
--seconds (with --trace 1, under torch.profiler, for at most the traffic's
trace_calls), closes, and the program's answers of a sample drawn from
the seed are compared with the plain reference (benchmark/reference/).
The last line of standard output holds correct, attempted, failed, the
cell's metrics (end-to-end with --trace 0, per-layer with --trace 1), the
device, with --trace 1 the breakdown, and last the numbers compared
beside their limits, which also end standard error.

It needs as many CUDA devices as the cell asks for and exits non-zero
with no result without them; it never runs on the CPU.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import spec, trace  # noqa: E402
from benchmark.reference.config import from_groups  # noqa: E402

# top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "forces_resilient_planner_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _counters(modules) -> dict:
    """The program counters the metric modules read, by name."""
    out = {}
    for mod in modules:
        out.update(mod.counters() if hasattr(mod, "counters") else {})
    return out


def _number(v: float) -> float:
    """v for a JSON line, which holds no inf or nan: the largest float."""
    return v if math.isfinite(v) else sys.float_info.max


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float = T0):
    """One run of `cell` on `device`: (result dict, {number: (value,
    limit)}).  The caller has checked the device."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    entries = cell.per_layer if traced else cell.e2e
    readers = {m["name"]: spec.metric(m["name"], cell.root) for m in entries}
    cfg = spec.program_config(cell.config)
    ref_cfg = from_groups(cell.config["groups"])
    loop = spec.kind(cell.traffic["kind"]).Loop(
        cfg, ref_cfg, cell.traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    before = _counters(readers.values())
    limit_calls = cell.traffic["trace_calls"] if traced else None
    lat, attempted, failed = [], 0, 0
    with trace.profiled(traced, device) as prof:
        start = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            with trace.span("call"):
                a, f = loop.call(len(lat))
            c1 = time.perf_counter()
            lat.append(c1 - c0)
            attempted += a
            failed += f
            if c1 - start >= seconds or len(lat) == limit_calls:
                break
    window_s = c1 - start
    after = _counters(readers.values())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = trace.summarize(prof) if traced else None
    # what the metric readers read of the run
    run = SimpleNamespace(
        cell=cell.name, seed=seed, setup_s=setup_s, window_s=window_s,
        calls=len(lat), latencies_s=lat, attempted=attempted, failed=failed,
        ok=attempted - failed,
        counters={k: after[k] - before[k] for k in after},
        stats=loop.stats(), trace=summary, traffic=cell.traffic)

    metrics = {}
    for m in entries:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    loop.release()
    if cuda:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    values = loop.check()
    print(f"check_s {time.perf_counter() - c0:.3f}", file=sys.stderr)
    checks = {k: (values[k], cell.limits[k]) for k in cell.limits}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": _number(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        from benchmark.yardstick import card_line
        print(f"card: {card_line()}; torch {torch.__version__}",
              file=sys.stderr)
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        print(f"card: {torch.cuda.get_device_name(0)} (nvidia-smi: {e})",
              file=sys.stderr)

    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
