"""Where a closed-loop tick's time goes on the card: torch.profiler over
the fleet (engine/fleet.py, the JAX bench's B = 128 workload of
engine/workloads.py) and over one robot's planner ticks.

    python3 -m forces_resilient_planner_tpu_torch.tools.closed_loop_probe \
        [--ticks 20] [--top 12]

Warms up with a short fleet run, then runs `--ticks` fleet ticks (the
first a replan) once bare and once under the profiler, and prints the wall
time per tick, the device's busy time (the sum of its kernels' durations)
and its idle share of the bare run, the kernel launches per tick, and the
kernels with the most device time and the operators with the most host
time; then the same for one robot's DEFAULT_CONFIG closed loop
(engine/planner.py), per MPC tick.  Needs an NVIDIA GPU; the card's name and power limit head the
output.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu_torch.engine import (
    fleet,
    planner,
    simulator,
    workloads,
)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _report(label, prof, wall_s, bare_s, units, unit_name, top):
    """wall_s: the profiled run; bare_s: the same run without the profiler,
    against which the idle share is taken."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    print(f"{label}: wall {1e3 * bare_s / units:.2f} ms per {unit_name} "
          f"({1e3 * wall_s / units:.2f} profiled), device busy "
          f"{1e3 * busy_s / units:.2f} ms per {unit_name} (idle share "
          f"{1 - busy_s / bare_s:.3f} of the unprofiled wall), "
          f"{len(kernels) / units:.0f} kernel launches per {unit_name}")
    avg = prof.key_averages()
    # device: the kernels alone (an aten operator's row repeats its kernels')
    kern = [e for e in avg if not e.key.startswith(("aten::", "cuda"))]
    for rows, key, name in ((kern, _device_us, "device (kernels)"),
                            (avg, lambda e: e.self_cpu_time_total, "host")):
        rows = sorted(rows, key=key, reverse=True)[:top]
        print(f"  top {name} time per {unit_name}: " + "; ".join(
            f"{e.key[:48]} {key(e) / 1e3 / units:.3f} ms "
            f"({e.count / units:.1f}x)" for e in rows))


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _profile(fn):
    """fn once without the profiler (warm), once under it: (profile,
    profiled seconds, bare seconds, the profiled run's output)."""
    bare, _ = _timed(fn)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, out = _timed(fn)
    return prof, wall, bare, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("closed_loop_probe needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(f"card: {_card()}; torch {torch.__version__}", flush=True)

    cfg = workloads.fleet_cfg()
    grid, obs, mask = workloads.fleet_scene(cfg, torch.float32, device=dev)
    starts, goals, f_true = workloads.fleet_lanes(workloads.FLEET_B)

    def fly(duration):
        return fleet.run_fleet(cfg, grid, obs, mask, starts, goals, f_true,
                               duration, workloads.FLEET_REPLAN_EVERY)

    fly(0.5)
    ticks = args.ticks
    prof, wall, bare, _ = _profile(lambda: fly(ticks * cfg.model.dt))
    _report(f"fleet B={workloads.FLEET_B} f32, {ticks} ticks", prof, wall,
            bare, ticks, "tick", args.top)

    def robot():
        p = planner.ResilientPlanner(DEFAULT_CONFIG, dtype=torch.float32,
                                     device=dev)
        x0 = np.zeros(9)
        x0[2] = 1.2
        sim = simulator.QuadSim(DEFAULT_CONFIG.model, x0.copy(), np.zeros(3))
        p.on_odometry(x0)
        simulator.run_closed_loop(p, sim, [2.0, 0.5], 1.0)
        return p

    robot()
    prof, wall, bare, p = _profile(robot)
    _report("one robot DEFAULT_CONFIG f32, 1.0 s closed loop (its search "
            "included)", prof, wall, bare, max(p.diag.solves, 1), "MPC tick",
            args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
