"""Config 6: fleet-scale batched closed loop (engine/fleet.py), on the port.

B scenarios (start x goal x wind) flown simultaneously through the whole
stack (batched kinodynamic search, the batched step with the tube,
corridor and IPM kernels on the card, the device-side plant, per-lane fail
ladders) on one card: the Monte-Carlo shape the reference's one-robot
20 Hz loop cannot express.  The fleet's configuration, scene and lanes are
engine/workloads.py's (the JAX package's tools/fleet_probe.py and bench
fleet): f32 on the card, f64 on the CPU.  chip_smoke.py flies the
benchmarked B = 128.

Run: python -m forces_resilient_planner_tpu_torch.examples.config6_fleet
     [B] [duration] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from forces_resilient_planner_tpu_torch.engine import fleet, workloads


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", type=int, nargs="?", default=8)
    ap.add_argument("duration", type=float, nargs="?", default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    B, duration = args.B, args.duration
    cfg = workloads.fleet_cfg()
    grid, obs, mask = workloads.fleet_scene(cfg, dtype, device=device)
    starts, goals, f_true = workloads.fleet_lanes(B, seed=5)
    res = fleet.run_fleet(cfg, grid, obs, mask, starts, goals, f_true,
                          duration=duration, replan_every=10)
    print(
        f"fleet B={B}: reached {res.reached_frac:.2f} "
        f"collided {res.collided_frac:.3f} solver-success "
        f"{res.solved_frac:.3f} searches {res.searches} "
        f"wall {res.wall_s:.1f}s "
        f"(aggregate realtime x{B * duration / res.wall_s:.1f}) "
        f"outcomes={res.outcome_counts}"
    )
    return res


if __name__ == "__main__":
    main()
