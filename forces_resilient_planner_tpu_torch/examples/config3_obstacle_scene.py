"""BASELINE config 3: full obstacle scene (corridor sequence, kinodynamic
front-end, time-varying force), closed loop, on the port.  Dumps an HTML
scene and an animated replay.

One robot: engine/planner.py::ResilientPlanner flown by engine/
simulator.py::run_closed_loop through a fence's gap under a sinusoidal
wind, every MPC solve one nmpc_step (on the card the tube, corridor and
IPM kernels).  f32 on the card, f64 on the CPU (the JAX example runs f64
on the CPU: its loop is host-paced).

Run: python -m forces_resilient_planner_tpu_torch.examples.config3_obstacle_scene
     [--device cpu] [--out-dir .]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.engine.planner import ResilientPlanner
from forces_resilient_planner_tpu_torch.engine.simulator import (
    QuadSim,
    run_closed_loop,
)
from forces_resilient_planner_tpu_torch.utils.scene import (
    dump_replay,
    dump_scene,
)

GOAL = [3.5, 0.0]
DURATION = 7.0      # seconds flown


def fence():
    """The fence at x = 1.5 with its gap at y in (-0.2, 1.6)."""
    ys = np.arange(-3, 3, 0.1)
    zs = np.arange(0, 2.6, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.full(yy.size, 1.5), yy.ravel(), zz.ravel()], -1)
    return pts[~((pts[:, 1] > -0.2) & (pts[:, 1] < 1.6))]


def wind(t):
    return np.array([0.8 * np.sin(0.5 * t), 0.0, 0.0])   # time-varying


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    C = workloads.closed_loop_cfg()
    planner = ResilientPlanner(C, max_cloud=2048, dtype=dtype, device=device)
    x0 = np.zeros(9)
    x0[2] = 1.2
    sim = QuadSim(C.model, x0.copy(), np.zeros(3))
    planner.on_odometry(x0)
    planner.set_occupied(fence())

    trace = run_closed_loop(planner, sim, GOAL, duration=DURATION,
                            force_schedule=wind, record_plans=True)
    final = trace["pos"][-1]
    print("final position:", np.round(final, 3),
          "| solves:", planner.diag.solves,
          "| replans:", planner.diag.replans)
    out_dir = Path(args.out_dir)
    meta = {"solves": planner.diag.solves, "final": final.tolist()}
    obstacles = planner.obstacles[planner.obstacle_mask][:800]
    out = dump_scene(
        out_dir / "scene_config3.html",
        traj=trace["pos"][:: len(trace["pos"]) // 200 + 1],
        ref=planner.kino_path[: planner.kino_size],
        goal=planner.end_pt,
        obstacles=obstacles,
        kino_path=planner.kino_path[: planner.kino_size],
        meta=meta,
    )
    # animated replay (play button + scrubber): the rviz-session analog
    dump_replay(out_dir / "replay_config3.html", trace, planner.end_pt,
                obstacles=obstacles, meta=meta)
    print("scene dumped to", out)
    return {"final": final, "solves": planner.diag.solves,
            "replans": planner.diag.replans, "trace": trace,
            "planner": planner}


if __name__ == "__main__":
    main()
