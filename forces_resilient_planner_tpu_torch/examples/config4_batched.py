"""BASELINE config 4: 4096 parallel NMPC solves (goal x wind x corridor) on
one card, on the port: the bench's scenario grid with diagnostics.

Every monotone IPM iteration of the grid is one launch of the IPM kernel
(K1) over all lanes; a compile-free first solve on the card still pays the
kernels' build at first use (ops/_build.py) and the CUDA context.

Run: python -m forces_resilient_planner_tpu_torch.examples.config4_batched
     [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.engine import batch as bm

HALVES = np.array([[5.0, 5.0, 2.0]])
N_GOALS, N_FORCES = 256, 16


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else device)
    rng = np.random.default_rng(0)
    goals = rng.uniform([-3, -3, 1.0], [3, 3, 1.6], (N_GOALS, 3))
    forces = rng.uniform(-1.5, 1.5, (N_FORCES, 3))
    scen = bm.make_scenarios(C, goals, forces, HALVES, dtype=torch.float32,
                             device=device)
    print("batch:", scen.batch)

    t0 = time.perf_counter()
    res = bm.solve_scenarios(scen, C)
    _sync(device)
    print(f"build+first solve: {time.perf_counter() - t0:.1f} s")

    rng2 = np.random.default_rng(1)
    scen2 = bm.make_scenarios(
        C, rng2.uniform([-3, -3, 1.0], [3, 3, 1.6], (N_GOALS, 3)),
        rng2.uniform(-1.5, 1.5, (N_FORCES, 3)), HALVES,
        dtype=torch.float32, device=device)
    _sync(device)
    t0 = time.perf_counter()
    res = bm.solve_scenarios(scen2, C)
    ec = res.exit_code.cpu().numpy()
    dt = time.perf_counter() - t0
    stats = bm.sweep_stats(res)
    print(f"steady solve: {dt * 1e3:.1f} ms -> {scen.batch / dt:.0f} "
          "solves/s")
    # "solved" is exit code 1; the JAX example printed the mean exit code,
    # which the negative failure codes (-6, -7) make wrong
    print(f"solved {(ec == 1).mean() * 100:.1f}% | mean iters "
          f"{float(stats.mean_iters):.1f} | max kkt (solved) "
          f"{float(stats.max_kkt_solved):.1e}")
    return {"exit_codes": ec, "iters": res.iters.cpu().numpy(),
            "Z": res.Z.double().cpu().numpy()}


if __name__ == "__main__":
    main()
