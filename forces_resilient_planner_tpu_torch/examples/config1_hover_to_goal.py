"""BASELINE config 1: single hover-to-goal NMPC, zero force, box corridor,
on the port.

Solves the N = 20 NLP once (B = 1 of the lane-major solver: on the card
every monotone iteration is one launch of the IPM kernel) and, with
--oracle, certifies the solution against the independent SLSQP re-solve
(oracle/cpu_oracle.py, CPU, f64).  f32 on the card, f64 on the CPU and
with --oracle, as the JAX example.

Run: python -m forces_resilient_planner_tpu_torch.examples.config1_hover_to_goal
     [--device cpu] [--oracle]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.solver.problems import (
    hover_to_goal_params,
    hover_warm_start,
)

GOAL = np.array([1.5, 0.8, 1.2])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--oracle", action="store_true",
                    help="cross-check against the SLSQP oracle (CPU, f64)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    dtype = (torch.float64 if device.type == "cpu" or args.oracle
             else torch.float32)
    x0 = np.zeros(9)
    x0[2] = 1.2
    p = hover_to_goal_params(x0, GOAL, C.model, C.weights, dtype=dtype,
                             device=device)
    Z0 = hover_warm_start(torch.as_tensor(x0, dtype=dtype, device=device),
                          C.model)
    res = ipm_lanes.solve_batch_lanes_tiered(
        Z0[None], ipm_lanes._map_params(lambda a: a[None], p), C.model,
        C.solver)
    Z = res.Z[0].double().cpu().numpy()
    print(f"exit={int(res.exit_code[0])} iters={int(res.iters[0])} "
          f"kkt={float(res.kkt_error[0]):.2e}")
    print("u0 =", np.round(Z[0, :4], 4))
    print("terminal pos =", np.round(Z[-1, 8:11], 4))
    out = {"exit": int(res.exit_code[0]), "iters": int(res.iters[0]), "Z": Z}
    if args.oracle:
        from forces_resilient_planner_tpu_torch.oracle.cpu_oracle import (
            solve_oracle,
        )
        threads = torch.get_num_threads()
        torch.set_num_threads(1)    # 84-wide operations: threads only cost
        try:
            Zo, _ = solve_oracle(p, C.model, C.solver)
        finally:
            torch.set_num_threads(threads)
        out["oracle_err"] = float(np.max(np.abs(Z[:, :4] - Zo[:, :4])))
        print(f"control parity vs oracle: {out['oracle_err']:.2e} "
              "(target < 1e-3)")
    return out


if __name__ == "__main__":
    main()
