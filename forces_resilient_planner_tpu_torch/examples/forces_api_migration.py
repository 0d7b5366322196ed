"""Migration example: driving the port's solver through the FORCES Pro surface.

A user of the reference talks to the generated solver via flat structs
(xinit / x0 / all_parameters) packed by FORCESNormal::solveNormal
(forces_normal.cpp:55-140).  This example packs the exact same layout,
tube tightening included (E from the disturbance tubes with the fixed
feedback gain passed explicitly), and solves it with the port's
interior-point solver on the card (B = 1 of the lane-major solver, every
monotone iteration one launch of the IPM kernel).

Run: python -m forces_resilient_planner_tpu_torch.examples.forces_api_migration
     [--device cpu] [--dtype float32]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.solver import forces_api as fapi
from forces_resilient_planner_tpu_torch.solver.problems import (
    box_corridor,
    hover_warm_start,
)
from forces_resilient_planner_tpu_torch.tube import lyapunov

X0 = np.array([0, 0, 1.2, 0, 0, 0, 0, 0, 0], float)
GOAL = np.array([2.0, 1.0, 1.2])
WIND = np.array([0.5, 0.0, 0.0])


def migration_params(*, device) -> fapi.ForcesParams:
    """The example's packed problem: hover at (0, 0, 1.2) to GOAL under a
    wind estimate, a 5 x 5 x 2 m box corridor tightened by the tubes of the
    hover warm start (computed at f64 on `device`)."""
    params = fapi.ForcesParams()
    params.xinit[:] = X0                      # stage-1 prediction in real use
    fapi.set_stage_weights(
        params,
        C.weights.w_stage_wp, C.weights.w_stage_input,
        C.weights.w_input_rate,
        C.weights.w_terminal_wp, C.weights.w_terminal_input,
    )
    A, b = box_corridor(0.5 * (X0[:3] + GOAL), np.array([5.0, 5.0, 2.0]),
                        fapi.N, device="cpu")
    Z_prev = hover_warm_start(
        torch.as_tensor(X0, dtype=torch.float64, device=device), C.model)
    K = torch.as_tensor(C.tube.K, dtype=torch.float64, device=device)
    E = lyapunov.propagate_tubes(Z_prev, C.model, C.tube, K).E
    yaw = np.arctan2(GOAL[1] - X0[1], GOAL[0] - X0[0])
    fapi.pack_stage_params(
        params,
        ref_pos=np.tile(GOAL[None], (fapi.N, 1)),
        ref_yaw=np.full(fapi.N, yaw),
        external_acc=WIND,
        corridor_A=A.numpy(), corridor_b=b.numpy(),
        tube_E=E.cpu().numpy(),
    )
    fapi.pack_warm_start(params, Z_prev.cpu().numpy())
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float64", "float32"),
                    default="float64")
    args = ap.parse_args(argv)
    params = migration_params(device=args.device)
    solver = fapi.ForcesSolver("normal", dtype=getattr(torch, args.dtype),
                               device=args.device)
    output, exitflag, info = solver.solve(params)
    print(f"exitflag={exitflag} ({fapi.EXIT_NAMES.get(exitflag)}) "
          f"it={info.it} solvetime={info.solvetime * 1e3:.3f}ms "
          f"res_eq={info.res_eq:.2e} pobj={info.pobj:.6f}")
    for k in (1, 10, 20):
        z = output[f"x{k:02d}"]
        print(f"  x{k:02d}: pos=({z[8]:+.3f},{z[9]:+.3f},{z[10]:+.3f}) "
              f"thrust={z[3]:.2f}")
    if exitflag != fapi.OPTIMAL:
        raise SystemExit(f"exitflag {exitflag}")
    return output, exitflag, info


if __name__ == "__main__":
    main()
