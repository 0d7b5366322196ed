"""BASELINE config 2: constant external force with tube-tightened
constraints, on the port.

Runs the full pipeline step (references, tubes, corridors, tightening,
solve: engine/pipeline.py::nmpc_step, B = 1 of the batched step; on the
card the tube, corridor and IPM kernels) under a constant disturb-manager
style wind, and shows how much the corridor rows tightened.  f32 on the
card, as the JAX example; f64 on the CPU.

Run: python -m forces_resilient_planner_tpu_torch.examples.config2_constant_force
     [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.engine.pipeline import nmpc_step
from forces_resilient_planner_tpu_torch.solver.problems import (
    hover_warm_start,
)

WIND = (1.2, -0.5, 0.2)      # constant wind [m/s^2]
K = 128                      # path samples


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    x0 = np.zeros(9)
    x0[2] = 1.2
    Z = hover_warm_start(t(x0), C.model)
    mpc_output = torch.cat([Z, Z[-1:]])
    s = np.arange(K) * C.model.dt
    path = np.stack([1.5 * s, np.zeros(K), np.full(K, 1.2)], -1)
    res = nmpc_step(
        mpc_output, t(path), t(K, torch.int64), t(0.0), t(x0), t(WIND),
        t(path[-1]), torch.zeros((64, 3), dtype=dtype, device=device),
        torch.zeros(64, dtype=torch.bool, device=device),
        t(False, torch.bool), cfg=C,
    )
    print(f"exit={int(res.exit_code)} iters={int(res.iters)}")
    tighten = (res.corridor_b - res.corridor_b_tight).double().cpu().numpy()
    rows = res.corridor_A.double().norm(dim=-1).cpu().numpy() > 1e-9
    print(f"tube tightening margin: mean {tighten[rows].mean():.3f} m, "
          f"max {tighten[rows].max():.3f} m (grows along horizon)")
    E = res.tube_E.double().cpu()
    r0, r1 = (float(torch.linalg.matrix_norm(E[i], 2)) for i in (0, -1))
    print("stage-0 vs stage-19 ellipsoid radius:", r0, "->", r1)
    return {"exit": int(res.exit_code), "iters": int(res.iters),
            "tighten": tighten[rows], "radii": (r0, r1)}


if __name__ == "__main__":
    main()
