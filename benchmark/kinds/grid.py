"""Scenario-grid traffic: back-to-back calls of engine/batch.py::
solve_scenario_grid, each on a fresh goal x force set drawn from the seed
(the distribution of bench_seeds, engine/workloads.py at commit ad340bc:
goals uniform in a box, forces uniform in a cube) over fixed corridor
boxes, every call's exit codes and iteration counts read back to the
host.  Attempted: scenarios; failed: exit code != 1.

Traffic parameters: goals, forces (per call), halves (box half-extents),
x0 (the start), goal_low / goal_high, force_bound, warm_calls,
check_calls (calls the reference checks), check_lanes (lanes of each),
trace_calls (calls of a traced window).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import grid as ref_grid
from benchmark.reference import solver as ref_solver
from benchmark.sample import Reservoir, worst
from benchmark.trace import span


class Loop:
    def __init__(self, cfg, ref_cfg, traffic, seed, device):
        from forces_resilient_planner_tpu_torch.engine import batch

        self.solve = batch.solve_scenario_grid
        self.cfg, self.ref_cfg, self.t, self.device = cfg, ref_cfg, traffic, \
            torch.device(device)
        self.x0 = np.asarray(traffic["x0"], dtype=np.float64)
        self.halves = np.asarray(traffic["halves"], dtype=np.float64)
        self.B = traffic["goals"] * traffic["forces"] * len(self.halves)
        self.rng = np.random.default_rng([seed, 0])
        self.pick = np.random.default_rng([seed, 1])
        self.samples = Reservoir(traffic["check_calls"], self.pick)
        self.iters_sum = self.lanes = 0
        warm = np.random.default_rng([seed, 2])
        for _ in range(traffic["warm_calls"]):
            self._program(*self._draw(warm))
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _draw(self, rng):
        t = self.t
        goals = rng.uniform(t["goal_low"], t["goal_high"], (t["goals"], 3))
        fb = t["force_bound"]
        return goals, rng.uniform(-fb, fb, (t["forces"], 3))

    def _program(self, goals, forces):
        return self.solve(self.cfg, goals, forces, self.halves, x0=self.x0,
                          dtype=torch.float32, device=self.device)

    def call(self, i):
        with span("pick"):
            goals, forces = self._draw(self.rng)
        with span("program"):
            res = self._program(goals, forces)
        with span("readback"):
            ec, it = torch.stack([res.exit_code, res.iters]).cpu().numpy()
        self.iters_sum += int(it.sum())
        self.lanes += self.B
        with span("sample"):
            self.samples.offer(lambda: self._record(goals, forces, res, ec))
        return self.B, int((ec != 1).sum())

    def _lanes(self):
        return np.sort(self.pick.choice(self.B, self.t["check_lanes"],
                                        replace=False))

    def _record(self, goals, forces, res, ec):
        lanes = self._lanes()
        idx = torch.as_tensor(lanes, device=res.Z.device)
        return dict(goals=goals, forces=forces, lanes=lanes,
                    u=res.Z.index_select(0, idx)[:, :, 0:4], ec=ec[lanes])

    def stats(self):
        N = self.cfg.model.N
        return dict(iters_sum=self.iters_sum, lanes=self.lanes, N=N,
                    nh=self.cfg.model.nh, itemsize=4)

    def release(self):
        self.solve = None

    def _problems(self, dtype, samples):
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        parts = [ref_grid.problems(self.ref_cfg, t(self.x0), t(s["goals"]),
                                   t(s["forces"]), t(self.halves),
                                   torch.as_tensor(s["lanes"],
                                                   device=self.device))
                 for s in samples]
        Z0 = torch.cat([p[0] for p in parts])
        prob = ref_solver.Problem(
            *(torch.cat([p[1][k] for p in parts]) for k in range(6)),
            weights=ref_solver.StageWeights(*(
                torch.cat([p[1].weights[k] for p in parts])
                for k in range(5))))
        return Z0, prob

    def check(self):
        """The sampled lanes solved again by the reference at float64: the
        share whose exit codes differ, and the widest gap between the
        controls returned and the reference's, over the lanes the
        reference solved."""
        samples = self.samples.kept
        Z0, prob = self._problems(torch.float64, samples)
        ref = ref_solver.solve(Z0, prob, self.ref_cfg.model,
                               self.ref_cfg.solver)
        ec_ref = ref.exit_code.cpu().numpy()
        ec = np.concatenate([s["ec"] for s in samples])
        u = torch.cat([s["u"] for s in samples]).to(torch.float64)
        solved = torch.as_tensor(ec_ref == 1, device=u.device)
        gap = (u - ref.Z[:, :, 0:4]).abs().amax(dim=(1, 2))[solved]
        return {"exit_mismatch_share": float(np.mean(ec != ec_ref)),
                "du_max": worst(gap.cpu().numpy())}

    def control(self, dtype):
        """check() of the reference in `dtype` put in the program's place,
        on calls drawn as a window draws them, solved in one batch."""
        recs = []
        for _ in range(self.t["check_calls"]):
            goals, forces = self._draw(self.rng)
            recs.append(dict(goals=goals, forces=forces, lanes=self._lanes()))
        Z0, prob = self._problems(dtype, recs)
        sol = ref_solver.solve(Z0, prob, self.ref_cfg.model,
                               self.ref_cfg.solver)
        ec = sol.exit_code.cpu().numpy()
        self.samples = Reservoir(len(recs), self.pick)
        at = 0
        for rec in recs:
            k = len(rec["lanes"])
            rec.update(u=sol.Z[at:at + k, :, 0:4], ec=ec[at:at + k])
            at += k
            self.samples.offer(lambda: rec)
        return self.check()
