"""FORCES-API traffic: back-to-back calls of solver/forces_api.py::
ForcesSolver(profile, cfg, float32).solve, one packed hover-to-goal
problem a call, cycling through a pool made in set-up.  A call returns
the solution, the exit flag and the info struct on the host.  Attempted:
calls; failed: exit flag != 1.  A call's time is not judged here:
latency_p95_ms reads it.

Each problem: from hover at x0 to a goal drawn as bench_seeds draws goals
(engine/workloads.py at commit ad340bc) under a force drawn as it draws
forces, a box corridor of half-extents `halves` centred between start and
goal, packed into the FORCES structs (xinit, x0, all_parameters) as
examples/forces_api_migration.py packs them at commit ad340bc: the stage
weights of the profile, the goal as every stage's reference, the yaw
towards it, the rows tightened by the tubes of the hover plan (the
reference's tubes, computed once in float64), the hover plan as warm
start.

Traffic parameters: profile, pool, x0, goal_low, goal_high, force_bound,
halves, warm_calls, check_calls, trace_calls.
"""
from __future__ import annotations


import numpy as np
import torch

from benchmark.reference import solver as ref_solver
from benchmark.reference import step as ref_step
from benchmark.sample import Reservoir, worst
from benchmark.trace import span

NPRE = 10   # per-stage parameter block: [ref_pos, f_ext, weights, yaw, A, b]


def pack(t, cfg, goal, force, E) -> dict:
    """The FORCES structs of one problem (forces_normal.cpp:36-137)."""
    m, w = cfg.model, cfg.weights
    N, nh = m.N, m.nh
    x0 = np.asarray(t["x0"], dtype=np.float64)
    final = t["profile"] == "final"
    ap = np.zeros((N, NPRE + 4 * nh))
    if final:
        ap[:, 6:9] = (w.w_final_stage_wp, w.w_final_stage_input,
                      w.w_input_rate)
        ap[N - 1, 6:8] = (w.w_final_terminal_wp, w.w_final_terminal_input)
    else:
        ap[:, 6:9] = (w.w_stage_wp, w.w_stage_input, w.w_input_rate)
        ap[N - 1, 6:8] = (w.w_terminal_wp, w.w_terminal_input)
    A = np.zeros((nh, 3))
    b = np.zeros(nh)
    center, half = 0.5 * (x0[:3] + goal), np.asarray(t["halves"])
    for k in range(3):
        A[2 * k, k], b[2 * k] = 1.0, center[k] + half[k]
        A[2 * k + 1, k], b[2 * k + 1] = -1.0, -(center[k] - half[k])
    A = np.broadcast_to(A, (N, nh, 3))
    shrink = np.linalg.norm(np.einsum("nij,nkj->nki", E, A), axis=-1)
    active = np.linalg.norm(A, axis=-1) > 0
    ap[:, 0:3] = goal
    ap[:, 3:6] = force
    ap[:, 9] = np.arctan2(goal[1] - x0[1], goal[0] - x0[0])
    ap[:, NPRE:NPRE + 3 * nh] = A.reshape(N, 3 * nh)
    ap[:, NPRE + 3 * nh:] = np.where(active, b - shrink, 0.0)
    Z = np.concatenate([np.tile([0.0, 0.0, 0.0, m.hover_thrust], 2), x0])
    return {"xinit": x0.copy(), "x0": np.tile(Z, N),
            "all_parameters": ap.reshape(-1)}


def unpack(structs, cfg, final, dtype, device):
    """(Z0 (B, N, 17), Problem) of packed problems: frozen copy, taken at
    commit ad340bc, of solver/forces_api.py::unpack_params, batched."""
    m, w = cfg.model, cfg.weights
    N, nh = m.N, m.nh
    ap = np.stack([s["all_parameters"] for s in structs]).reshape(
        -1, N, NPRE + 4 * nh)
    w_wp, w_in, w_rate = ap[:, :, 6], ap[:, :, 7], ap[:, :, 8]
    w_vel = np.zeros_like(w_wp)
    if final:
        w_vel[:, -1] = w.final_brake_factor * w_wp[:, -1]
    w_up0 = np.zeros_like(w_wp)
    w_up0[:, 0] = w.stage1_uprev_factor * w_in[:, 0]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    prob = ref_solver.Problem(
        xinit=t(np.stack([s["xinit"] for s in structs])),
        ref_pos=t(ap[:, :, 0:3]), ref_yaw=t(ap[:, :, 9]),
        f_ext=t(ap[:, 0, 3:6]),
        corridor_A=t(ap[:, :, NPRE:NPRE + 3 * nh].reshape(-1, N, nh, 3)),
        corridor_b=t(ap[:, :, NPRE + 3 * nh:]),
        weights=ref_solver.StageWeights(*(t(a) for a in (
            w_wp, w_in, w_rate, w_vel, w_up0))))
    Z0 = t(np.stack([s["x0"] for s in structs]).reshape(-1, N, 17))
    return Z0, prob


class Loop:
    def __init__(self, cfg, ref_cfg, traffic, seed, device):
        from forces_resilient_planner_tpu_torch.solver import forces_api

        self.cfg, self.ref_cfg, self.t = cfg, ref_cfg, traffic
        self.device = torch.device(device)
        self.final = traffic["profile"] == "final"
        m = ref_cfg.model
        x0 = torch.as_tensor(traffic["x0"], dtype=torch.float64,
                             device=self.device)
        E = ref_step.tubes(ref_solver.hover_warm_start(x0, m, m.N)[None], m,
                           ref_cfg.tube)[0].cpu().numpy()
        rng = np.random.default_rng([seed, 0])
        fb = traffic["force_bound"]
        self.structs = [
            pack(traffic, ref_cfg,
                 rng.uniform(traffic["goal_low"], traffic["goal_high"]),
                 rng.uniform(-fb, fb, 3), E)
            for _ in range(traffic["pool"])]
        self.params = [forces_api.ForcesParams(**s) for s in self.structs]
        self.solver = forces_api.ForcesSolver(
            traffic["profile"], cfg, torch.float32, device=self.device)
        self.samples = Reservoir(traffic["check_calls"],
                                 np.random.default_rng([seed, 1]))
        for i in range(traffic["warm_calls"]):
            self.solver.solve(self.params[i % len(self.params)])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def call(self, i):
        j = i % len(self.params)
        with span("program"):
            out, flag, _ = self.solver.solve(self.params[j])
        with span("sample"):
            self.samples.offer(lambda: dict(
                problem=j, Z=np.stack([out[f"x{k + 1:02d}"]
                                       for k in range(len(out))]),
                flag=flag))
        return 1, int(flag != 1)

    def stats(self):
        return {}

    def release(self):
        self.solver = None

    def check(self):
        """Every sampled call's problem solved again by the reference at
        float64: the share whose exit flags differ, and the widest gap
        between the controls returned and the reference's, over the
        problems the reference solved."""
        kept = self.samples.kept
        Z0, prob = unpack([self.structs[s["problem"]] for s in kept],
                          self.ref_cfg, self.final, torch.float64,
                          self.device)
        ref = ref_solver.solve(Z0, prob, self.ref_cfg.model,
                               self.ref_cfg.solver)
        ec_r = ref.exit_code.cpu().numpy()
        flag = np.array([s["flag"] for s in kept])
        u = np.stack([s["Z"][:, 0:4] for s in kept])
        gap = np.abs(u - ref.Z[:, :, 0:4].cpu().numpy()).max(axis=(1, 2))
        return {"exit_mismatch_share": float(np.mean(flag != ec_r)),
                "du_max": worst(gap[ec_r == 1])}

    def control(self, dtype):
        """check() of the reference in `dtype` put in the program's place,
        on the first check_calls calls of a window."""
        n = min(self.t["check_calls"], 4 * len(self.structs))
        idx = [i % len(self.structs) for i in range(n)]
        Z0, prob = unpack([self.structs[j] for j in idx], self.ref_cfg,
                          self.final, dtype, self.device)
        sol = ref_solver.solve(Z0, prob, self.ref_cfg.model,
                               self.ref_cfg.solver)
        Z = sol.Z.to(torch.float64).cpu().numpy()
        ec = sol.exit_code.cpu().numpy()
        self.samples = Reservoir(n, np.random.default_rng(0))
        for k, j in enumerate(idx):
            self.samples.offer(lambda: dict(problem=j, Z=Z[k], flag=int(ec[k])))
        return self.check()
