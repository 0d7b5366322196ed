"""NMPC-step traffic: back-to-back calls of the full step (references,
tubes, corridors, tightening, solve), either one batched call of
engine/pipeline_batch.py::nmpc_step_batched over `robots` robots or, with
robots = 1, engine/pipeline.py::nmpc_step for one robot.  Every call's
exit codes and first commands (stage 0's four controls) are read back to
the host.  Attempted: robot-steps; failed: exit code != 1.  A call's
time is not judged here: latency_p95_ms reads it.

The scenes follow chip_smoke.py::step_inputs at commit ad340bc (the
bench's full-step workload with each robot varied), drawn on the device
from the seed: hover at x0 on a straight kinodynamic path of path_samples
samples at path_velocity; per robot its own cloud of `cloud` points
uniform in [obs_low, obs_high], points with |y| < gap_y moved by
gap_shift in y; f_ext uniform in [-force_bound, force_bound]^3; t_offset
uniform in [0, t_offset_max]; every final_every-th robot (index mod
final_every = final_every - 1) on the final profile; its previous plan the
hover plan plus N(0, deque_noise).  A pool of `pool` such sets (robots =
1: `pool` robots in one set) is made in set-up and cycled through; the
step keeps no state between calls.

The reference follows the program's corridors: it checks its own
references, tubes and decomposition against the program's, and solves the
problem built from its references and its tightening of the program's
selected corridors.

Traffic parameters: robots, pool, path_samples, path_velocity, x0,
cloud, obs_low, obs_high, gap_y, gap_shift, force_bound, t_offset_max,
final_every, deque_noise, warm_calls, check_calls, check_robots (robots of
each checked call), chunk (robots per reference block), trace_calls.
"""
from __future__ import annotations


import numpy as np
import torch

from benchmark.reference import solver as ref_solver
from benchmark.reference import step as ref_step
from benchmark.sample import Reservoir, worst
from benchmark.trace import span

KEYS = ("mpc_output", "kino_path", "kino_size", "t_offset", "state_mpc",
        "f_ext", "end_pt", "obstacles", "obstacle_mask", "use_final")
DIRECT = ("mpc_output", "exit_code", "tube_E", "corridor_A", "corridor_b")
OUTS = DIRECT + ("ref_pos", "ref_yaw")
ROW_TOL = 1e-3   # a corridor row differs when an entry moves by more


def scene_set(t, cfg, B, gen, dtype, device) -> dict:
    """One set of B robots' step inputs, drawn with the device generator."""
    m = cfg.model
    N, K, M = m.N, t["path_samples"], t["cloud"]

    def uniform(shape, low, high):
        low = torch.as_tensor(low, dtype=dtype, device=device)
        high = torch.as_tensor(high, dtype=dtype, device=device)
        return low + (high - low) * torch.rand(shape, generator=gen,
                                               dtype=dtype, device=device)

    x0 = torch.as_tensor(t["x0"], dtype=dtype, device=device)
    Z = ref_solver.hover_warm_start(x0, m, N)
    plan = torch.cat([Z, Z[-1:]], dim=0)
    times = torch.arange(K, dtype=dtype, device=device) * m.dt
    v = torch.as_tensor(t["path_velocity"], dtype=dtype, device=device)
    path = v * times[:, None] + x0[None, 0:3] * torch.tensor(
        [0.0, 0.0, 1.0], dtype=dtype, device=device)
    obs = uniform((B, M, 3), t["obs_low"], t["obs_high"])
    near = obs[..., 1:2].abs() < t["gap_y"]
    obs = torch.where(near, obs + torch.tensor([0.0, t["gap_shift"], 0.0],
                                               dtype=dtype, device=device),
                      obs)
    noise = torch.randn((B, N + 1, 17), generator=gen, dtype=dtype,
                        device=device) * t["deque_noise"]
    fb = t["force_bound"]
    idx = torch.arange(B, device=device)
    return {
        "mpc_output": plan[None] + noise,
        "kino_path": path[None].expand(B, K, 3).contiguous(),
        "kino_size": torch.full((B,), K, dtype=torch.int64, device=device),
        "t_offset": uniform((B,), 0.0, t["t_offset_max"]),
        "state_mpc": x0[None].expand(B, 9).contiguous(),
        "f_ext": uniform((B, 3), -fb, fb),
        "end_pt": path[-1][None].expand(B, 3).contiguous(),
        "obstacles": obs,
        "obstacle_mask": torch.ones((B, M), dtype=torch.bool, device=device),
        "use_final": idx % t["final_every"] == t["final_every"] - 1,
    }


class Loop:
    def __init__(self, cfg, ref_cfg, traffic, seed, device):
        from forces_resilient_planner_tpu_torch.engine import (
            pipeline,
            pipeline_batch,
        )

        self.cfg, self.ref_cfg, self.t = cfg, ref_cfg, traffic
        self.device = torch.device(device)
        self.single = traffic["robots"] == 1
        self.step = pipeline.nmpc_step if self.single else \
            pipeline_batch.nmpc_step_batched
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed % 2 ** 63)
        if self.single:
            self.pool = [scene_set(traffic, ref_cfg, traffic["pool"], gen,
                                   torch.float32, self.device)]
        else:
            self.pool = [scene_set(traffic, ref_cfg, traffic["robots"], gen,
                                   torch.float32, self.device)
                         for _ in range(traffic["pool"])]
        self.pick = np.random.default_rng([seed, 1])
        self.samples = Reservoir(traffic["check_calls"], self.pick)
        for i in range(traffic["warm_calls"]):
            self._program(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _where(self, i):
        """(set index, row) of call i's inputs: row None = the whole set."""
        if self.single:
            return 0, i % self.t["pool"]
        return i % len(self.pool), None

    def _program(self, i):
        s, row = self._where(i)
        a = self.pool[s]
        if row is not None:
            a = {k: v[row] for k, v in a.items()}
        return self.step(*(a[k] for k in KEYS), cfg=self.cfg)

    def call(self, i):
        with span("program"):
            res = self._program(i)
        with span("readback"):
            out = res.mpc_output.reshape(-1, *res.mpc_output.shape[-2:])
            ec = res.exit_code.reshape(-1)
            host = torch.cat([out[:, 0, 0:4], ec[:, None].to(out.dtype)],
                             dim=1).cpu().numpy()
        with span("sample"):
            self.samples.offer(lambda: self._record(i, res))
        return host.shape[0], int((host[:, 4] != 1).sum())

    def _rows(self):
        return np.sort(self.pick.choice(self.t["robots"],
                                        self.t["check_robots"], replace=False))

    def _record(self, i, res):
        s, row = self._where(i)
        fields = {k: getattr(res, k) for k in DIRECT}
        fields.update(ref_pos=res.ref.ref_pos, ref_yaw=res.ref.ref_yaw)
        if row is not None:
            rows = np.array([row])
            outs = {k: v[None] for k, v in fields.items()}
        else:
            rows = self._rows()
            idx = torch.as_tensor(rows, device=self.device)
            outs = {k: v.index_select(0, idx) for k, v in fields.items()}
        return dict(set=s, rows=rows, **outs)

    def stats(self):
        return {}

    def release(self):
        self.step = None

    def _inputs(self, dtype, samples):
        """The sampled robots' inputs, in `dtype` for the floats."""
        out = {}
        for k in KEYS:
            v = torch.cat([self.pool[s["set"]][k].index_select(
                0, torch.as_tensor(s["rows"], device=self.device))
                for s in samples])
            out[k] = v.to(dtype) if v.is_floating_point() else v
        return out

    def _reference(self, a, dtype, A_sel=None, b_sel=None):
        """The reference's step of inputs `a` in `dtype`: its references,
        tubes and corridors, and its solve with the corridors A_sel, b_sel
        (its own where None) tightened by its tubes."""
        cfg = self.ref_cfg
        m = cfg.model
        N = m.N
        prev = a["mpc_output"]
        refs = ref_step.sample_references(
            a["kino_path"], a["kino_size"], a["t_offset"], prev[:, 1, 16],
            prev[:, 1, 8:11], N, m.dt)
        E = ref_step.tubes(prev[:, :N], m, cfg.tube)
        A_own, b_own = ref_step.corridors(refs, E, a["obstacles"],
                                          a["obstacle_mask"], cfg)
        A = A_own if A_sel is None else A_sel.to(dtype)
        b = b_own if b_sel is None else b_sel.to(dtype)
        w_n = ref_solver.stage_weights(cfg.weights, N, False, dtype,
                                       prev.device)
        w_f = ref_solver.stage_weights(cfg.weights, N, True, dtype,
                                       prev.device)
        fin = a["use_final"].reshape(-1, 1)
        prob = ref_solver.Problem(
            xinit=prev[:, 1, 8:17], ref_pos=refs.ref_pos,
            ref_yaw=refs.ref_yaw, f_ext=a["f_ext"], corridor_A=A,
            corridor_b=ref_step.tighten(A, b, E),
            weights=ref_solver.StageWeights(*(
                torch.where(fin, f[None], n[None]) for n, f in zip(w_n, w_f))))
        sol = ref_solver.solve(prev[:, 1:N + 1], prob, m, cfg.solver)
        return dict(ref_pos=refs.ref_pos, ref_yaw=refs.ref_yaw, tube_E=E,
                    corridor_A=A_own, corridor_b=b_own, Z=sol.Z,
                    exit_code=sol.exit_code)

    def check(self):
        """The sampled robots stepped again by the reference at float64 in
        blocks of `chunk` robots: the widest gap of the references and of
        the tubes, the share of (robot, stage) whose selected corridor
        differs from the reference's by more than ROW_TOL in any entry, and
        from the solve of the program's corridors the share of exit codes
        that differ and the widest gap between the plan's controls the step
        returned and the reference's solve, over the robots the reference
        solved (exit code 1).  Left out of that gap: a robot the step
        answered as it must answer a solve it rejects, with an exit code
        other than 1 and its previous plan returned unchanged; the exit
        codes' share counts it."""
        samples = self.samples.kept
        a = self._inputs(torch.float64, samples)
        p = {k: torch.cat([s[k] for s in samples]) for k in OUTS}
        N = self.ref_cfg.model.N
        ref_gap, tube_gap, differ, mism, du = [], [], [], [], []
        n = a["mpc_output"].shape[0]
        for c in range(0, n, self.t["chunk"]):
            sl = slice(c, c + self.t["chunk"])
            ac = {k: v[sl] for k, v in a.items()}
            pc = {k: v[sl].to(torch.float64) if v.is_floating_point()
                  else v[sl] for k, v in p.items()}
            r = self._reference(ac, torch.float64, pc["corridor_A"],
                                pc["corridor_b"])
            ref_gap.append(max(
                (pc["ref_pos"] - r["ref_pos"]).abs().max().item(),
                (pc["ref_yaw"] - r["ref_yaw"]).abs().max().item()))
            tube_gap.append((pc["tube_E"] - r["tube_E"]).abs().max().item())
            row = torch.maximum(
                (pc["corridor_A"] - r["corridor_A"]).abs().amax(dim=(-2, -1)),
                (pc["corridor_b"] - r["corridor_b"]).abs().amax(dim=-1))
            differ.append((row > ROW_TOL).cpu().numpy().ravel())
            ec, ec_r = pc["exit_code"], r["exit_code"]
            mism.append((ec != ec_r).cpu().numpy())
            plan = pc["mpc_output"][:, :N]
            gap = (plan[..., 0:4] - r["Z"][:, :, 0:4]).abs().amax(dim=(1, 2))
            kept = (plan == ac["mpc_output"][:, :N]).all(dim=-1).all(dim=-1)
            answered = (ec_r == 1) & ~((ec != 1) & kept)
            du.append(gap[answered].cpu().numpy())
        return {"ref_gap": worst(ref_gap), "tube_gap": worst(tube_gap),
                "corridor_differ_share": float(np.concatenate(differ).mean()),
                "exit_mismatch_share": float(np.concatenate(mism).mean()),
                "du_max": worst(np.concatenate(du))}

    def control(self, dtype):
        """check() of the reference in `dtype` put in the program's place
        (its own corridors, its solve returned for every robot whatever
        its exit code: a solve in a lower precision never meets the
        solver's tolerances, so the step's rule would answer every robot
        with its previous plan and leave no gap to read), on the calls a
        window would sample first, in blocks of `chunk` robots."""
        recs = [dict(set=s, rows=np.array([row]) if self.single
                     else self._rows())
                for s, row in map(self._where,
                                  range(self.t["check_calls"]))]
        a = self._inputs(dtype, recs)
        parts = []
        n = a["mpc_output"].shape[0]
        for c in range(0, n, self.t["chunk"]):
            ac = {k: v[c:c + self.t["chunk"]] for k, v in a.items()}
            r = self._reference(ac, dtype)
            r["mpc_output"] = torch.cat([r["Z"], r["Z"][:, -1:]], dim=1)
            parts.append(r)
        out = {k: torch.cat([r[k] for r in parts]) for k in OUTS}
        self.samples = Reservoir(len(recs), self.pick)
        at = 0
        for rec in recs:
            k = len(rec["rows"])
            rec.update({f: v[at:at + k] for f, v in out.items()})
            at += k
            self.samples.offer(lambda: rec)
        return self.check()
