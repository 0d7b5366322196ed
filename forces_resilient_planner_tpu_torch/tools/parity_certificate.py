"""The port's parity certificate on the card against the independent oracle.

Port of the JAX package's tools/tpu_parity_check.py (its box, fence and
oracle stages, :58-322 and :541-710): the solver path the bench runs, at
f32 through the IPM kernel (K1), is re-solved lane by lane by the f64
SLSQP oracle (oracle/cpu_oracle.py), which shares no code with the
interior-point solver, over two workload families:

  box    bench lanes of the grid's first three timed seed sets (1000-1002,
         B = 4096, engine/workloads.py::bench_config's tiers);
  fence  corridor-rich scenes (engine/scenarios.py::corridor_scenarios:
         ellipsoid decompositions against a staggered double fence, B =
         128, seed 42), built at f64 on the CPU and cast to f32 for the
         card's solve, as the JAX tool does.

Hard lanes first (the most iterations), topped up with an even spread of
the solved lanes: 8 a seed set and 12 fence lanes, 36 in all.  Each is
re-solved by oracle/pool.py::certify (multi-start) in a pool of CPU
processes, and max |u_card - u_oracle| <= 1e-3 is asserted over the
4 x 20 control sequence.  The stages run in one process (the JAX tool
split them into subprocesses only because of XLA).

The pipeline family (`pipeline_audit`, also chip_smoke.py phases 7 and
10): 128 raw fence lanes (`pipeline_lanes`: the cloud in generic position,
no precomputed corridors) through nmpc_step_batched on the card (K1, K2,
K3), audited at f64 on the CPU: obstacle penetration into every tightened
polytope, the accepted trajectories' corridor violation, and the card's
own NLP re-solved by the plain solver at f64.  Controls are not compared
through the corridor generator: its argmin ties flip planes between any
two implementations (PARITY.md).

Writes PARITY_H100.json (the fields of PARITY_TPU.json, the card's name
and power limit); PARITY_TPU.json is the TPU record and is not touched.

    python -m forces_resilient_planner_tpu_torch.tools.parity_certificate
        [--device cuda] [--out PARITY_H100.json] [--workers N]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import (
    DEFAULT_CONFIG,
    PlannerConfig,
)
from forces_resilient_planner_tpu_torch.engine import (
    batch,
    pipeline_batch,
    scenarios,
    workloads,
)
from forces_resilient_planner_tpu_torch.oracle import pool as oracle_pool
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.solver.nlp import NLPParams

ROOT = Path(__file__).resolve().parents[2]
BOX_SEEDS = (1000, 1001, 1002)   # the JAX bench's first timed seed sets
BOX_LANES_PER_SET = 8
FENCE_B, FENCE_SEED, FENCE_LANES = 128, 42, 12
TOL = 1e-3
PIPE_B, PIPE_K, PIPE_M = 128, 64, 256


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's label when the run is on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def pick_lanes(ec: np.ndarray, it: np.ndarray, n: int) -> np.ndarray:
    """Hard lanes first (most iterations), topped up with an even spread;
    solved lanes only, none when nothing solved (tpu_parity_check.py:
    _pick_lanes)."""
    solved_idx = np.flatnonzero(ec == 1)
    if solved_idx.size == 0:
        return solved_idx
    hard = solved_idx[np.argsort(it[solved_idx])[::-1][:n]]
    spread = solved_idx[np.linspace(0, len(solved_idx) - 1, n).astype(int)]
    return np.concatenate([hard, np.setdiff1d(spread, hard)])[:n]


class Lane(NamedTuple):
    """One certificate lane: the card's controls and the lane's f64 NLP."""
    family: str          # "box<seed>" or "fence"
    lane: int
    u: np.ndarray        # (N, 4) the card's f32 controls, as f64
    iters: int
    params: NLPParams    # the lane's problem at f64 on the CPU
    cfg: PlannerConfig
    seed: int            # the oracle's random starts


def _lanes(family, res, params64, cfg, n, seed0):
    ec = res.exit_code.cpu().numpy()
    it = res.iters.cpu().numpy()
    sel = pick_lanes(ec, it, n)
    u = res.Z[:, :, 0:4].double().cpu().numpy()
    lanes = [Lane(family, int(i), u[i], int(it[i]),
                  ipm_lanes._map_params(lambda a, i=i: a[int(i)], params64),
                  cfg, seed0 + int(i)) for i in sel]
    return lanes, float((ec == 1).mean())


def box_lanes(seed: int, n: int, device):
    """The bench grid of `seed` solved on `device` at f32 with the bench
    tiers; its n picked lanes and its solved fraction."""
    cfg = workloads.bench_config()
    g, f = workloads.bench_seeds(seed)
    res = batch.solve_scenario_grid(cfg, g, f, workloads.HALVES,
                                    dtype=torch.float32, device=device)
    scen64 = batch.make_scenarios(cfg, g, f, workloads.HALVES,
                                  dtype=torch.float64, device="cpu")
    return _lanes(f"box{seed}", res, scen64.params, cfg, n, 10_000)


def fence_lanes(n: int, device):
    """The fence scenes built at f64 on the CPU, solved on `device` at
    f32; their n picked lanes and the solved fraction."""
    cfg = scenarios.PARITY_SCENE_CFG
    scen64 = scenarios.corridor_scenarios(cfg, FENCE_B, torch.float64,
                                          seed=FENCE_SEED, device="cpu")
    scen32 = batch.ScenarioSet(
        Z0=scen64.Z0.to(device, torch.float32).contiguous(),
        params=ipm_lanes._map_params(
            lambda a: a.to(device, torch.float32).contiguous(),
            scen64.params))
    res = batch.solve_scenarios(scen32, cfg)
    return _lanes("fence", res, scen64.params, cfg, n, 20_000)


def submit(pool, lanes):
    """Start the oracle's multi-start re-solve of every lane."""
    return [pool.submit(oracle_pool.certify, ln.params, ln.cfg.model,
                        ln.cfg.solver, ln.seed) for ln in lanes]


def collect(lanes, futures) -> list[dict]:
    """Per lane: max |du| against the card and the oracle's verdict."""
    out = []
    for ln, fut in zip(lanes, futures):
        r = fut.result()
        out.append(dict(family=ln.family, lane=ln.lane, iters=ln.iters,
                        du=float(np.abs(r["u"] - ln.u).max()),
                        status=r["status"], tries=r["tries"],
                        feas=float(r["feas"]), stat=float(r["stat"]),
                        seconds=r["seconds"]))
    return out


def summary(records: list[dict], solved_fracs: dict, oracle_wall_s: float,
            n_seed_sets: int) -> dict:
    """PARITY_TPU.json's fields over the certificate lanes."""
    if not records:
        return {"n_lanes": 0, "solved_fracs": solved_fracs, "pass": False,
                "error": "no solved lanes to certify"}
    du = np.array([r["du"] for r in records])
    ok = np.array([r["status"] == 0 for r in records])
    kkt_ok = np.array([r["feas"] <= oracle_pool.FEAS_TOL
                       and r["stat"] <= oracle_pool.STAT_TOL
                       for r in records])
    strict = ok | kkt_ok
    fence = np.array([r["family"] == "fence" for r in records])
    return {
        "n_lanes": int(du.size),
        "n_seed_sets": n_seed_sets,
        "solved_fracs": solved_fracs,
        "n_fence_lanes": int(fence.sum()),
        "n_oracle_converged": int(ok.sum()),
        "n_strict_lanes": int(strict.sum()),
        "max_feas_residual": max(r["feas"] for r in records),
        "max_stat_residual": max(r["stat"] for r in records),
        "max_u_diff": float(du.max()),
        "max_u_diff_strict_lanes": float(du[strict].max())
        if strict.any() else None,
        "max_u_diff_fence": float(du[fence].max()) if fence.any() else None,
        "p99_u_diff": float(np.percentile(du, 99)),
        "tol": TOL,
        "pass": bool(du.max() <= TOL),
        "batch_box": workloads.N_GOALS * workloads.N_FORCES,
        "batch_fence": FENCE_B,
        "config": "engine/workloads.py::bench_config() boxes + "
                  "PARITY_SCENE_CFG fence [f32 + K1 + tiers on the card vs "
                  "f64 SLSQP multi-start]",
        "oracle_wall_s": oracle_wall_s,
        "lanes": records,
    }


# ---------------------------------------------------------------------------
# the pipeline family
# ---------------------------------------------------------------------------

def pipeline_lanes(rng, B: int, K: int = PIPE_K, M: int = PIPE_M):
    """B fence lanes as raw nmpc_step_batched inputs (numpy, f64): one
    cloud of M fence points jittered by +-3 cm into generic position (the
    raw fence is a regular grid whose tied distances flip the corridor's
    plane choices under any change of arithmetic), K path samples; the
    path, goal and force distribution of corridor_scenarios
    (tpu_parity_check.py:build_pipeline_lanes)."""
    mcfg = DEFAULT_CONFIG.model
    N = mcfg.N
    obs_np = scenarios.fence_scene()
    sel = rng.choice(len(obs_np), size=M, replace=False)
    obstacles = obs_np[sel] + rng.uniform(-0.03, 0.03, (M, 3))
    x0 = np.zeros(9)
    x0[2] = 1.2
    goals = rng.uniform([3.8, -2.0, 1.0], [4.5, 2.0, 1.6], (B, 3))
    forces = rng.uniform(-1.0, 1.0, (B, 3))
    gap1 = np.stack(
        [np.full(B, 1.5), rng.uniform(0.2, 1.0, B), np.full(B, 1.2)], -1)
    wp = np.stack([np.tile(x0[:3], (B, 1)), gap1,
                   np.tile([3.0, -0.6, 1.2], (B, 1)), goals], axis=1)
    seg = np.linalg.norm(np.diff(wp, axis=1), axis=-1)
    cum = np.concatenate([np.zeros((B, 1)), np.cumsum(seg, axis=1)], axis=1)
    v_ref = rng.uniform(1.0, 1.9, (B, 1))
    s = np.minimum(np.arange(K)[None] * mcfg.dt * v_ref, cum[:, -1:])
    kino_path = np.stack([
        np.stack([np.interp(s[b], cum[b], wp[b, :, k]) for k in range(3)],
                 -1)
        for b in range(B)], 0)
    kino_size = np.minimum(
        np.ceil(cum[:, -1] / (mcfg.dt * v_ref[:, 0])).astype(int) + 1, K)
    hover = np.zeros((N, 17))
    hover[:, 3] = hover[:, 7] = mcfg.hover_thrust
    hover[:, 8:17] = x0
    mpc_output = np.tile(np.concatenate([hover, hover[-1:]], 0)[None],
                         (B, 1, 1))
    return dict(
        mpc_output=mpc_output, kino_path=kino_path, kino_size=kino_size,
        t_offset=np.zeros(B), state_mpc=np.tile(x0[None], (B, 1)),
        f_ext=forces, end_pt=goals,
        obstacles=np.tile(obstacles[None], (B, 1, 1)),
        obstacle_mask=np.ones((B, M), bool), use_final=np.zeros(B, bool),
    )


def pipeline_audit(res, inputs, cfg, lanes=64, chunk=128):
    """The f64 audit of a batched step's output (tpu_parity_check.py:
    438-530) on the CPU: the max obstacle penetration into the tightened
    polytopes and the number of (robot, stage) penetrated, the accepted
    trajectories' max corridor violation, and the card's NLP of the first
    `lanes` robots re-solved by the port's plain solver at f64: the robots
    solved by both and their max |du|."""
    N = cfg.model.N
    A = res.corridor_A.double().cpu()
    bt = res.corridor_b_tight.double().cpu()
    obs = inputs["obstacles"].double().cpu()
    mask = inputs["obstacle_mask"].cpu()
    ec = res.exit_code.cpu()
    out = res.mpc_output.double().cpu()
    act = A.norm(dim=-1) > 1e-9
    max_pen, n_pen = 0.0, 0
    for i in range(0, A.shape[0], chunk):
        sl = slice(i, i + chunk)
        s = torch.einsum("bnkj,bmj->bnmk", A[sl], obs[sl]) - bt[sl, :, None]
        s = torch.where(act[sl, :, None], s, -torch.inf)
        depth = torch.where(mask[sl, None], -s.amax(dim=-1), -torch.inf)
        pen = depth.clamp(min=0.0)
        max_pen = max(max_pen, pen.max().item())
        n_pen += int((pen.amax(dim=-1) > 0).sum())
    solved = ec == 1
    pos = out[:, :N, 8:11]
    viol = torch.einsum("bnkj,bnj->bnk", A, pos) - bt
    viol = torch.where(act, viol, -torch.inf)[solved]
    max_viol = viol.max().item() if solved.any() else float("-inf")

    sl = slice(0, lanes)
    inp = {k: v[sl].cpu() for k, v in inputs.items()}
    prev = inp["mpc_output"].double()
    ref64 = type(res.ref)(*(t[sl].double().cpu() for t in res.ref))
    params = pipeline_batch.pack_nlp_params(
        ref64, A[sl], bt[sl], inp["f_ext"].double(), prev, inp["use_final"],
        cfg)
    r64 = ipm_lanes.solve_batch_lanes_tiered(
        prev[:, 1:N + 1], params, cfg.model, cfg.solver)
    both = (r64.exit_code == 1) & solved[sl]
    du = (r64.Z[:, :, 0:4] - out[sl, :N, 0:4]).abs().amax(dim=(1, 2))
    du_max = du[both].max().item() if both.any() else float("inf")
    return max_pen, n_pen, max_viol, int(both.sum()), du_max


def pipeline_family(device) -> dict:
    """The pipeline family's section: PIPE_B raw fence lanes through
    nmpc_step_batched at f32 on `device`, audited at f64."""
    cfg = DEFAULT_CONFIG
    t0 = time.perf_counter()
    inputs = pipeline_batch.pipeline_inputs_from_numpy(
        pipeline_lanes(np.random.default_rng(4242), PIPE_B),
        dtype=torch.float32,
        device=device)
    res = pipeline_batch.nmpc_step_batched(
        *[inputs[k] for k in pipeline_batch.PIPELINE_ARG_KEYS], cfg=cfg)
    solved = (res.exit_code == 1).double().mean().item()
    pen, n_pen, viol, n_both, du = pipeline_audit(res, inputs, cfg,
                                                  lanes=PIPE_B)
    return {
        "n_lanes": PIPE_B, "solved": solved,
        "corridor_max_obstacle_penetration_m": pen,
        "corridor_stages_penetrated": n_pen,
        "max_traj_corridor_violation": viol,
        "corridor_slack": cfg.solver.corridor_slack,
        "resolve_f64_n_both": n_both, "resolve_f64_max_u_diff": du,
        "pass": bool(pen == 0.0 and viol <= 1e-4 and n_both > 0
                     and du <= TOL),
        "wall_s": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "PARITY_H100.json"))
    ap.add_argument("--workers", type=int, default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    card = card_line(dev)
    t0 = time.perf_counter()
    lanes, solved_fracs = [], {}
    for seed in BOX_SEEDS:
        key = f"box{seed}"
        got, solved_fracs[key] = box_lanes(seed, BOX_LANES_PER_SET, dev)
        lanes += got
        print(f"[card] box seed {seed}: solved {solved_fracs[key]:.6f}, "
              f"lanes {[ln.lane for ln in got]}", flush=True)
    got, solved_fracs["fence"] = fence_lanes(FENCE_LANES, dev)
    lanes += got
    print(f"[card] fence B={FENCE_B}: solved {solved_fracs['fence']:.6f}, "
          f"lanes {[ln.lane for ln in got]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t1 = time.perf_counter()
    with oracle_pool.make_pool(args.workers) as pool:
        futures = submit(pool, lanes)
        pipe = pipeline_family(dev)
        print(f"[pipeline] {json.dumps(pipe)}", flush=True)
        records = collect(lanes, futures)
    for r in records:
        print(f"[oracle] {r['family']} lane {r['lane']}: max|du| "
              f"{r['du']:.2e} status {r['status']} tries {r['tries']} feas "
              f"{r['feas']:.1e} stat {r['stat']:.1e} ({r['seconds']:.1f} s)",
              flush=True)
    result = summary(records, solved_fracs, time.perf_counter() - t1,
                     len(BOX_SEEDS))
    result["pipeline"] = pipe
    result.update(card=card, device=str(dev), torch=torch.__version__,
                  cuda=torch.version.cuda, wall_s=time.perf_counter() - t0)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "lanes"}),
          flush=True)
    return 0 if result["pass"] and pipe["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
