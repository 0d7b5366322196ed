"""BASELINE config 5: 100k+ scenario Monte-Carlo resilience sweep with
chunk checkpointing and kill/resume recovery, on the port.

Default scale: 25 chunks x 4096 scenarios (256 goals x 16 forces) =
102,400 solves, the "100k+ scenario sweep" of BASELINE.json configs[4], on
one card.  Every chunk is checkpointed as it lands (utils/checkpoint.py,
npz), so a killed job resumes from the last completed chunk, the
capability the reference lacks (SURVEY.md section 5).

Streamed path (default): the chunks go through engine/batch.py's grid
solve (the body of solve_scenario_stream) one after another: the solver's
host loop reads a flag from the card every IPM iteration, so chunk k+1 is
not dispatched before chunk k finishes.  There is no overlap; the
steady-state rate is the chunks after the first.
Mesh path (--mesh): --ranks processes, one card each on "cuda" (NCCL),
CPU ranks over gloo, solve each chunk's set of parallel/mesh.py::
monte_carlo_sweep; rank 0 checkpoints the gathered chunk.

The summary (aggregate and steady-state solves/s, resilience rate, exit-
code fractions, iterations) is printed as one JSON line and written to
--out when given; the JAX example's MC_SWEEP.json is not touched.

  python -m forces_resilient_planner_tpu_torch.examples.config5_monte_carlo
  ... --chunks 4 --device cpu --goals 8              # a small CPU run
  ... --mesh --ranks 2 --device cpu --chunks 2 --goals 4
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu_torch.engine import batch as bm
from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.parallel import mesh as pm
from forces_resilient_planner_tpu_torch.solver.forces_api import EXIT_NAMES
from forces_resilient_planner_tpu_torch.utils.checkpoint import (
    SweepCheckpointer,
)

ROOT = Path(__file__).resolve().parents[2]
HALVES = np.array([[5.0, 5.0, 2.0]])


def chunk_seeds(chunk: int, n_goals: int, n_forces: int):
    """Deterministic per-chunk scenario seeds (disjoint across chunks)."""
    rng = np.random.default_rng(777_000 + chunk)
    goals = rng.uniform([-3, -3, 1.0], [3, 3, 1.6], (n_goals, 3))
    forces = rng.uniform(-1.5, 1.5, (n_forces, 3))
    return goals, forces


def summarize(ck, chunks, wall_s, n_resumed, out=None, extra=None):
    """Aggregate the chunk checkpoints into the sweep summary."""
    ecs, iters = [], []
    for c in chunks:
        ec, it = ck.load_chunk(c, device="cpu")
        ecs.append(ec.numpy())
        iters.append(it.numpy())
    ec = np.concatenate(ecs)
    it = np.concatenate(iters)
    summary = {
        "n_scenarios": int(ec.size),
        "n_chunks": len(chunks),
        "resilience_rate": float((ec == 1).mean()),
        "exit_code_fracs": {
            name: float((ec == code).mean())
            for code, name in EXIT_NAMES.items()
        },
        "mean_iters": float(it.mean()),
        "max_iters": int(it.max()),
        "iters_p99": float(np.percentile(it, 99)),
        "wall_s": wall_s,
        # aggregate rate of this process's chunks, first-call set-up
        # included; steady_state_solves_per_s is the sustained figure
        "solves_per_s": ((len(chunks) - n_resumed) * ec.size / len(chunks)
                         / wall_s if wall_s > 0 else None),
        "resumed_chunks": int(n_resumed),
        **(extra or {}),
    }
    if out:
        Path(out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return summary


def _save(ck, chunk, ec, it):
    ck.save_chunk(chunk, (ec, it))
    print(f"chunk {chunk}: solved {float((ec == 1).float().mean()):.4f}",
          flush=True)


def run_streamed(args, cfg, ck, done):
    """One chunk after another on one device, each checkpointed as it
    lands.  Returns (wall s, steady-state solves/s or None)."""
    todo = [c for c in range(args.chunks) if c not in done]
    if not todo:
        return 0.0, None
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    t_first = None
    for c in todo:
        g, f = chunk_seeds(c, args.goals, args.forces)
        r = bm.solve_scenario_grid(cfg, g, f, HALVES, device=dev)
        _save(ck, c, r.exit_code, r.iters)
        if t_first is None:
            t_first = time.perf_counter()
    wall = time.perf_counter() - t0
    steady = None
    if len(todo) > 1:
        per = (time.perf_counter() - t_first) / (len(todo) - 1)
        steady = args.goals * args.forces / per
        print(f"steady-state: {steady:.1f} solves/s ({per * 1e3:.3f} "
              "ms/chunk)", flush=True)
    return wall, steady


def _mesh_rank(rank, world, device_type, init_method, args, done):
    pm.init_group(device_type, init_method, world, rank)
    try:
        mesh = pm.make_mesh(device_type=device_type)
        ck = SweepCheckpointer(args.ckpt_dir)
        for chunk in range(args.chunks):
            if chunk in done:
                continue
            res, stats = pm.monte_carlo_sweep(
                DEFAULT_CONFIG, mesh, n_goals=args.goals,
                n_forces=args.forces, seed=1234 + chunk)
            parts = [[torch.empty_like(a) for _ in range(world)]
                     for a in (res.exit_code, res.iters)]
            dist.all_gather(parts[0], res.exit_code)
            dist.all_gather(parts[1], res.iters)
            if rank == 0:
                _save(ck, chunk, torch.cat(parts[0]), torch.cat(parts[1]))
                print(f"chunk {chunk}: n={int(stats.n)} "
                      f"solved={int(stats.n_solved)}", flush=True)
    finally:
        dist.destroy_process_group()


def run_mesh(args, ck, done):
    """The sharded path over --ranks processes.  Returns (wall s, None)."""
    device_type = torch.device(args.device).type
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.spawn(
            _mesh_rank,
            args=(args.ranks, device_type, f"file://{d}/rendezvous", args,
                  done),
            nprocs=args.ranks, join=True)
    return time.perf_counter() - t0, None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=25)
    ap.add_argument("--goals", type=int, default=workloads.N_GOALS)
    ap.add_argument("--forces", type=int, default=workloads.N_FORCES)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "mc_sweep_ckpt_torch"))
    ap.add_argument("--out", default=None, help="summary JSON file")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", action="store_true",
                    help="sharded path (parallel/mesh.py)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes of the --mesh path")
    ap.add_argument("--no-summary", action="store_true")
    args = ap.parse_args(argv)

    ck = SweepCheckpointer(args.ckpt_dir)
    done = ck.done_chunks()
    n_resumed = len([c for c in done if c < args.chunks])
    if n_resumed:
        print(f"resuming: {n_resumed}/{args.chunks} chunks checkpointed",
              flush=True)
    if args.mesh:
        wall, steady = run_mesh(args, ck, done)
    else:
        wall, steady = run_streamed(args, workloads.bench_config(), ck, done)
    if args.no_summary:
        return None
    dev = torch.device(args.device)
    return summarize(
        ck, list(range(args.chunks)), wall, n_resumed, out=args.out,
        extra={
            "chunk_batch": args.goals * args.forces,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev)),
            "mode": "mesh" if args.mesh else "streamed",
            "steady_state_solves_per_s": steady,
        },
    )


if __name__ == "__main__":
    main()
