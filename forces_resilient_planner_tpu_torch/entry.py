"""Entry points of the port (the analog of the repo's
__graft_entry__.py, whose inputs and caps are copied here).

entry(device=None)  -> (fn, example_args): one full NMPC pipeline step
                       (references -> tubes -> corridors -> interior-point
                       solve) of one robot at f32, engine/pipeline.py::
                       nmpc_step at workloads.small_cfg's caps.
dryrun_multichip(n) -> n ranks (one process each, torch.distributed over
                       a (host, chip) device mesh) run the batched pipeline
                       step on their shards of a 2n-robot batch at tiny
                       caps; the gathered output is checked for its shape
                       and for every rank's slice.

device None means the card ("cuda"); there is no fallback to the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from forces_resilient_planner_tpu_torch.engine import pipeline_batch
from forces_resilient_planner_tpu_torch.engine.pipeline import nmpc_step
from forces_resilient_planner_tpu_torch.engine.workloads import small_cfg
from forces_resilient_planner_tpu_torch.parallel import mesh as pm
from forces_resilient_planner_tpu_torch.solver.problems import (
    hover_warm_start,
)

KEYS = pipeline_batch.PIPELINE_ARG_KEYS


def example_inputs(cfg, dtype, batch=None, *, device) -> dict:
    """__graft_entry__._example_inputs: hover at (0, 0, 1.2), a 64-sample
    straight path, 256 obstacles from default_rng(0) kept clear of the
    path's lane; `batch` tiles every field along a new leading axis."""
    x0 = np.zeros(9)
    x0[2] = 1.2
    Z = hover_warm_start(torch.as_tensor(x0, dtype=dtype), cfg.model).numpy()
    K = 64
    t = np.arange(K) * cfg.model.dt
    path = np.stack([1.2 * t, 0.3 * t, np.full(K, 1.2)], -1)
    M = 256
    rng = np.random.default_rng(0)
    obs = rng.uniform([-1, -3, 0], [5, 3, 2.5], (M, 3))
    obs = np.where(np.abs(obs[:, 1:2]) < 0.8, obs + np.array([0, 2.0, 0]), obs)
    args = dict(
        mpc_output=np.concatenate([Z, Z[-1:]], axis=0),
        kino_path=path, kino_size=np.asarray(K), t_offset=np.asarray(0.0),
        state_mpc=x0, f_ext=np.array([0.5, -0.2, 0.0]), end_pt=path[-1],
        obstacles=obs, obstacle_mask=np.ones(M, bool),
        use_final=np.asarray(False),
    )
    if batch is not None:
        args = {k: np.tile(np.asarray(v)[None], (batch,) + (1,) * np.ndim(v))
                for k, v in args.items()}
    return pipeline_batch.pipeline_inputs_from_numpy(args, dtype=dtype,
                                                     device=device)


def entry(*, device=None):
    """(fn, example_args): fn(*example_args) -> (mpc_output (N+1, 17),
    exit_code, kkt_error) of one f32 pipeline step on `device`."""
    cfg = small_cfg()
    device = torch.device("cuda" if device is None else device)

    def fn(mpc_output, kino_path, kino_size, t_offset, state_mpc, f_ext,
           end_pt, obstacles, obstacle_mask, use_final):
        res = nmpc_step(
            mpc_output, kino_path, kino_size, t_offset, state_mpc, f_ext,
            end_pt, obstacles, obstacle_mask, use_final, cfg=cfg,
        )
        return res.mpc_output, res.exit_code, res.kkt_error

    args = example_inputs(cfg, torch.float32, device=device)
    return fn, tuple(args[k] for k in KEYS)


def dryrun_cfg():
    """__graft_entry__.dryrun_multichip's tiny caps: small_cfg with 12 IPM
    iterations, 64 obstacles and 4 shrink rounds."""
    cfg = small_cfg()
    return dataclasses.replace(
        cfg,
        solver=dataclasses.replace(cfg.solver, max_iters=12),
        corridor=dataclasses.replace(cfg.corridor, max_obstacles=64,
                                     shrink_iters=4),
    )


def dryrun_step(mesh) -> dict:
    """One rank's part of the dry run on an initialized mesh: its 2 robots
    of the 2n batch stepped on its device, the outputs all-gathered, the
    shape and this rank's slice checked.  Returns a report."""
    cfg = dryrun_cfg()
    n = mesh.size()
    batch = 2 * n
    dev = pm.mesh_device(mesh)
    args = example_inputs(cfg, torch.float32, batch=batch, device="cpu")
    lo = 2 * pm.shard_index(mesh)
    local = [args[k][lo:lo + 2].to(dev) for k in KEYS]
    out = pipeline_batch.nmpc_step_batched(*local, cfg=cfg).mpc_output
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out)
    full = torch.cat(parts)
    shape = (batch, cfg.model.N + 1, 17)
    if tuple(full.shape) != shape:
        raise RuntimeError(f"dry run output {tuple(full.shape)} != {shape}")
    if not (torch.equal(full[lo:lo + 2], out) and bool(out.isfinite().all())):
        raise RuntimeError(f"rank {dist.get_rank()}: its slice is missing "
                           "from the gathered output or not finite")
    return {"batch": batch, "shape": list(shape), "ranks": n,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "device": str(dev)}


def _dryrun_rank(rank, world, device_type, init_method, out_dir):
    pm.init_group(device_type, init_method, world, rank)
    try:
        report = dryrun_step(pm.make_mesh(device_type=device_type))
        if rank == 0:
            Path(out_dir, "report.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, *, device_type=None,
                     timeout: float = 600.0) -> dict:
    """Spawn n_devices ranks (one card each on "cuda", the default) that
    step the batched pipeline on their shards; raises when a rank fails,
    when fewer cards than ranks are present, or after `timeout` seconds."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards, have "
                           f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as d:
        ctx = torch.multiprocessing.spawn(
            _dryrun_rank,
            args=(n_devices, device_type, f"file://{d}/rendezvous", d),
            nprocs=n_devices, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(
                    f"dryrun_multichip: {n_devices} ranks not done in "
                    f"{timeout} s")
        report = json.loads(Path(d, "report.json").read_text())
    print(f"dryrun_multichip OK: batch {report['batch']} sharded over "
          f"{n_devices} ranks (mesh {report['mesh']}, {device_type})")
    return report


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
