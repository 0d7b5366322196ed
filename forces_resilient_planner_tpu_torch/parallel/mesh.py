"""Scale-out of scenario sweeps over torch.distributed (torch).

Port of forces_resilient_planner_tpu/parallel/mesh.py.  The reference is a
single-process planner; scale-out is the sharded sweep (SURVEY.md section
2.4): the scenario batch is split over the ranks of a (host, chip) device
mesh, every rank solves its slice with the single-card tiered lane-major
solve (tier compaction rank-local), and only the sweep statistics cross
ranks, as all-reduces; `gather_results` brings the answers to rank 0.

One process per rank.  The caller initializes the default process group
first (`init_group`), with the backend that follows the device: NCCL for
"cuda", gloo for "cpu".  There is no fallback from one to the other.

Spans (utils/trace.py): `sweep` (all of monte_carlo_sweep), `sweep.expand`
(sweep_scenarios and shard_scenarios), `sweep.solve` (the rank's
solve_scenarios), `sweep.reduce` (all_reduce_stats), `sweep.gather`
(gather_results up to its host read, where rank 0 waits for the slowest
rank).
"""
from __future__ import annotations

from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from forces_resilient_planner_tpu_torch.config import PlannerConfig
from forces_resilient_planner_tpu_torch.engine import batch as batch_mod
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.utils import trace

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_group(device_type: str, init_method: str, world_size: int,
               rank: int, timeout: timedelta | None = None) -> None:
    """Join the default process group with the device's backend (a "cuda"
    rank first takes card rank % device_count).  `timeout` bounds the
    rendezvous and each collective (None: torch's default)."""
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("a cuda rank needs a card; none is visible")
        torch.cuda.set_device(rank % cards)
    dist.init_process_group(BACKENDS[device_type], init_method=init_method,
                            world_size=world_size, rank=rank, timeout=timeout)


def fold_shape(n: int, n_axes: int = 2) -> tuple:
    """n ranks folded into (n,) or two axes as square as possible, the
    outer one the smaller (the JAX module's fold)."""
    if n_axes == 1:
        return (n,)
    best = 1
    for d in range(1, int(np.sqrt(n)) + 1):
        if n % d == 0:
            best = d
    return (best, n // best)


def make_mesh(shape: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("host", "chip"), *,
              device_type: str) -> DeviceMesh:
    """DeviceMesh over every rank of the default group, ranks laid out
    host-major in `shape` (default: fold_shape of the world size)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: "
                           "call init_group first")
    n = dist.get_world_size()
    shape = tuple(shape) if shape is not None else fold_shape(
        n, len(axis_names))
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shard lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_index(mesh: DeviceMesh) -> int:
    """This rank's position in the host-major order of the mesh, the
    position of its slice of P(("host", "chip"))."""
    return int(np.ravel_multi_index(mesh.get_coordinate(),
                                    tuple(mesh.mesh.shape)))


def shard_scenarios(scen: batch_mod.ScenarioSet,
                    mesh: DeviceMesh) -> batch_mod.ScenarioSet:
    """This rank's contiguous slice of the scenario axis, on its device.
    Every rank builds the same set from the same seeds."""
    n, B = mesh.size(), scen.batch
    if B % n:
        raise ValueError(f"{B} scenarios do not split over {n} ranks")
    lo = shard_index(mesh) * (B // n)
    dev = mesh_device(mesh)

    def take(a):
        return a[lo:lo + B // n].contiguous().to(dev)

    return batch_mod.ScenarioSet(
        Z0=take(scen.Z0), params=ipm_lanes._map_params(take, scen.params))


def all_reduce_stats(res) -> batch_mod.SweepStats:
    """The sweep statistics of the union of every rank's results: sums for
    n and n_solved, the means from all-reduced sums, the max of
    max_kkt_solved.  Every rank gets the same values, on its result's
    device (the ranks of a mesh are the whole default group)."""
    local = batch_mod.sweep_stats(res)
    dev = res.exit_code.device
    sums = torch.stack([
        local.n.double(), local.n_solved.double(),
        res.iters.double().sum(),
        (res.Z[:, :, 0:4].double() ** 2).sum(),
    ]).to(dev)
    kkt = local.max_kkt_solved.clone()
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    dist.all_reduce(kkt, op=dist.ReduceOp.MAX)
    f32 = torch.float32
    return batch_mod.SweepStats(
        n=sums[0].to(f32), n_solved=sums[1].to(f32),
        mean_iters=(sums[2] / sums[0]).to(f32),
        max_kkt_solved=kkt,
        mean_cost=(sums[3] / sums[0]).to(res.Z.dtype),
    )


def make_sharded_solver(cfg: PlannerConfig, mesh: DeviceMesh):
    """fn(local_scen) -> (local SolveResult, SweepStats across the mesh).

    Each rank runs the tiered lane-major solve on its own slice (the
    single-card throughput path, tier compaction rank-local); only the
    statistics cross ranks."""
    del mesh  # the statistics reduce over the default group the mesh spans

    def run(local_scen: batch_mod.ScenarioSet):
        with trace.span("sweep.solve"):
            res = batch_mod.solve_scenarios(local_scen, cfg)
        with trace.span("sweep.reduce"):
            return res, all_reduce_stats(res)

    return run


def sweep_scenarios(cfg: PlannerConfig, n_ranks: int, n_goals: int,
                    n_forces: int, n_corridors: int = 1, seed: int = 0,
                    dtype=torch.float32, *, device) -> batch_mod.ScenarioSet:
    """BASELINE config 5's scenario set (the JAX module's draws), padded by
    repeating its first scenarios to a multiple of n_ranks."""
    rng = np.random.default_rng(seed)
    goals = rng.uniform([-4, -4, 1.0], [4, 4, 1.6], (n_goals, 3))
    forces = rng.uniform(-2.0, 2.0, (n_forces, 3))
    halves = np.tile(np.array([[6.0, 6.0, 2.0]]), (n_corridors, 1))
    scen = batch_mod.make_scenarios(cfg, goals, forces, halves, dtype=dtype,
                                    device=device)
    pad = (-scen.batch) % n_ranks
    if not pad:
        return scen

    def padded(a):
        return torch.cat([a, a[:pad]], dim=0)

    return batch_mod.ScenarioSet(
        Z0=padded(scen.Z0), params=ipm_lanes._map_params(padded, scen.params))


def monte_carlo_sweep(cfg: PlannerConfig, mesh: DeviceMesh, n_goals: int,
                      n_forces: int, n_corridors: int = 1, seed: int = 0,
                      dtype=torch.float32):
    """BASELINE config-5 shape: a Monte-Carlo resilience sweep over the
    mesh.  Every rank expands the whole set and keeps its slice.  Returns
    (this rank's SolveResult, SweepStats of the whole set)."""
    with trace.span("sweep"):
        with trace.span("sweep.expand"):
            scen = sweep_scenarios(cfg, mesh.size(), n_goals, n_forces,
                                   n_corridors, seed, dtype,
                                   device=mesh_device(mesh))
            local = shard_scenarios(scen, mesh)
        return make_sharded_solver(cfg, mesh)(local)


def gather_results(res):
    """Every rank's exit codes and iteration counts, in shard order, on
    rank 0's host: (exit_code (B,), iters (B,)) CPU tensors there, None on
    the other ranks.  One all_gather of the stacked [exit_code, iters];
    every rank of the default group takes part."""
    with trace.span("sweep.gather"):
        local = torch.stack([res.exit_code, res.iters])
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local)
        if dist.get_rank() != 0:
            return None
        host = torch.cat(parts, dim=1).cpu()
    return host[0], host[1]
