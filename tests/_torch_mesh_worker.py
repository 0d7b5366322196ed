"""One rank of tests/test_torch_mesh.py's 2-rank gloo world.

Imports torch and the port only, never JAX.  Runs torch on one thread, as
tests/_torch_threads.py does for the in-process files (the suite's
parallel workers share the cores), joins the group through the file in
`init_method`, runs the sharded Monte-Carlo sweep and then the dry run's
rank step on the same mesh, and saves what it saw to out_dir/rank{r}.pt.
The group is destroyed in a finally."""
import sys

import torch
import torch.distributed as dist

from forces_resilient_planner_tpu_torch import entry
from forces_resilient_planner_tpu_torch.parallel import mesh as pm

SWEEP = dict(n_goals=4, n_forces=4, seed=7, dtype=torch.float64)


def run(rank, world, init_method, out_dir, cfg):
    torch.set_num_threads(1)
    pm.init_group("cpu", init_method, world, rank)
    try:
        mesh = pm.make_mesh(device_type="cpu")
        res, stats = pm.monte_carlo_sweep(cfg, mesh, **SWEEP)
        report = entry.dryrun_step(mesh)
        torch.save({
            "rank": rank, "shard": pm.shard_index(mesh),
            "mesh": tuple(mesh.mesh.shape), "res": tuple(res),
            "stats": tuple(stats), "dryrun": report,
            "jax_loaded": sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax.")
                                 or m.startswith("forces_resilient_planner_tpu.")),
        }, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
