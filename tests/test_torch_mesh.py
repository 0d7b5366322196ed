"""Port parity: parallel/mesh.py (sharded sweeps over torch.distributed)
and entry.py's dry run.

The analog of tests/test_sharding.py:25-52 and tests/test_multiprocess.py
on the CPU with gloo: a 2-rank world (spawned processes that import no
JAX, each with its own join timeout) runs the sharded Monte-Carlo sweep
of 16 scenarios and the dry run's rank step; each rank's results are held
bit-equal to the same lanes of one single-process solve of the identical
scenario set, and the all-reduced statistics to that solve's sweep_stats
(n, n_solved, max_kkt_solved exactly; means within 1e-6 relative).  Rank
0's gathered answers are held to the shards and the one-process solve, the
sweep's spans to one opening a sweep on each rank.  The
mesh fold and the scenario set are held to the JAX module's.  Every group
joins through a file in the test's tmp_path, never a fixed port."""
import dataclasses
import sys
import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mesh_worker as worker
from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as JC
from forces_resilient_planner_tpu.engine import batch as jb
from forces_resilient_planner_tpu.parallel import mesh as jm
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu_torch.engine import batch as tb
from forces_resilient_planner_tpu_torch.parallel import mesh as pm
from forces_resilient_planner_tpu_torch.solver import nlp as tn

CFG = dataclasses.replace(DEFAULT_CONFIG, solver=dataclasses.replace(
    DEFAULT_CONFIG.solver, max_iters=25))
JOIN_S = 120


def _spawn(fn, world, args):
    """Spawn `world` ranks; fail (and kill them) after JOIN_S seconds."""
    ctx = torch.multiprocessing.spawn(fn, args=(world, *args), nprocs=world,
                                      join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks not done in {JOIN_S} s")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh2")
    _spawn(worker.run, 2, (f"file://{d}/rendezvous", str(d), CFG))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def single():
    """The same 16 scenarios solved in one process, and their stats."""
    scen = pm.sweep_scenarios(CFG, 2, device="cpu", **worker.SWEEP)
    res = tb.solve_scenarios(scen, CFG)
    return res, tb.sweep_stats(res)


def _hold_stats(stats, ref):
    n, n_solved, mean_iters, max_kkt, mean_cost = stats
    assert n.item() == ref.n.item() == 16.0
    assert n_solved.item() == ref.n_solved.item()
    assert max_kkt.item() == ref.max_kkt_solved.item()
    assert mean_iters.item() == pytest.approx(ref.mean_iters.item(), rel=1e-6)
    assert mean_cost.item() == pytest.approx(ref.mean_cost.item(), rel=1e-6)


def test_two_rank_sweep_matches_one_process(two_ranks, single):
    res1, stats1 = single
    assert stats1.n_solved.item() > 0          # not a 0 == 0 comparison
    for r, out in enumerate(two_ranks):
        assert out["jax_loaded"] == []
        assert out["mesh"] == (1, 2) and out["shard"] == r
        sl = slice(8 * r, 8 * r + 8)
        for name, got, want in zip(res1._fields, out["res"], res1):
            assert torch.equal(got, want[sl]), (r, name)
        _hold_stats(out["stats"], stats1)
    # the ranks hold disjoint halves: their solved lanes add up
    assert sum(int((o["res"][4] == 1).sum()) for o in two_ranks) == int(
        stats1.n_solved.item())


def test_gathered_answers_on_rank_zero(two_ranks, single):
    """Rank 0 holds both shards' exit codes and iterations in shard order,
    equal to the one-process solve of the same set."""
    res1, _ = single
    ec, it = two_ranks[0]["gathered"]
    assert ec.device.type == "cpu" and ec.shape == it.shape == (16,)
    assert torch.equal(ec, torch.cat([o["res"][4] for o in two_ranks]))
    assert torch.equal(it, torch.cat([o["res"][5] for o in two_ranks]))
    assert torch.equal(ec, res1.exit_code)
    assert torch.equal(it, res1.iters)


def test_other_ranks_gather_nothing(two_ranks):
    assert two_ranks[1]["gathered"] is None


@pytest.mark.parametrize("name", worker.SPANS)
def test_sweep_spans_open_once_a_sweep(two_ranks, name):
    for out in two_ranks:
        assert out["span_counts"][name] == 1, (out["rank"], name)


def test_init_group_passes_its_timeout(tmp_path, monkeypatch):
    seen = {}

    def record(backend, **kw):
        seen.update(kw, backend=backend)

    monkeypatch.setattr(pm.dist, "init_process_group", record)
    limit = timedelta(seconds=42)
    pm.init_group("cpu", f"file://{tmp_path}/rendezvous", 1, 0, timeout=limit)
    assert seen["backend"] == "gloo" and seen["timeout"] == limit
    pm.init_group("cpu", f"file://{tmp_path}/rendezvous", 1, 0)
    assert seen["timeout"] is None


def test_two_rank_dryrun_step(two_ranks):
    for out in two_ranks:
        rep = out["dryrun"]
        assert rep["batch"] == 4 and rep["ranks"] == 2
        assert rep["shape"] == [4, CFG.model.N + 1, 17]
        assert rep["mesh"] == {"host": 1, "chip": 2}


def test_world_of_one_in_process(tmp_path, single):
    """A world of one (the card's configuration in chip_smoke.py): the
    sharded solve bit-equal to solve_scenarios, the stats to sweep_stats."""
    pm.init_group("cpu", f"file://{tmp_path}/rendezvous", 1, 0)
    try:
        with pytest.raises(ValueError, match="does not hold"):
            pm.make_mesh((2, 1), device_type="cpu")
        mesh = pm.make_mesh(device_type="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("host", "chip")
        scen = pm.sweep_scenarios(CFG, 1, device="cpu", **worker.SWEEP)
        local = pm.shard_scenarios(scen, mesh)
        assert torch.equal(local.Z0, scen.Z0)
        res, stats = pm.make_sharded_solver(CFG, mesh)(local)
        res1, stats1 = single
        for name, a, b in zip(res._fields, res, res1):
            assert torch.equal(a, b), name
        _hold_stats(stats, stats1)
        for leaf in stats:
            assert leaf.device.type == "cpu" and leaf.shape == ()
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_the_default_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_group"):
        pm.make_mesh(device_type="cpu")


def test_backend_follows_the_device_without_fallback(tmp_path):
    assert pm.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="needs a card"):
        pm.init_group("cuda", f"file://{tmp_path}/rendezvous", 1, 0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("n", range(1, 9))
def test_fold_matches_jax(n):
    assert pm.fold_shape(n) == jm.make_mesh(jax.devices()[:n]).devices.shape
    assert pm.fold_shape(n, 1) == (n,)


def test_sweep_scenarios_match_jax():
    """The JAX module's draws, grid and padding (to 3 ranks: 16 + 2)."""
    rng = np.random.default_rng(7)
    goals = rng.uniform([-4, -4, 1.0], [4, 4, 1.6], (4, 3))
    forces = rng.uniform(-2.0, 2.0, (4, 3))
    halves = np.tile(np.array([[6.0, 6.0, 2.0]]), (1, 1))
    ref = jb.make_scenarios(JC, goals, forces, halves, dtype=jnp.float64)
    ref = jax.tree.map(lambda a: jnp.concatenate([a, a[:2]], axis=0), ref)
    got = pm.sweep_scenarios(CFG, 3, 4, 4, seed=7, dtype=torch.float64,
                             device="cpu")
    assert got.batch == 18
    ref_p, ref_Z0 = tn.nlp_params_from_numpy(ref.params, ref.Z0,
                                             dtype=torch.float64,
                                             device="cpu")
    assert torch.equal(got.Z0, ref_Z0)
    for a, b in zip(got.params[:-1], ref_p[:-1]):
        assert torch.equal(a, b)
    for a, b in zip(got.params.weights, ref_p.weights):
        assert torch.equal(a, b)
    assert "jax" not in pm.__dict__ and "jax" in sys.modules
