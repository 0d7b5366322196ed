"""The sweep kind (benchmark/kinds/sweep.py) on the CPU: a 2-rank gloo world
at goals 2 x forces 2 runs through run.run_cell and passes its check, a
broken shard on either rank fails it, the reference in bfloat16 fails it,
a rank that raises ends the run within the kind's limit with no rank left,
and the reference's draws are the program's.  The cell's own run, on four
cards over NCCL, is benchmark/run.py's."""
import json
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from benchmark import run, spec
from benchmark.kinds import sweep
from benchmark.reference import sweep as ref_sweep
from benchmark.reference.config import from_groups
from forces_resilient_planner_tpu_torch.engine import batch
from forces_resilient_planner_tpu_torch.parallel import mesh as pm
from forces_resilient_planner_tpu_torch.solver import ipm_lanes

CELL = "grid-4096x4"
TINY = dict(ranks=2, goals=2, forces=2, check_calls=2, check_lanes=4,
            warm_calls=1, trace_calls=1)
SEED = 2 ** 31 + 21


def tiny():
    c = spec.cell(CELL)
    c.traffic = dict(c.traffic, **TINY)
    return c


def _no_rank_left():
    assert mp.active_children() == []
    assert not dist.is_initialized()


def failing_rank(rank, *args):
    """Rank 1 raises in its first sweep."""
    if rank == 1:
        def boom(*a, **k):
            raise RuntimeError("a fault put in rank 1")
        pm.monte_carlo_sweep = boom
    sweep.rank_main(rank, *args)


def broken_rank(rank, *args):
    """Rank 1 answers its shard with the warm start's controls."""
    solve = ipm_lanes.solve_batch_lanes_tiered

    def unchanged(Z0, *a, **k):
        return solve(Z0, *a, **k)._replace(Z=Z0.clone())
    ipm_lanes.solve_batch_lanes_tiered = unchanged
    sweep.rank_main(rank, *args)


@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_two_gloo_ranks(traced):
    result, checks = run.run_cell(tiny(), SEED, 0.0, traced, "cpu")
    assert result["correct"], checks
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["attempted"] == 4
    assert set(checks) == {"exit_mismatch_share", "du_max", "stats_gap"}
    assert checks["stats_gap"][0] == 0.0
    # on the CPU the trace holds no device activity: no device metrics
    want = ({"rank_skew_pct.sweep", "expand_ms.sweep"} if traced
            else {"setup_s", "solves_per_s"})
    assert set(result["metrics"]) == want
    json.loads(json.dumps(result, allow_nan=False))
    _no_rank_left()


def test_broken_shard_on_rank_zero_fails(monkeypatch):
    solve = ipm_lanes.solve_batch_lanes_tiered
    monkeypatch.setattr(ipm_lanes, "solve_batch_lanes_tiered",
                        lambda Z0, *a, **k: solve(Z0, *a, **k)._replace(
                            Z=Z0.clone()))
    result, checks = run.run_cell(tiny(), SEED, 0.0, False, "cpu")
    assert not result["correct"] and checks["du_max"][0] > 0.1
    _no_rank_left()


def test_broken_shard_on_rank_one_fails(monkeypatch):
    monkeypatch.setattr(sweep.Loop, "rank_main", staticmethod(broken_rank))
    result, checks = run.run_cell(tiny(), SEED, 0.0, False, "cpu")
    assert not result["correct"] and checks["du_max"][0] > 0.1
    _no_rank_left()


def test_failing_rank_ends_the_run(monkeypatch):
    monkeypatch.setattr(sweep.Loop, "rank_main", staticmethod(failing_rank))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a fault put in rank 1"):
        run.run_cell(tiny(), SEED, 0.0, False, "cpu")
    assert time.monotonic() - t0 < sweep.LIMIT_S
    _no_rank_left()


def test_bfloat16_control_fails():
    c = tiny()
    loop = sweep.Loop(spec.program_config(c.config),
                      from_groups(c.config["groups"]), c.traffic, SEED, "cpu")
    loop.release()
    values = loop.control(torch.bfloat16)
    assert any(not v <= c.limits[k] for k, v in values.items()), values
    _no_rank_left()


def test_reduced_statistics_in_half_precision_miscount():
    """At the cell's size each shard's iteration sum overflows float16 and
    bfloat16 miscounts the solved; at float32 they are exact."""
    rng = np.random.default_rng(3)
    B, world = 16384, 4
    ec = np.where(rng.random(B) < 0.98, 1, 0)
    it = rng.integers(8, 40, B)
    shard = np.arange(B) // (B // world)
    want = ref_sweep.stats(ec, it)
    for dtype in (torch.float16, torch.bfloat16):
        got = ref_sweep.reduced_stats(ec, it, shard, world, dtype)
        assert not ref_sweep.gap(got, want) <= 1e-4, dtype
    got = ref_sweep.reduced_stats(ec, it, shard, world, torch.float32)
    assert got[:2] == want[:2]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_reference_draws_are_the_programs(seed):
    cfg = spec.program_config(spec.cell(CELL).config)
    goals, forces, halves = ref_sweep.draws(seed, 4, 3)
    want = batch.make_scenarios(cfg, goals, forces, halves,
                                dtype=torch.float64, device="cpu")
    got = pm.sweep_scenarios(cfg, 4, 4, 3, seed=seed, dtype=torch.float64,
                             device="cpu")
    assert torch.equal(got.Z0, want.Z0)
    for a, b in zip(got.params[:-1], want.params[:-1]):
        assert torch.equal(a, b)


def test_traffic_ranks_are_the_chips_and_the_mesh():
    c = spec.cell(CELL)
    mesh = c.config["mesh"]
    assert c.traffic["ranks"] == c.chips == mesh["host"] * mesh["chip"]
    assert mesh["host"] == 1
    assert c.traffic["goals"] * c.traffic["forces"] % c.traffic["ranks"] == 0
    assert c.config["groups"] == json.loads(
        (spec.ROOT / "benchmark/configs/mc-grid.json").read_text())["groups"]
