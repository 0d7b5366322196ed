"""The port's certificate and stress tools (forces_resilient_planner_tpu_torch/
tools/{parity_certificate,stress_oracle}.py) on the CPU, without the card
or the oracle: their lane choice and pipeline lanes equal to the JAX
tools' (tools/tpu_parity_check.py), the records' fields on known inputs,
the false-optimal audit, and the stress tool's resume from its partial
file.  The tools' runs (the oracle over many lanes) are on the card; one
small CPU run of each is marked slow."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.oracle import pool as oracle_pool
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.solver.ipm import SolveResult
from forces_resilient_planner_tpu_torch.tools import parity_certificate as pc
from forces_resilient_planner_tpu_torch.tools import stress_oracle as so

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool():
    """tools/tpu_parity_check.py, loaded by path (it imports JAX only
    inside its stages)."""
    spec = importlib.util.spec_from_file_location(
        "tpu_parity_check", ROOT / "tools" / "tpu_parity_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_and_lane_choice_are_the_jax_tool_s():
    jt = _jax_tool()
    assert (pc.BOX_SEEDS, pc.BOX_LANES_PER_SET, pc.FENCE_B, pc.FENCE_SEED,
            pc.FENCE_LANES, pc.TOL) == (
        jt.BOX_SEEDS, jt.BOX_LANES_PER_SET, jt.FENCE_B, jt.FENCE_SEED,
        jt.FENCE_LANES, jt.TOL)
    assert (pc.PIPE_B, pc.PIPE_K, pc.PIPE_M) == (jt.PIPE_B, jt.PIPE_K,
                                                 jt.PIPE_M)
    assert oracle_pool.ORACLE_RESTARTS == jt.ORACLE_RESTARTS
    rng = np.random.default_rng(3)
    for B, n in ((64, 8), (128, 12), (5, 8)):
        ec = np.where(rng.uniform(size=B) < 0.8, 1, -7)
        it = rng.integers(5, 40, B)
        np.testing.assert_array_equal(pc.pick_lanes(ec, it, n),
                                      jt._pick_lanes(ec, it, n))
    assert pc.pick_lanes(np.full(4, -7), np.ones(4, int), 8).size == 0


def test_pipeline_lanes_are_the_jax_tool_s():
    want = _jax_tool().build_pipeline_lanes(np.random.default_rng(4242))
    got = pc.pipeline_lanes(np.random.default_rng(4242), pc.PIPE_B)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_certificate_summary_fields():
    recs = [dict(family="box1000", lane=3, iters=18, du=2e-4, status=0,
                 tries=1, feas=0.0, stat=1e-6, seconds=1.0),
            dict(family="fence", lane=7, iters=13, du=9e-4, status=8,
                 tries=4, feas=1e-9, stat=5e-4, seconds=2.0),
            dict(family="fence", lane=9, iters=12, du=1.1e-3, status=8,
                 tries=4, feas=1e-5, stat=1e-2, seconds=2.0)]
    s = pc.summary(recs, {"box1000": 1.0, "fence": 1.0}, 3.0, 1)
    want_keys = set(json.loads((ROOT / "PARITY_TPU.json").read_text()))
    assert want_keys - {"pipeline"} <= set(s)
    assert (s["n_lanes"], s["n_fence_lanes"], s["n_oracle_converged"],
            s["n_strict_lanes"]) == (3, 2, 1, 2)
    assert s["max_u_diff"] == 1.1e-3 and s["max_u_diff_strict_lanes"] == 9e-4
    assert s["pass"] is False
    assert pc.summary(recs[:2], {}, 3.0, 1)["pass"] is True
    assert pc.summary([], {"fence": 0.0}, 0.0, 1)["pass"] is False


def _result(Z, ec):
    B = Z.shape[0]
    z = torch.zeros(B)
    return SolveResult(Z=Z, lam=z, s=z, mu_d=z, exit_code=ec, iters=z,
                       kkt_error=z)


def test_false_optimals_flag_exit_1_outside_the_corridor_only():
    _, params = workloads.stress_params(3, dtype=torch.float64, device="cpu")
    N = params.corridor_A.shape[1]
    # each lane's box centre: rows 2k, 2k+1 read p_k <= c + h, -p_k <= h - c
    b = params.corridor_b[:, 1, :6]
    centre = 0.5 * (b[:, 0::2] - b[:, 1::2])
    Z = torch.zeros(3, N, 17, dtype=torch.float64)
    Z[:, :, 8:11] = centre[:, None]
    assert so.false_optimals(_result(Z, torch.tensor([1, 1, 1])), params,
                             1e-5) == []
    out = Z.clone()
    out[1, 5, 8] = params.corridor_b[1, 5, 0] + 0.01      # x past x <= b0
    assert so.false_optimals(_result(out, torch.tensor([1, 1, 1])), params,
                             1e-5) == [1]
    assert so.false_optimals(_result(out, torch.tensor([1, -7, 1])), params,
                             1e-5) == []
    stage0 = Z.clone()
    stage0[2, 0, 8] = 99.0                  # stage 0 is pinned to xinit
    assert so.false_optimals(_result(stage0, torch.tensor([1, 1, 1])),
                             params, 1e-5) == []


def test_stress_record_fields_and_confusion():
    ec64 = np.array([1, 1, -7, -7, -6, 1])
    ec32 = np.array([1, -7, -7, 0, -6, 1])
    verdicts = {ln: {"feasible": ln == 3} for ln in range(6)}
    s = so.precision_summary(ec64, verdicts, [])
    want_keys = set(json.loads((ROOT / "STRESS_ORACLE.json").read_text()))
    assert want_keys - {"B", "wall_s", "config"} <= set(s)
    assert (s["n_failed"], s["n_capability_misses"], s["miss_lanes"],
            s["noprogress_misclassified"]) == (3, 1, [3], [3])
    assert s["exit_families"] == {"-7": 2, "-6": 1, "1": 3}
    assert s["solve_rate_feasible_subset"] == 3 / 4
    s32 = so.precision_summary(ec32, verdicts, [5])
    assert (s32["n_capability_misses"], s32["n_noprogress_misclassified"],
            s32["n_false_optimals"]) == (1, 0, 1)
    assert so.confusion(ec64, ec32) == {
        "f64 1, f32 1": 2, "f64 1, f32 -7": 1, "f64 -7, f32 0": 1,
        "f64 -7, f32 -7": 1, "f64 -6, f32 -6": 1}


def _keyed_lanes(lanes):
    _, params64 = workloads.stress_params(max(lanes) + 1, dtype=torch.float64,
                                          device="cpu")
    fp = so.oracle_fingerprint(workloads.bench_config())
    return params64, {
        ln: so.lane_key(ipm_lanes._map_params(lambda a, i=ln: a[i],
                                              params64), 999_000 + ln, fp)
        for ln in lanes}


def test_stress_classification_resumes_from_its_partial_file(tmp_path,
                                                             monkeypatch):
    params64, keys = _keyed_lanes([4, 9])
    part = tmp_path / "STRESS.partial.jsonl"
    recs = [{"lane": 4, "key": keys[4], "feasible": False,
             "oracle": [8, 0.7, 14.0], "seconds": 1.0},
            {"lane": 9, "key": keys[9], "feasible": True,
             "oracle": [0, 0.0, 1e-6], "seconds": 2.0},
            {"lane": 11, "key": "another run's", "feasible": True,
             "oracle": [0, 0.0, 1e-6], "seconds": 2.0}]
    part.write_text("\n".join(json.dumps(r) for r in recs) + "\nnot json\n")

    def no_pool(*a, **k):
        raise AssertionError("a classified lane went to the oracle again")
    monkeypatch.setattr(oracle_pool, "make_pool", no_pool)
    got = so.classify_lanes([4, 9], params64, part)
    assert got == ({4: recs[0], 9: recs[1]}, 2)


@pytest.mark.parametrize("stale", ["problem", "oracle", "seed", "unkeyed"])
def test_stress_resume_rejects_a_verdict_of_another_problem_or_oracle(
        tmp_path, monkeypatch, stale):
    params64, keys = _keyed_lanes([4])
    fp = so.oracle_fingerprint(workloads.bench_config())
    lane = ipm_lanes._map_params(lambda a: a[4], params64)
    key = {
        "problem": so.lane_key(lane._replace(f_ext=lane.f_ext + 1e-9),
                               999_004, fp),
        "oracle": so.lane_key(lane, 999_004, fp + b"another ftol"),
        "seed": so.lane_key(lane, 999_005, fp),
        "unkeyed": None,
    }[stale]
    assert key != keys[4]
    rec = {"lane": 4, "feasible": True, "oracle": [0, 0.0, 1e-6],
           "seconds": 1.0}
    if key is not None:
        rec["key"] = key
    part = tmp_path / "STRESS.partial.jsonl"
    part.write_text(json.dumps(rec) + "\n")
    monkeypatch.setattr(oracle_pool, "make_pool", None)
    with pytest.raises(RuntimeError, match="delete the file"):
        so.classify_lanes([4], params64, part)


@pytest.mark.slow
def test_tools_run_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """Both tools' main at a small size on the CPU (the oracle over a few
    lanes in a pool: minutes)."""
    monkeypatch.setattr(so, "STRESS_B", 12)
    monkeypatch.setattr(so, "RESUME_DIR", tmp_path / "resume")
    out = tmp_path / "stress.json"
    assert so.main(["--device", "cpu", "--out", str(out),
                    "--workers", "2"]) == 0
    s = json.loads(out.read_text())
    assert s["n_false_optimals"] == 0 and s["f32"]["n_false_optimals"] == 0
    assert s["n_oracle_lanes_resumed"] == 0 and s["resumed_from"] is None
    assert (tmp_path / "resume" / "stress.partial.jsonl").exists()
    orig = workloads.bench_seeds
    monkeypatch.setattr(workloads, "bench_seeds",
                        lambda seed: orig(seed, 4, 2))
    monkeypatch.setattr(pc, "BOX_SEEDS", (1000,))
    monkeypatch.setattr(pc, "BOX_LANES_PER_SET", 1)
    monkeypatch.setattr(pc, "FENCE_LANES", 1)
    monkeypatch.setattr(pc, "FENCE_B", 8)
    monkeypatch.setattr(pc, "PIPE_B", 4)
    out = tmp_path / "parity.json"
    assert pc.main(["--device", "cpu", "--out", str(out),
                    "--workers", "2"]) == 0
    assert json.loads(out.read_text())["n_lanes"] == 2
