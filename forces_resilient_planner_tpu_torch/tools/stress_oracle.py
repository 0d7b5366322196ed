"""Oracle classification of the solver's failures on the adversarial stress
distribution, on the card.

Port of the JAX package's tools/stress_oracle_classify.py.  The reference's
FORCES solver is a filter-line-search IPM with second-order corrections
(FORCESNLPsolver_normal.h:86-107); the port's, like the JAX package's, is a
fraction-to-boundary IPM with NaN guards.  tests/test_torch_stress.py holds
the safety half on the CPU (no false optimal); this tool measures the
capability half on the card: of the stress lanes the solver fails, how
many were solvable?

Method: the stress batch (engine/workloads.py::stress_params, seed 123,
B = 512: random tight and shifted corridors, forces up to
4 m/s^2, random goals) is solved on the card at f32 and at f64 through the
IPM kernel (K1) with the bench's tier schedule; every lane that failed at
either precision is re-solved by the independent SLSQP oracle with its
multi-start (oracle/pool.py::classify, in a pool of CPU processes).  A
failed lane is a CAPABILITY MISS only when the oracle finds a point that
passes the KKT certificate and meets every constraint: the problem was
provably feasible and another algorithm solved it.  A -7 (NOPROGRESS,
the infeasibility certificate) lane the oracle proves feasible is a
misclassified certificate.  An exit 1 whose trajectory leaves its corridor
by more than the slack is a false optimal.

Each classified lane is appended to a resume file under _arch/ (git-
ignored), named after --out, so an interrupted run resumes.  Each record
carries a key: the hash of its lane's f64 problem, its random starts' seed,
the configuration and the oracle's code (oracle/cpu_oracle.py and
oracle/pool.py, where the trials, ftol and tolerances of the rule live).
A record whose key is not its lane's makes the run stop: the problem or
the oracle changed since it was written, and the file must be deleted.
Writes STRESS_ORACLE_H100.json: STRESS_ORACLE.json's fields for the f64
solve, the same for f32, the f32-versus-f64 exit-code confusion matrix,
the false optimals at each precision, the card's name and power limit,
and, when lanes were resumed, the resume file they came from (their own
seconds are in oracle_lane_s; oracle_wall_s is this run's).

    python -m forces_resilient_planner_tpu_torch.tools.stress_oracle
        [--device cuda] [--out STRESS_ORACLE_H100.json] [--workers N]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from concurrent.futures import as_completed
from pathlib import Path

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.oracle import cpu_oracle
from forces_resilient_planner_tpu_torch.oracle import pool as oracle_pool
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.utils.measure import card_line

ROOT = Path(__file__).resolve().parents[2]
RESUME_DIR = ROOT / "_arch"
STRESS_B, STRESS_SEED = 512, 123
EXIT_CODES = (1, 0, -6, -7)


def solve_stress(B: int, dtype, device, seed: int = STRESS_SEED):
    """The stress batch solved on `device` at `dtype` with the bench's
    tier schedule: (SolveResult, params)."""
    cfg = workloads.bench_config()
    Z0, params = workloads.stress_params(B, seed, dtype=dtype, device=device)
    return ipm_lanes.solve_batch_lanes_tiered(Z0, params, cfg.model,
                                              cfg.solver), params


def false_optimals(res, params, slack: float) -> list[int]:
    """Lanes with exit 1 whose stages 1..N-1 leave their corridor by more
    than slack + 1e-6 (stage 0 is pinned to xinit)."""
    A = params.corridor_A[:, 1:].double()
    pos = res.Z[:, 1:, 8:11].double()
    excess = (torch.einsum("bnkj,bnj->bnk", A, pos)
              - params.corridor_b[:, 1:].double()).amax(dim=(1, 2))
    bad = (res.exit_code == 1) & (excess > slack + 1e-6)
    return torch.nonzero(bad).flatten().tolist()


def families(ec: np.ndarray) -> dict:
    return {str(int(c)): int((ec == c).sum()) for c in np.unique(ec)}


def confusion(ec64: np.ndarray, ec32: np.ndarray) -> dict:
    """{"f64 a, f32 b": lanes} over every pair that occurs."""
    out = {}
    for a in EXIT_CODES:
        for b in EXIT_CODES:
            n = int(((ec64 == a) & (ec32 == b)).sum())
            if n:
                out[f"f64 {a}, f32 {b}"] = n
    return out


def oracle_fingerprint(cfg) -> bytes:
    """What a verdict depends on besides its lane's problem: the oracle's
    code and the configuration."""
    h = hashlib.sha256()
    for mod in (cpu_oracle, oracle_pool):
        h.update(Path(mod.__file__).read_bytes())
    h.update(repr((cfg.model, cfg.solver)).encode())
    return h.digest()


def lane_key(params, seed: int, fingerprint: bytes) -> str:
    """The key of one lane's verdict: its f64 problem, its random starts'
    seed and the oracle's fingerprint."""
    h = hashlib.sha256(fingerprint)
    for t in (*params[:-1], *params.weights):
        h.update(t.to("cpu", torch.float64).contiguous().numpy().tobytes())
    h.update(str(seed).encode())
    return h.hexdigest()[:16]


def read_partial(path: Path, keys: dict) -> dict:
    """The verdicts of the resume file for the lanes of `keys` ({lane:
    key}); raises when one was written for another problem or oracle."""
    done = {}
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                rec = json.loads(line)
                lane = rec["lane"]
            except (ValueError, KeyError, TypeError):
                continue
            if lane not in keys:
                continue
            if rec.get("key") != keys[lane]:
                raise RuntimeError(
                    f"{path}: lane {lane}'s verdict has key "
                    f"{rec.get('key')}, the lane's problem and oracle now "
                    f"give {keys[lane]}: delete the file to classify again")
            done[lane] = rec
    return done


def classify_lanes(lanes, params64, partial: Path, workers=None):
    """({lane: {"lane", "key", "feasible", "oracle", "seconds"}} for every
    lane, the number of lanes read from the resume file): a lane comes
    from the resume file where it has it, else from the oracle pool (each
    result appended to the file as it lands)."""
    cfg = workloads.bench_config()
    fp = oracle_fingerprint(cfg)
    lane_params = {ln: ipm_lanes._map_params(lambda a, i=ln: a[i], params64)
                   for ln in lanes}
    keys = {ln: lane_key(lane_params[ln], 999_000 + ln, fp) for ln in lanes}
    done = read_partial(partial, keys)
    todo = [ln for ln in lanes if ln not in done]
    if done:
        print(f"[resume] {len(lanes) - len(todo)} lanes already classified "
              f"in {partial}", flush=True)
    if todo:
        partial.parent.mkdir(parents=True, exist_ok=True)
        with oracle_pool.make_pool(workers) as pool:
            futures = {
                pool.submit(oracle_pool.classify, lane_params[ln], cfg.model,
                            cfg.solver, 999_000 + ln): ln
                for ln in todo}
            for j, fut in enumerate(as_completed(futures)):
                ln = futures[fut]
                rec = dict(lane=ln, key=keys[ln], **fut.result())
                done[ln] = rec
                with partial.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(f"[oracle] {j + 1}/{len(todo)} lane {ln} -> "
                      f"{'FEASIBLE' if rec['feasible'] else 'not proven'} "
                      f"{rec['oracle']} ({rec['seconds']:.1f} s)", flush=True)
    return {ln: done[ln] for ln in lanes}, len(lanes) - len(todo)


def precision_summary(ec: np.ndarray, verdicts: dict, false_opt) -> dict:
    """STRESS_ORACLE.json's fields for one precision's exit codes."""
    solved = ec == 1
    failed = np.flatnonzero(~solved)
    misses = [int(ln) for ln in failed if verdicts[int(ln)]["feasible"]]
    mis7 = [ln for ln in misses if ec[ln] == -7]
    n_solved = int(solved.sum())
    return {
        "solve_rate_overall": float(solved.mean()),
        "n_failed": int(failed.size),
        "exit_families": families(ec),
        "n_capability_misses": len(misses),
        "miss_lanes": misses,
        "solve_rate_feasible_subset": n_solved / max(n_solved + len(misses),
                                                     1),
        "noprogress_misclassified": mis7,
        "n_noprogress_misclassified": len(mis7),
        "false_optimal_lanes": false_opt,
        "n_false_optimals": len(false_opt),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "STRESS_ORACLE_H100.json"))
    ap.add_argument("--workers", type=int, default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    card = card_line(dev)
    slack = workloads.bench_config().solver.corridor_slack
    t0 = time.perf_counter()
    ec, fo, iters = {}, {}, {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        res, params = solve_stress(STRESS_B, dtype, dev)
        ec[name] = res.exit_code.cpu().numpy()
        iters[name] = res.iters.cpu().numpy()
        fo[name] = false_optimals(res, params, slack)
        if not bool(torch.isfinite(res.Z).all()):
            raise SystemExit(f"non-finite Z at {name}")
        print(f"[stress] {name} B={STRESS_B}: solved "
              f"{(ec[name] == 1).mean():.4f}, exit families "
              f"{families(ec[name])}, false optimals {fo[name]}", flush=True)
    solve_s = time.perf_counter() - t0
    failed = sorted(set(np.flatnonzero(ec["f64"] != 1).tolist())
                    | set(np.flatnonzero(ec["f32"] != 1).tolist()))
    _, params64 = workloads.stress_params(STRESS_B, STRESS_SEED,
                                          dtype=torch.float64, device="cpu")
    out = Path(args.out)
    t1 = time.perf_counter()
    partial = RESUME_DIR / f"{out.stem}.partial.jsonl"
    verdicts, resumed = classify_lanes(failed, params64, partial,
                                       args.workers)
    oracle_s = time.perf_counter() - t1
    result = {
        "B": STRESS_B,
        **precision_summary(ec["f64"], verdicts, fo["f64"]),
        "f32": precision_summary(ec["f32"], verdicts, fo["f32"]),
        "confusion_f64_vs_f32": confusion(ec["f64"], ec["f32"]),
        "iters_equal_f32_f64": float((iters["f64"] == iters["f32"]).mean()),
        "n_oracle_lanes": len(failed),
        "n_oracle_lanes_resumed": resumed,
        "resumed_from": (str(partial.relative_to(ROOT))
                         if partial.is_relative_to(ROOT) else str(partial))
        if resumed else None,
        "oracle_lane_s": sum(v["seconds"] for v in verdicts.values()),
        "card": card, "device": str(dev), "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "solve_wall_s": solve_s,
        "oracle_wall_s": oracle_s,   # this run's; resumed lanes cost none
        "wall_s": time.perf_counter() - t0,
        "config": "DEFAULT_CONFIG with the bench tiers, f64 and f32 through "
                  "K1 on the card, vs SLSQP multi-start + KKT certificate "
                  "(CPU pool)",
    }
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0 if not (fo["f64"] or fo["f32"]) else 1


if __name__ == "__main__":
    sys.exit(main())
