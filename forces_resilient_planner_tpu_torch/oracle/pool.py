"""The oracle's two acceptance rules, run lane by lane in a pool of CPU
processes (tools/parity_certificate.py, tools/stress_oracle.py,
chip_smoke.py phase 15).

`certify` is the parity certificate's multi-start (the JAX package's
tools/tpu_parity_check.py:541-590): SLSQP at ftol 1e-14; a stall (status
8 is SLSQP's usual answer at the optimum, where 1e-14 is below what the
condensed f64 objective resolves) is retried at ftol 1e-10 and then from
randomized starts, and the lane counts as converged only when a status-0
run confirms the tight solve's controls within 1e-5; the independent KKT
certificate is taken at the tight solve's point.

`classify` is the stress classification's rule (tools/
stress_oracle_classify.py:140-168): up to three SLSQP runs at ftol 1e-10,
the first from the hover start, the others from randomized ones; the
problem is provably feasible when a run ends at a point with every
constraint met within 1e-7 and KKT stationarity within 1e-3.

One SLSQP solve takes 8-20 s on one CPU thread, so the lanes run in
processes (spawned, so a parent that holds a CUDA context forks none of
it), each with torch on one thread: the oracle's operations are 84 wide,
where more threads only add cost.  The random starts of a lane come from
its own seed, so its result does not depend on the other lanes or on the
order the pool finishes them in.
"""
from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, SolverConfig
from forces_resilient_planner_tpu_torch.oracle.cpu_oracle import (
    kkt_certificate,
    solve_oracle,
)
from forces_resilient_planner_tpu_torch.solver.nlp import NLPParams

ORACLE_RESTARTS = 2      # randomized starts after the ftol-1e-10 retry
CLASSIFY_TRIALS = 3      # the hover start and two randomized ones
FEAS_TOL, STAT_TOL = 1e-7, 1e-3


def _random_start(mcfg: ModelConfig, rng) -> np.ndarray:
    nv = 4 + 4 * mcfg.N
    v0 = np.zeros(nv)
    v0[3::4] = mcfg.hover_thrust
    return v0 + rng.normal(0, 0.05, nv)


def certify(params: NLPParams, mcfg: ModelConfig, scfg: SolverConfig,
            lane_seed: int) -> dict:
    """The multi-start re-solve of one lane: the tight solve's controls
    (N, 4), the SLSQP status (0 once confirmed), the solves it took and
    the KKT residuals (feas, stat) at the tight solve's point."""
    t0 = time.perf_counter()
    Z_ref, res = solve_oracle(params, mcfg, scfg)
    v_ref, status, tries = np.asarray(res.x), int(res.status), 1
    rng = np.random.default_rng(lane_seed)

    def confirms(Z2, res2):
        return (int(res2.status) == 0
                and float(np.abs(Z2[:, 0:4] - Z_ref[:, 0:4]).max()) < 1e-5)

    if status != 0:
        tries += 1
        if confirms(*solve_oracle(params, mcfg, scfg, ftol=1e-10)):
            status = 0
    while status != 0 and tries <= 1 + ORACLE_RESTARTS:
        tries += 1
        if confirms(*solve_oracle(params, mcfg, scfg,
                                  v0=_random_start(mcfg, rng), ftol=1e-10)):
            status = 0
    feas, stat = kkt_certificate(v_ref, params, mcfg, scfg)
    return dict(u=Z_ref[:, 0:4], status=status, tries=tries, feas=feas,
                stat=stat, seconds=time.perf_counter() - t0)


def classify(params: NLPParams, mcfg: ModelConfig, scfg: SolverConfig,
             lane_seed: int) -> dict:
    """Whether the oracle proves one lane's problem feasible: `feasible`,
    and `oracle`, the last run's (status, feas, stat) or ("error", ...)
    when SLSQP raised (it can on a NaN cost)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(lane_seed)
    feasible, best = False, None
    for trial in range(CLASSIFY_TRIALS):
        v0 = None if trial == 0 else _random_start(mcfg, rng)
        try:
            _, res = solve_oracle(params, mcfg, scfg, v0=v0, ftol=1e-10)
        except Exception as e:    # noqa: BLE001 - recorded, as the JAX tool
            best = ("error", repr(e))
            continue
        feas, stat = kkt_certificate(np.asarray(res.x), params, mcfg, scfg)
        best = (int(res.status), float(feas), float(stat))
        if feas <= FEAS_TOL and stat <= STAT_TOL:
            feasible = True
            break
    return dict(feasible=feasible, oracle=best,
                seconds=time.perf_counter() - t0)


def _one_thread():
    torch.set_num_threads(1)


def make_pool(workers: int | None = None) -> ProcessPoolExecutor:
    """A pool of spawned CPU processes with torch on one thread each
    (default: one process per core but one)."""
    workers = workers or max(1, (os.cpu_count() or 2) - 1)
    return ProcessPoolExecutor(
        max_workers=workers, initializer=_one_thread,
        mp_context=multiprocessing.get_context("spawn"))
