"""Per-phase timers and planner metrics.

The reference's only instrumentation is a wall-clock print per solve
(nmpc_solver.cpp:431-433) and unread FORCES solvetime fields.  Here timing
is a first-class subsystem: phase timers with percentile summaries and a
counter registry exposing the BASELINE north-star metrics (solves/s, p99
solve latency).  For kernel-level traces use jax.profiler around any phase.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class PhaseStats:
    samples: List[float] = field(default_factory=list)

    def add(self, dt: float):
        self.samples.append(dt)

    def summary(self) -> dict:
        if not self.samples:
            return {"n": 0}
        a = np.asarray(self.samples)
        return {
            "n": int(a.size),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p99_ms": float(np.percentile(a, 99) * 1e3),
            "max_ms": float(a.max() * 1e3),
            "total_s": float(a.sum()),
        }


class Timers:
    """Named phase timers.  Usage:

        timers = Timers()
        with timers.phase("solve"):
            ...
        print(timers.report())
    """

    def __init__(self):
        self._phases: Dict[str, PhaseStats] = defaultdict(PhaseStats)
        self.counters: Dict[str, float] = defaultdict(float)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._phases[name].add(time.perf_counter() - t0)

    def count(self, name: str, inc: float = 1.0):
        self.counters[name] += inc

    def report(self) -> dict:
        out = {k: v.summary() for k, v in self._phases.items()}
        out["counters"] = dict(self.counters)
        solve = self._phases.get("solve")
        if solve and solve.samples:
            a = np.asarray(solve.samples)
            out["solves_per_s"] = float(len(a) / a.sum())
            out["p99_solve_ms"] = float(np.percentile(a, 99) * 1e3)
        return out
