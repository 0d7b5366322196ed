"""The program's host spans (forces_resilient_planner_tpu_torch/utils/
trace.py: {name: (count, ns)}, inclusive of nested spans) as counters
that a metric reads before and after the window, and the growth of their
totals as host milliseconds per call.  A program without that module
gives no counters, and a metric over them then reads nothing."""
from __future__ import annotations

import importlib

MODULE = "forces_resilient_planner_tpu_torch.utils.trace"


def counters(*names: str) -> dict:
    """{"<name>.count": count, "<name>.ns": ns} of each span, 0 for one
    not yet opened; {} when the program has no span module."""
    try:
        trace = importlib.import_module(MODULE)
    except ModuleNotFoundError as e:
        if e.name != MODULE:
            raise
        return {}
    totals = trace.totals()
    out = {}
    for name in names:
        count, ns = totals.get(name, (0, 0))
        out[f"{name}.count"], out[f"{name}.ns"] = count, ns
    return out


def ms_per_call(run, spans, less=()) -> float | None:
    """The growth over the window of the spans' summed host time, less
    that of `less` (spans nested in them), in ms per call; None when the
    program has no such spans or none of `spans` opened in the window."""
    grown = run.counters
    if any(f"{n}.ns" not in grown for n in (*spans, *less)):
        return None
    if not any(grown[f"{n}.count"] for n in spans):
        return None
    ns = sum(grown[f"{n}.ns"] for n in spans) \
        - sum(grown[f"{n}.ns"] for n in less)
    return ns * 1e-6 / run.calls
