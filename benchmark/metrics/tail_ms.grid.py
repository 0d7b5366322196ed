"""tail_ms.grid: host ms per call in the tiered solve after its
full-batch phase (solver/ipm_lanes.py::solve_lanes_multitier: compaction,
the sub-batches, the merge, the safety net), the program's span
solver.tail."""
from benchmark import spans

SPANS = ("solver.tail",)


def counters():
    return spans.counters(*SPANS)


def read(run):
    return spans.ms_per_call(run, SPANS)
