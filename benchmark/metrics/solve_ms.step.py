"""solve_ms.step: host ms per batched step in its solve
(solver/ipm_lanes.py::solve_batch_lanes_tiered: the host loop, K1 and its
reads), the program's span solver."""
from benchmark import spans

SPANS = ("solver",)


def counters():
    return spans.counters(*SPANS)


def read(run):
    return spans.ms_per_call(run, SPANS)
