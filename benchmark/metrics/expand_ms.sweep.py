"""expand_ms.sweep: host ms per call on rank 0 drawing and expanding the
whole scenario set and keeping its shard (parallel/mesh.py::
sweep_scenarios and shard_scenarios: every rank expands every scenario),
the program's span sweep.expand."""
from benchmark import spans

SPANS = ("sweep.expand",)


def counters():
    return spans.counters(*SPANS)


def read(run):
    return spans.ms_per_call(run, SPANS)
