"""tubes_ms.step: host ms per batched step in its
disturbance tubes (tube/lyapunov.py::propagate_tubes_batch: K2, the
Minkowski loop, the square root), the program's span step.tubes."""
from benchmark import spans

SPANS = ("step.tubes",)


def counters():
    return spans.counters(*SPANS)


def read(run):
    return spans.ms_per_call(run, SPANS)
