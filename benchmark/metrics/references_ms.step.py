"""references_ms.step: host ms per batched step in its
references (engine/reference.py::sample_references), the program's span
step.references."""
from benchmark import spans

SPANS = ("step.references",)


def counters():
    return spans.counters(*SPANS)


def read(run):
    return spans.ms_per_call(run, SPANS)
