"""corridors_ms.step: host ms per batched step in its
corridors (engine/pipeline.py::build_corridors: K3 and the reuse loop;
tube/lyapunov.py::tighten_corridor), the program's span step.corridors."""
from benchmark import spans

SPANS = ("step.corridors",)


def counters():
    return spans.counters(*SPANS)


def read(run):
    return spans.ms_per_call(run, SPANS)
