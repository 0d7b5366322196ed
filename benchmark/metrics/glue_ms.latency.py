"""glue_ms.latency: host ms per call outside the solver: the
program's spans step (engine/pipeline_batch.py::nmpc_step_batched) and api
(solver/forces_api.py::ForcesSolver.solve) less the solver span nested in
them."""
from benchmark import spans

SPANS = ("step", "api")
LESS = ("solver",)


def counters():
    return spans.counters(*SPANS, *LESS)


def read(run):
    return spans.ms_per_call(run, SPANS, LESS)
