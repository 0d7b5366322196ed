"""solver_wait_ms.latency: host ms per call at the solver's
loop-condition read (solver/ipm_lanes.py::_run_lanes: the device-to-host
read of whether any lane runs on), the program's span solver.read."""
from benchmark import spans

SPANS = ("solver.read",)


def counters():
    return spans.counters(*SPANS)


def read(run):
    return spans.ms_per_call(run, SPANS)
