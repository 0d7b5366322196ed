"""expand_ms.grid: host ms per call expanding the scenario
grid on the device (engine/batch.py::make_scenarios inside
solve_scenario_grid), the program's span grid.expand."""
from benchmark import spans

SPANS = ("grid.expand",)


def counters():
    return spans.counters(*SPANS)


def read(run):
    return spans.ms_per_call(run, SPANS)
