"""Host spans inside the program: counted always, annotated on request.

    with trace.span("step.tubes"):
        ...

On exit a span adds 1 to its count and the host nanoseconds it was open
(`time.perf_counter_ns`) to its total, in one table for the process.
Totals are inclusive: a nested span's time is also in its parent's.  A
span never synchronizes, reads a tensor or allocates on the device, so
it changes neither what the program launches nor when it waits.  The
program opens its spans on the thread that calls it; the table is not
guarded for several threads at once.

`annotate()` is the one switch: while it is active, every span also opens
a `torch.profiler.record_function` of its name, so the span lands in
whatever profiler trace is running, on that trace's own clock, beside the
device work it issued.  It is off by default, so a profiler trace holds
no span of the program unless an operator asks for one:

    with trace.annotate(), torch.profiler.profile(...) as prof:
        ...

`totals()` gives {name: (count, ns)}; `report()` the operator's view,
{name: {"count", "total_ms", "mean_ms"}}, longest total first.
"""
from __future__ import annotations

import contextlib
import time

_TOTALS: dict[str, list[int]] = {}   # name -> [count, ns]
_annotating = 0                       # depth of active annotate() blocks


class span:
    """A named host span (a context manager); see the module's doc."""

    __slots__ = ("name", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if _annotating:
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        total = _TOTALS.get(self.name)
        if total is None:
            _TOTALS[self.name] = [1, ns]
        else:
            total[0] += 1
            total[1] += ns
        return False


@contextlib.contextmanager
def annotate():
    """Every span opened inside the block is also a profiler range."""
    global _annotating
    _annotating += 1
    try:
        yield
    finally:
        _annotating -= 1


def totals() -> dict[str, tuple[int, int]]:
    """{span name: (count, nanoseconds)} since the process started."""
    return {name: (c, ns) for name, (c, ns) in _TOTALS.items()}


def report() -> dict[str, dict]:
    """{span name: {"count", "total_ms", "mean_ms"}}, longest total first."""
    rows = sorted(_TOTALS.items(), key=lambda kv: -kv[1][1])
    return {name: {"count": c, "total_ms": ns * 1e-6,
                   "mean_ms": ns * 1e-6 / c}
            for name, (c, ns) in rows}
