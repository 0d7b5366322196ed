"""launches_per_call.latency: kernel launches per call, counted in the
profiler's trace of the traced calls."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.kernels / tr.calls
