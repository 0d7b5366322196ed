"""launches_per_step.step: kernel launches per batched step, counted in the
profiler's trace of the traced calls."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.kernels / tr.calls
