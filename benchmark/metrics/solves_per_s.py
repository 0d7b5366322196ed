"""solves_per_s: scenarios solved (exit code 1) over the window, which
runs from the first call's start to the last call's end."""


def read(run):
    return run.ok / run.window_s
