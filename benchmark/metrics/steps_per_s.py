"""steps_per_s: robot-steps completed (every robot of every call) over the
window, which runs from the first call's start to the last call's end."""


def read(run):
    return run.attempted / run.window_s
