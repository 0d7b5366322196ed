"""setup_s: seconds from the process's start to the first timed call (the
CUDA context, the kernels' libraries, the cell's inputs, its warm-up)."""


def read(run):
    return run.setup_s
