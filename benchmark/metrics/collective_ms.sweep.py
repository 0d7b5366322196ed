"""collective_ms.sweep: device ms per traced call in rank 0's collective
kernels, every kernel whose name starts with "nccl" (NCCL's
ncclDevKernel_<op>: the all-reduces of parallel/mesh.py::all_reduce_stats,
the all_gather of gather_results and, on sampled calls, that of the
sampled controls), less the "nccl:<op>" ranges torch's profiler lays over
them on the device, which are no kernels.  A collective's kernel runs
until the last rank has joined it, so the time includes rank 0's wait for
the slowest rank."""

PREFIX = "nccl"
RANGE = "nccl:"


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    times = [t for name, (_, t) in tr.by_kernel.items()
             if name.startswith(PREFIX) and not name.startswith(RANGE)]
    return 1e3 * sum(times) / tr.calls if times else None
