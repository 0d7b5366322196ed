"""ipm_roofline.grid: the least time an H100 needs for the solves' work
over the device time of every kernel the traced calls launched, in %.
The work: the lane-iterations run (the sum of `iters`) times one IPM
iteration's operations (yardstick.k1_flops), and every lane's inputs read
once and outputs written once (yardstick.solve_bytes); the bound is the
larger of the two against the published peaks.  The same work is read
whatever runs it."""
from benchmark import yardstick


def read(run):
    tr, st = run.trace, run.stats
    if tr is None or not tr.kernel_s or not st.get("iters_sum"):
        return None
    flops = st["iters_sum"] * yardstick.k1_flops(st["N"])
    nbytes = st["lanes"] * yardstick.solve_bytes(st["N"], st["nh"],
                                                 st["itemsize"])
    least, _ = yardstick.least_seconds(nbytes, flops)
    return 100.0 * least / tr.kernel_s
