"""ipm_roofline.grid's arithmetic against a count by hand at N = 2, and the
trace's summary of every kernel."""
from types import SimpleNamespace

import pytest

from benchmark import spec, yardstick


def test_k1_flops_by_hand():
    # N = 2: one gap stage.  Factor: 2 * (2*13^3 + 2*4*13*13 + 4*4*13
    # + 2*4*91 + 9*30) multiply-adds; solve: 3*169 + 2*52 + 52 + 52;
    # dynamics 81*9 + 36*9; per stage 2*(2*3*30 + 13*9 + 169) + 64*12*3.
    factor = 2 * (2 * 2197 + 2 * 4 * 169 + 16 * 13 + 2 * 4 * 91 + 270)
    solve = 2 * (3 * 169 + 104 + 52 + 52)
    dyn = 2 * (729 + 324)
    stage = 2 * (180 + 117 + 169) + 2304
    assert yardstick.k1_flops(2) == factor + solve + dyn + 2 * stage


def test_solve_bytes_by_hand():
    # N = 2, nh = 2: inputs 34 + 9 + 6 + 2 + 3 + 12 + 4 + 10 = 80,
    # outputs 34 + 26 + 2 * 2 * 36 + 3 = 207 values of 4 bytes
    assert yardstick.solve_bytes(2, 2, 4) == (80 + 207) * 4


def test_roofline_reader_by_hand():
    read = spec.metric("ipm_roofline.grid").read
    st = dict(iters_sum=3 * 10, lanes=3, N=2, nh=2, itemsize=4)
    flops = 30 * yardstick.k1_flops(2)
    nbytes = 3 * (80 + 207) * 4
    least = max(flops / 67e12, nbytes / 3.35e12)
    run = SimpleNamespace(stats=st, trace=SimpleNamespace(kernel_s=2e-6))
    assert read(run) == pytest.approx(100 * least / 2e-6, rel=1e-12)
    assert read(SimpleNamespace(stats=st, trace=None)) is None


def test_trace_summary_keeps_every_kernel():
    """The Summary keeps every kernel's launches and time, so a metric of
    any kernel can be read from it; the breakdown's list is cut to TOP."""
    from benchmark import trace

    by_kernel = {f"k{i}": (i + 1, 1e-3 * (i + 1)) for i in range(trace.TOP + 2)}
    s = trace.Summary(window_s=1.0, busy_s=0.5, by_kernel=by_kernel,
                      syncs=0, calls=1, idle_gaps=[])
    assert s.kernels == sum(range(1, trace.TOP + 3))
    assert s.kernel_s == pytest.approx(1e-3 * sum(range(1, trace.TOP + 3)))
    assert [n for n, _ in s.device_ops] == [
        f"k{i}" for i in range(trace.TOP + 1, 1, -1)]
