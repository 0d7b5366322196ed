"""What the profiler saw of a traced window: device busy time, launches,
host syncs, the longest device operations and the longest idle gaps.

The arithmetic is a frozen copy, taken at commit ad340bc, of
forces_resilient_planner_tpu_torch/tools/closed_loop_probe.py (kernel
launches per unit of work; device busy time from the kernels' intervals),
with two changes: busy time is the union of every device activity's
interval (kernels, copies, sets), not the sum of the kernels' durations,
and the window is the traced calls' own span.  Events come straight from
the profiler's raw results, which are not turned into Python event trees.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

SPAN = "bench."                 # the benchmark's own spans (record_function)
COPY_SET = ("Memcpy", "Memset")      # device activity that is no kernel
# runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
TOP = 10
NAME_CHARS = 160               # kernel names are cut to this length


def span(name: str):
    """A span of the benchmark's own, seen by the profiler when it runs."""
    return torch.profiler.record_function(SPAN + name)


@contextlib.contextmanager
def profiled(on: bool, device):
    """torch.profiler over the block when `on` (CPU and, on a card, CUDA
    activity); yields the profiler or None."""
    if not on:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


@dataclasses.dataclass
class Summary:
    window_s: float      # first traced call's start to the last one's end
    busy_s: float        # union of device activity inside the window
    by_kernel: dict      # every kernel's name -> (launches, seconds summed)
    syncs: int           # runtime calls that wait for the device
    calls: int           # traced calls
    idle_gaps: list      # [[host span / host op at the gap, seconds]]

    @property
    def kernels(self) -> int:
        """Kernel launches that ran in the window."""
        return sum(n for n, _ in self.by_kernel.values())

    @property
    def kernel_s(self) -> float:
        """The sum of those kernels' durations."""
        return sum(t for _, t in self.by_kernel.values())

    @property
    def device_ops(self) -> list:
        """[[kernel name, seconds summed]] of the TOP longest, longest first
        (the breakdown's list)."""
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1][1])[:TOP]
        return [[name[:NAME_CHARS], t] for name, (_, t) in top]


def _kind(e) -> str:
    """device (a kernel, copy or set on the card), span (the benchmark's
    own, host side), runtime (a CUDA runtime call) or op (any other host
    event).  The device's copies of the benchmark's spans are none."""
    name = e.name()
    if e.device_type() != torch.autograd.DeviceType.CPU:
        return "none" if name.startswith(SPAN) else "device"
    if name.startswith(SPAN):
        return "span"
    return "runtime" if name.startswith("cuda") else "op"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_at(t, spans, ops):
    """The innermost benchmark span and host operator running at t."""
    def inner(evs):
        best = None
        for s, e, name in evs:
            if s <= t < e and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else "none"
    return f"{inner(spans)}/{inner(ops)}"


def summarize(prof, call_span: str = "call") -> Summary | None:
    """The traced window's Summary, or None when the trace holds no
    device activity (nothing to read)."""
    events = prof.profiler.kineto_results.events()
    calls, spans, ops, dev, kernels, syncs = [], [], [], [], {}, 0
    for e in events:
        name, kind = e.name(), _kind(e)
        s = e.start_ns()
        t = s + e.duration_ns()
        if kind == "device":
            dev.append((s, t))
            if not name.startswith(COPY_SET):
                kernels.setdefault(name, []).append(t - s)
        elif kind == "span":
            spans.append((s, t, name))
            if name == SPAN + call_span:
                calls.append((s, t))
        elif kind == "runtime":
            syncs += name in SYNC_CALLS
        elif kind == "op":
            ops.append((s, t, name))
    if not calls or not dev:
        return None
    w0, w1 = min(s for s, _ in calls), max(t for _, t in calls)
    busy = _merge((max(s, w0), min(t, w1)) for s, t in dev
                  if t > w0 and s < w1)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((w1 - prev, prev))
    gaps = sorted(gaps, reverse=True)[:TOP]
    return Summary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        by_kernel={n: (len(d), sum(d) * 1e-9) for n, d in kernels.items()},
        syncs=syncs, calls=len(calls),
        idle_gaps=[[_host_at(t, spans, ops), g * 1e-9] for g, t in gaps],
    )


def idle_pct(run) -> float | None:
    """100 (1 - busy / window) of the traced window."""
    tr = run.trace
    return None if tr is None else 100.0 * (1.0 - tr.busy_s / tr.window_s)
