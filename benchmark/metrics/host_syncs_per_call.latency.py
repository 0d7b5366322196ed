"""host_syncs_per_call.latency: runtime calls per call that make the host
wait for the device (stream, device and event synchronizations and
synchronous copies), counted in the profiler's trace."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.syncs / tr.calls
