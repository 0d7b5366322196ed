"""host_steps_per_call.grid: steps of the solver's host loop
(ipm_lanes._run_lanes, one device read each) per call, from the growth of
the program's counter ipm_lanes.STEPS over the window."""


def counters():
    from forces_resilient_planner_tpu_torch.solver import ipm_lanes

    return {"ipm_steps": ipm_lanes.STEPS}


def read(run):
    return run.counters["ipm_steps"] / run.calls
