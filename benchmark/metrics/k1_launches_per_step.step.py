"""k1_launches_per_step.step: launches of the IPM kernel K1 per batched
step, from the growth of the program's counter ipm_kernel.LAUNCHES."""


def counters():
    from forces_resilient_planner_tpu_torch.ops import ipm_kernel

    return {"k1_launches": ipm_kernel.LAUNCHES}


def read(run):
    return run.counters["k1_launches"] / run.calls
