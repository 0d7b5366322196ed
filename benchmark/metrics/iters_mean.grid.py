"""iters_mean.grid: interior-point iterations per scenario, the mean of the
`iters` every solve of the window returned."""


def read(run):
    lanes = run.stats.get("lanes", 0)
    return run.stats["iters_sum"] / lanes if lanes else None
