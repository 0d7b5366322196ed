"""rank_skew_pct.sweep: how unevenly the ranks' solves last, in %: (max -
min) / mean of the host ms per call in the program's span sweep.solve
(the rank's tiered solve of its shard, tiers rank-local), grown over the
window on each rank, over ranks 1.. alone.  Rank 0 is the harness's
process and carries the profiler in the traced run that reads this
metric, which slows its solve by 40-50% on the card; the other ranks run
the program alone."""


def read(run):
    ns = (run.stats.get("solve_ns") or [])[1:]
    if not ns:
        return None
    mean = sum(ns) / len(ns)
    return 100.0 * (max(ns) - min(ns)) / mean if mean > 0 else None
