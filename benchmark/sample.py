"""Which answers of a window the reference checks: a uniform sample of the
calls, drawn from the seed (reservoir sampling), and in each sampled call
a few of its lanes."""
from __future__ import annotations

import numpy as np


class Reservoir:
    """Keeps `size` of the calls offered, each call equally likely."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.kept = size, rng, 0, []

    def offer(self, make) -> None:
        """make() builds the call's record; it runs only for a kept call."""
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(make())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.kept[j] = make()


def worst(values) -> float:
    """The largest of the values; inf where one is not finite or where
    there are none (nothing compared is no pass)."""
    v = np.asarray(list(values), dtype=np.float64)
    if v.size == 0 or not np.isfinite(v).all():
        return float("inf")
    return float(v.max())

