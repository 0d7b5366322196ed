"""The idle share of rank 0's card over the traced window in %: 1 - the
union of its kernels', copies' and sets' intervals over the window."""
from benchmark.trace import idle_pct as read  # noqa: F401
