"""The configuration as the reference reads it: the groups of a
configuration file under benchmark/configs/, each a namespace of its
fields, with the model's derived thrust limits.  Nothing here comes from
the program: the file is the one source both sides are built from."""
from __future__ import annotations

from types import SimpleNamespace


def _ns(values: dict) -> SimpleNamespace:
    return SimpleNamespace(**{
        k: tuple(tuple(r) if isinstance(r, list) else r for r in v)
        if isinstance(v, list) else v
        for k, v in values.items()})


def from_groups(groups: dict) -> SimpleNamespace:
    """{group: {field: value}} -> namespace of group namespaces; the model
    gains min_thrust, max_thrust and hover_thrust (setup.m:26-28)."""
    cfg = SimpleNamespace(**{g: _ns(v) for g, v in groups.items()})
    m = cfg.model
    m.hover_thrust = m.mass * m.g
    m.min_thrust = m.min_thrust_factor * m.hover_thrust
    m.max_thrust = m.max_thrust_factor * m.hover_thrust
    return cfg
