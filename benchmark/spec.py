"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of "workloads") names a configuration and a traffic mix.
Each piece sits in a file of its own, found by its name:
  configuration   the "file" of its entry in "configs"
  traffic mix     benchmark/traffic/<traffic>.json; its "kind" names the
                  generator and driving loop, benchmark/kinds/<kind>.py
  limits          benchmark/limits/<cell>.json: each number the comparison
                  with the reference reads, and its limit
  metric          benchmark/metrics/<metric>.py: read(run) -> number or
                  None, and the program counters it reads, if any
so a cell, a mix of a known kind, a configuration or a metric is added by
new files and entries alone.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


def load(path: Path = SPEC) -> dict:
    return json.loads(Path(path).read_text())


def _entry(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "traffic" / f"{name}.json"


def limits_path(cell: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "limits" / f"{cell}.json"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{name}.py"


def kind_path(kind: str) -> Path:
    return HERE / "kinds" / f"{kind}.py"


def metrics_for(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of `cell` reports: its end-to-end metrics
    with trace off (one without a "workloads" key belongs to every cell),
    the per-layer ones that list it under "workloads" with trace on."""
    if not trace:
        return [m for m in spec["end_to_end"]
                if cell in m.get("workloads", [cell])]
    for m in spec["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} lists no "
                           f"\"workloads\" in BENCHMARK.json")
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict           # the configuration file as it is run
    traffic_name: str
    traffic: dict          # the traffic mix's parameters
    limits: dict           # number -> limit
    e2e: list
    per_layer: list
    root: Path = ROOT


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files under root."""
    spec = load(root / "BENCHMARK.json")
    w = _entry(spec["workloads"], name, "workload")
    c = _entry(spec["configs"], w["config"], "configuration")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=c["name"],
        config=_json(root / c["file"]), traffic_name=w["traffic"],
        traffic=_json(traffic_path(w["traffic"], root)),
        limits=_json(limits_path(name, root)),
        e2e=metrics_for(spec, name, False),
        per_layer=metrics_for(spec, name, True), root=root)


def kind(name: str):
    """The module that generates and drives a traffic kind."""
    if not kind_path(name).is_file():
        raise FileNotFoundError(f"no traffic kind {name!r}: {kind_path(name)}")
    return importlib.import_module(f"benchmark.kinds.{name}")


def metric(name: str, root: Path = ROOT):
    """A metric's own module: read(run) -> number or None, and optionally
    counters() -> {name: number}, the program's counters it reads, which
    the run reads before and after the window (run.counters: the growth)."""
    path = metric_path(name, root)
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    mod_name = "benchmark.metrics._" + name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_config(config: dict):
    """The program's PlannerConfig for a configuration file: each group of
    the file replaces the same group of the program's defaults, field by
    field; a field the program does not have is an error."""
    from forces_resilient_planner_tpu_torch import config as pc

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    cfg = pc.PlannerConfig()
    for group, values in config["groups"].items():
        base = getattr(cfg, group)
        known = {f.name for f in dataclasses.fields(base)}
        extra = set(values) - known
        if extra:
            raise KeyError(f"{group}: the program has no field {sorted(extra)}")
        cfg = dataclasses.replace(cfg, **{group: dataclasses.replace(
            base, **{k: tup(v) for k, v in values.items()})})
    return cfg
