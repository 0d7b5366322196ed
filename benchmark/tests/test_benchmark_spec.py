"""BENCHMARK.json keeps to the benchmark contract's shapes, and every cell
finds its configuration, traffic, limits, kind and metric files by name."""
import json
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = spec.load()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert len(spec.SPEC.read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(name):
    c = spec.cell(name)
    assert spec.kind_path(c.traffic["kind"]).is_file()
    assert spec.kind(c.traffic["kind"]).Loop
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert {m["name"] for m in c.e2e} >= {"setup_s"} and len(c.e2e) >= 2
    assert c.per_layer
    for m in c.e2e + c.per_layer:
        assert callable(spec.metric(m["name"]).read)
    cfg = spec.program_config(c.config)
    assert cfg.model.N == c.config["groups"]["model"]["N"]


def test_a_cell_added_as_data_alone_runs(tmp_path):
    """A new cell with a new traffic mix of a known kind, its limits, a
    new configuration file and a new metric reader: files and entries
    only, found and run (on the CPU, at a tiny size)."""
    from benchmark import run

    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    s = json.loads(spec.SPEC.read_text())
    cfg = json.loads((spec.ROOT / "benchmark/configs/mc-grid.json").read_text())
    cfg["groups"]["solver"]["max_iters"] = 40
    (root / "benchmark/configs/mc-grid-40.json").write_text(json.dumps(cfg))
    s["configs"].append({"name": "mc-grid-40", "source": "https://example.org",
                         "file": "benchmark/configs/mc-grid-40.json",
                         "reduced": ["solver"], "why": "a test"})
    traffic = json.loads(spec.traffic_path("grid-256x16").read_text())
    traffic.update(goals=2, forces=2, check_calls=1, check_lanes=2,
                   warm_calls=0, trace_calls=1)
    (root / "benchmark/traffic/grid-2x2.json").write_text(json.dumps(traffic))
    (root / "benchmark/limits/grid-tiny.json").write_text(
        json.dumps({"exit_mismatch_share": 0.5, "du_max": 1.0}))
    (root / "benchmark/metrics/calls_seen.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    (root / "benchmark/metrics/host_steps_seen.py").write_text(
        "def counters():\n"
        "    from forces_resilient_planner_tpu_torch.solver import ipm_lanes\n"
        "    return {'steps_seen': ipm_lanes.STEPS}\n\n\n"
        "def read(run):\n    return float(run.counters['steps_seen'])\n")
    s["workloads"].append({"name": "grid-tiny", "config": "mc-grid-40",
                           "traffic": "grid-2x2", "chips": 1, "why": "a test"})
    s["per_layer"].append({"name": "calls_seen", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry", "moves": "solves_per_s",
                           "workloads": ["grid-tiny"]})
    s["per_layer"].append({"name": "host_steps_seen", "unit": "steps",
                           "better": "lower", "source": "program_counter",
                           "layer": "entry", "moves": "solves_per_s",
                           "workloads": ["grid-tiny"]})
    s["end_to_end"][1]["workloads"].append("grid-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(s))

    c = spec.cell("grid-tiny", root)
    assert c.traffic["goals"] == 2 and c.config["groups"]["solver"]["max_iters"] == 40
    assert [m["name"] for m in c.per_layer] == ["calls_seen",
                                                 "host_steps_seen"]
    result, _ = run.run_cell(c, 7, 0.0, True, "cpu")
    assert result["metrics"]["calls_seen"]["value"] == 1.0
    # the program's counter grew by the window's host steps alone
    assert result["metrics"]["host_steps_seen"]["value"] >= 1.0
    result, _ = run.run_cell(c, 7, 0.0, False, "cpu")
    assert set(result["metrics"]) == {"setup_s", "solves_per_s"}


def test_per_layer_metric_without_workloads_is_refused():
    s = json.loads(spec.SPEC.read_text())
    s["per_layer"][0].pop("workloads")
    with pytest.raises(KeyError, match="workloads"):
        spec.metrics_for(s, "grid-4096", True)
