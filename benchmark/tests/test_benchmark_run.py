"""A run's outward behaviour: no card means no result and a non-zero exit,
the last line carries exactly the contract's keys, and nothing the harness
or the reference loads is JAX or the JAX package."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import spec

ROOT = spec.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
TINY = {"grid-4096": dict(goals=2, forces=2, check_calls=1, check_lanes=2,
                          warm_calls=0, trace_calls=1),
        "step-4096": dict(robots=2, pool=1, cloud=24, check_calls=1,
                          check_robots=1, warm_calls=0, trace_calls=1,
                          chunk=2),
        "step-1": dict(pool=2, cloud=24, check_calls=2, warm_calls=0,
                       trace_calls=1),
        "api-1": dict(pool=2, check_calls=2, warm_calls=0, trace_calls=1)}


def tiny(name):
    c = spec.cell(name)
    c.traffic = dict(c.traffic, **TINY[name])
    return c


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "grid-4096",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    from benchmark import run

    result, checks = run.run_cell(tiny("grid-4096"), 2 ** 31 + 9, 0.0,
                                  traced, "cpu")
    # on the CPU the trace holds no device activity: no breakdown
    assert list(result) == KEYS + ["checks"]
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == set(checks)
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.loads(json.dumps(result, allow_nan=False))


def test_no_jax_loaded_whole_names():
    """Every module of the benchmark imported and a cell of each kind run in
    one process: no top-level jax, jaxlib, flax or the JAX package, while
    the port (whose name begins with the JAX package's) is loaded."""
    code = f"""
import importlib, pkgutil, sys, json
sys.path.insert(0, {str(ROOT)!r})
import benchmark, benchmark.run as run, benchmark.control
from benchmark import spec
for m in pkgutil.walk_packages(benchmark.__path__, "benchmark."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
for p in (spec.HERE / "metrics").glob("*.py"):
    mod = spec.metric(p.stem)
    if hasattr(mod, "counters"):
        mod.counters()
tiny = {TINY!r}
for name in tiny:
    c = spec.cell(name)
    c.traffic = dict(c.traffic, **tiny[name])
    run.run_cell(c, 11, 0.0, False, "cpu")
print(json.dumps([run.forbidden_modules(),
                  "forces_resilient_planner_tpu_torch" in sys.modules]))
"""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    found, port = json.loads(p.stdout.strip().splitlines()[-1])
    assert found == [] and port


def test_forbidden_names_compare_whole():
    from benchmark import run

    sys.modules.setdefault("forces_resilient_planner_tpu_torch_x", sys)
    try:
        assert "forces_resilient_planner_tpu" not in run.forbidden_modules()
        sys.modules["jaxlib.fake"] = sys
        assert run.forbidden_modules() == ["jaxlib"]
    finally:
        sys.modules.pop("jaxlib.fake", None)
        sys.modules.pop("forces_resilient_planner_tpu_torch_x", None)
