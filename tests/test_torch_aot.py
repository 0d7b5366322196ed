"""The port's shipped solver (utils/aot.py, the counterpart of the JAX
package's jax.export artifact, tests/test_aux.py::test_aot_export_roundtrip)
on the CPU: the manifest round trip, the loaded solver equal to the live
solve bit for bit (also in a fresh interpreter that has no nvcc and builds
nothing), and each rejection: batch, dtype, a stale source hash, another
torch or CUDA version, another compute capability.  Exporting needs the
four kernel libraries: with no nvcc it raises ops/_build.py's error.  Here
the libraries are stand-in files (a CPU solve never loads them); the
round trip with the real ones runs on the card in chip_smoke.py."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.engine import batch as bm
from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.ops import _build
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.utils import aot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _scenarios(dtype=F64):
    """tests/test_aux.py's problem: 2 goals x 2 zero forces x 1 box."""
    rng = np.random.default_rng(2)
    goals = rng.uniform([-2, -2, 1.0], [2, 2, 1.5], (2, 3))
    return bm.make_scenarios(C, goals, np.zeros((2, 3)),
                             np.array([[4.0, 4.0, 1.5]]), dtype=dtype,
                             device="cpu")


def _stand_in_build(tmp):
    """ops/_build.py::build as a machine with nvcc would answer it, with a
    stand-in file at each library's path."""
    def build(*sources):
        out = {}
        for source in sources or _build.SOURCES:
            so = tmp / _build._paths(source)[1].name
            so.write_bytes(b"\x7fELF stand-in for " + source.encode())
            out[source] = _build.Built(path=so, seconds=0.0, ptxas_log="")
        return out
    return build


@pytest.fixture
def exported(tmp_path, monkeypatch):
    libs = tmp_path / "libs"
    libs.mkdir()
    monkeypatch.setattr(_build, "build", _stand_in_build(libs))
    monkeypatch.setattr(_build, "_prebuilt", {})
    sc = _scenarios()
    path = aot.export_batched_solver(C, batch=sc.batch, dtype=F64,
                                     path=tmp_path / "solver")
    return path, sc


def test_manifest_round_trip(exported):
    path, sc = exported
    m = aot.read_manifest(path)
    assert m["arch"] == "sm_90a" and m["compute_capability"] == [9, 0]
    assert m["torch"] == torch.__version__ and m["cuda"] == torch.version.cuda
    assert m["batch"] == sc.batch and m["dtype"] == "float64"
    assert aot.config_from_json(m["config"]) == C
    assert sorted(m["libraries"]) == sorted(_build.SOURCES)
    for source, lib in m["libraries"].items():
        assert lib["hash"] == _build.source_hash(source)
        assert lib["file"] == _build._paths(source)[1].name
        assert lib["sha256"] == aot._sha256(path / lib["file"])


@pytest.mark.parametrize("cfg", [workloads.bench_config(),
                                 workloads.small_cfg(), workloads.fleet_cfg()])
def test_config_json_round_trip(cfg):
    assert aot.config_from_json(json.loads(json.dumps(
        dataclasses.asdict(cfg)))) == cfg


def test_loaded_solver_equals_the_live_solve(exported):
    path, sc = exported
    got = aot.load_solver(path, device="cpu")(sc.Z0, sc.params)
    ref = ipm_lanes.solve_batch_lanes_tiered(sc.Z0, sc.params, C.model,
                                             C.solver)
    assert (ref.exit_code == 1).all()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for source, lib in aot.read_manifest(path)["libraries"].items():
        assert _build._prebuilt[source] == (path / lib["file"]).resolve()


def _edit(path, **changes):
    m = aot.read_manifest(path)
    for k, v in changes.items():
        if k == "hash":
            m["libraries"]["ipm_iteration.cu"]["hash"] = v
        else:
            m[k] = v
    (path / aot.MANIFEST).write_text(json.dumps(m))


@pytest.mark.parametrize("change, match", [
    ({"hash": "0" * 16}, "stale solver: ipm_iteration.cu"),
    ({"torch": "0.0.0"}, "exported with torch 0.0.0"),
    ({"cuda": "9.9"}, "exported with cuda 9.9"),
])
def test_load_rejects_a_manifest_of_another_build(exported, change, match):
    path, _ = exported
    _edit(path, **change)
    with pytest.raises(RuntimeError, match=match):
        aot.load_solver(path, device="cpu")
    assert _build._prebuilt == {}


@pytest.mark.parametrize("swap", ["contents", "file name"])
def test_load_rejects_a_library_that_is_not_the_exported_one(exported,
                                                             monkeypatch,
                                                             swap):
    path, _ = exported
    lib = aot.read_manifest(path)["libraries"]["corridor.cu"]
    if swap == "contents":
        (path / lib["file"]).write_bytes(b"\x7fELF another library")
        match = "corridor.cu: .* has sha256"
    else:
        other = "corridor_" + "0" * 16 + ".so"
        (path / lib["file"]).rename(path / other)
        m = aot.read_manifest(path)
        m["libraries"]["corridor.cu"]["file"] = other
        (path / aot.MANIFEST).write_text(json.dumps(m))
        match = "does not carry the manifest's source hash"
    # with the tree's sources absent, as on a machine the solver ships to
    monkeypatch.setattr(_build, "CSRC", path / "no-sources")
    with pytest.raises(RuntimeError, match=match):
        aot.load_solver(path, device="cpu")
    assert _build._prebuilt == {}


def test_load_rejects_another_compute_capability(exported, monkeypatch):
    path, _ = exported
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="compute capability"):
        aot.check_manifest(aot.read_manifest(path), "cuda")


def test_solver_rejects_another_batch_or_dtype(exported):
    path, sc = exported
    solver = aot.load_solver(path, device="cpu")
    wider = _scenarios()
    Z0 = torch.cat([wider.Z0, wider.Z0[:1]])
    params = ipm_lanes._map_params(lambda a: torch.cat([a, a[:1]]),
                                   wider.params)
    with pytest.raises(ValueError, match="exported for batch 4"):
        solver(Z0, params)
    f32 = _scenarios(torch.float32)
    with pytest.raises(ValueError, match="exported for float64"):
        solver(f32.Z0, f32.params)


def test_export_without_nvcc_raises_the_build_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        aot.export_batched_solver(C, batch=8, dtype=torch.float32,
                                  path=tmp_path / "solver")
    assert not (tmp_path / "solver" / aot.MANIFEST).exists()


def test_registered_library_loads_without_building(monkeypatch):
    # a shared library that is on every machine with torch stands in
    path = os.path.join(os.path.dirname(torch.__file__), "lib", "libc10.so")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_prebuilt", {})

    def no_build(*sources):
        raise AssertionError("built")
    monkeypatch.setattr(_build, "build", no_build)
    bound = []
    _build.register_prebuilt("tube_stage.cu", path)
    lib = _build.load("tube_stage.cu", bound.append)
    assert bound == [lib] and _build._libs["tube_stage.cu"] is lib
    _build.register_prebuilt("tube_stage.cu", path)       # the same: fine
    with pytest.raises(RuntimeError, match="already loaded"):
        _build.register_prebuilt("tube_stage.cu", __file__)
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build.register_prebuilt("missing.cu", path)


CHILD = """
import sys, torch
from forces_resilient_planner_tpu_torch.ops import _build
def no_build(*sources):
    raise AssertionError("the loaded solver built " + repr(sources))
_build.build = no_build
sys.path.insert(0, {tests!r})
from test_torch_aot import _scenarios
from forces_resilient_planner_tpu_torch.utils import aot
sc = _scenarios()
res = aot.load_solver({path!r}, device="cpu")(sc.Z0, sc.params)
torch.save(tuple(res), {out!r})
"""


def test_fresh_interpreter_without_nvcc_loads_the_solver(exported, tmp_path):
    path, sc = exported
    out = tmp_path / "res.pt"
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(
            tests=os.path.join(REPO, "tests"), path=str(path), out=str(out))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = ipm_lanes.solve_batch_lanes_tiered(sc.Z0, sc.params, C.model,
                                             C.solver)
    for g, r in zip(torch.load(out), ref):
        assert torch.equal(g, r)
