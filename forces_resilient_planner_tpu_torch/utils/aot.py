"""A shipped solver: the batched solve with its kernels prebuilt (torch).

Port of forces_resilient_planner_tpu/utils/aot.py, the FORCES-codegen
analog.  The reference's solver is generated out of band and ships as a
compiled library with the robot (plan_manage/matlab_code/
generate_solver.m); the JAX package ships a serialized `jax.export`
artifact.  The port compiles its CUDA kernels with nvcc at first use
(ops/_build.py), so a machine without the CUDA toolkit cannot build them.
`export_batched_solver` writes a directory with the four prebuilt kernel
libraries and a manifest; `load_solver` runs the batched solve on them
and never calls nvcc:

    # offline, on a machine with nvcc (the generate_solver.m analog)
    export_batched_solver(cfg, batch=4096, dtype=torch.float32,
                          path="solver_b4096")

    # on the robot or the sweep node: the same torch, CUDA and card
    solver = load_solver("solver_b4096", device="cuda")
    res = solver(Z0, params)     # a SolveResult, as solve_batch_lanes_tiered

The manifest records, for each library, the hash of its source, headers
and flags (ops/_build.py::source_hash, the hash in its file name) and
the sha256 of the library itself, the arch (sm_90a), the torch and CUDA
versions, the configuration, the batch and the dtype.  `load_solver`
raises on any mismatch with the running process (torch, CUDA, the card's
compute capability, and the sources' hash when the tree's sources are
present) and on any library whose file name does not carry its source
hash or whose contents are not the ones exported, and the solver it returns
raises on any other batch or dtype, as the JAX artifact's `exp.call`
does.  It never rebuilds and has no fallback.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
from pathlib import Path
from typing import Callable

import torch

from forces_resilient_planner_tpu_torch.config import (
    DEFAULT_CONFIG,
    PlannerConfig,
)
from forces_resilient_planner_tpu_torch.ops import _build
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.solver.ipm import SolveResult
from forces_resilient_planner_tpu_torch.solver.nlp import NLPParams

MANIFEST = "manifest.json"
ARCH = "sm_90a"
CAPABILITY = (9, 0)        # the only compute capability sm_90a code runs on
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _dtype_name(dtype) -> str:
    for name, d in _DTYPES.items():
        if d == dtype:
            return name
    raise ValueError(f"the solver runs at float32 or float64, not {dtype}")


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _sha256(path: Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def config_from_json(d: dict) -> PlannerConfig:
    """The PlannerConfig whose dataclasses.asdict was written as JSON (its
    lists back to the dataclasses' tuples)."""
    return PlannerConfig(**{
        f.name: type(getattr(DEFAULT_CONFIG, f.name))(
            **{k: _tuples(v) for k, v in d[f.name].items()})
        for f in dataclasses.fields(PlannerConfig)
    })


def export_batched_solver(cfg: PlannerConfig, batch: int,
                          dtype=torch.float32, path="solver") -> Path:
    """Write the solver directory at `path`: the four kernel libraries
    (built here with nvcc when not cached; ops/_build.py raises without
    it) and the manifest.  Returns the directory."""
    name = _dtype_name(dtype)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    libraries = {}
    for source, built in _build.build().items():
        shutil.copyfile(built.path, out / built.path.name)
        libraries[source] = {"file": built.path.name,
                             "hash": _build.source_hash(source),
                             "sha256": _sha256(built.path)}
    manifest = {
        "arch": ARCH,
        "compute_capability": list(CAPABILITY),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "libraries": libraries,
        "config": dataclasses.asdict(cfg),
        "batch": int(batch),
        "dtype": name,
    }
    (out / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return out


def read_manifest(path) -> dict:
    return json.loads((Path(path) / MANIFEST).read_text())


def check_manifest(manifest: dict, device) -> None:
    """Raise RuntimeError unless the manifest's libraries can run in this
    process on `device`."""
    device = torch.device(device)
    for key, have in (("torch", torch.__version__),
                      ("cuda", torch.version.cuda)):
        if manifest[key] != have:
            raise RuntimeError(
                f"solver exported with {key} {manifest[key]}, this process "
                f"has {have}: export it again with this one")
    if set(manifest["libraries"]) != set(_build.SOURCES):
        raise RuntimeError(
            f"solver libraries {sorted(manifest['libraries'])}, the port "
            f"needs {sorted(_build.SOURCES)}")
    for source, lib in manifest["libraries"].items():
        if (_build.CSRC / source).is_file():
            have = _build.source_hash(source)
            if lib["hash"] != have:
                raise RuntimeError(
                    f"stale solver: {source} was built from sources hashed "
                    f"{lib['hash']}, the tree's hash {have}")
    if device.type == "cuda":
        cap = torch.cuda.get_device_capability(device)
        if tuple(cap) != tuple(manifest["compute_capability"]):
            raise RuntimeError(
                f"solver built for {manifest['arch']} (compute capability "
                f"{manifest['compute_capability']}), the card is {cap}")


def check_libraries(manifest: dict, path) -> None:
    """Raise RuntimeError unless each library in the directory at `path` is
    the one exported: its file name carries its source hash and its
    contents have the manifest's sha256."""
    for source, lib in manifest["libraries"].items():
        want = f"{Path(source).stem}_{lib['hash']}.so"
        if lib["file"] != want:
            raise RuntimeError(
                f"{source}: library file {lib['file']} does not carry the "
                f"manifest's source hash (expected {want})")
        have = _sha256(Path(path) / lib["file"])
        if have != lib["sha256"]:
            raise RuntimeError(
                f"{source}: {lib['file']} has sha256 {have}, the exported "
                f"library {lib['sha256']}: export the solver again")


def load_solver(path, *, device) -> Callable:
    """The exported solver at `path` on `device`: fn(Z0, params) ->
    SolveResult, which runs solve_batch_lanes_tiered with the exported
    configuration on the prebuilt kernel libraries (on a CPU device, the
    plain versions, as everywhere in the port)."""
    path = Path(path)
    manifest = read_manifest(path)
    check_manifest(manifest, device)
    check_libraries(manifest, path)
    for source, lib in manifest["libraries"].items():
        _build.register_prebuilt(source, path / lib["file"])
    cfg = config_from_json(manifest["config"])
    batch, dtype = manifest["batch"], _DTYPES[manifest["dtype"]]
    device = torch.device(device)

    def run(Z0: torch.Tensor, params: NLPParams) -> SolveResult:
        tensors = [Z0, *params[:-1], *params.weights]
        if Z0.shape[0] != batch or any(t.shape[0] != batch for t in tensors):
            raise ValueError(
                f"solver exported for batch {batch}, called with "
                f"{Z0.shape[0]}")
        if any(t.dtype != dtype for t in tensors):
            raise ValueError(
                f"solver exported for {manifest['dtype']}, called with "
                f"{sorted({str(t.dtype) for t in tensors})}")
        if any(t.device.type != device.type for t in tensors):
            raise ValueError(f"solver loaded for {device}, called with "
                             f"tensors on {Z0.device}")
        return ipm_lanes.solve_batch_lanes_tiered(Z0, params, cfg.model,
                                                  cfg.solver)

    return run
