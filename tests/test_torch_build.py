"""The port's import hygiene, its kernel build's failure mode without a CUDA
toolkit, and chip_smoke.py's refusal to report without a GPU."""
import os
import subprocess
import sys

import pytest

from forces_resilient_planner_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, timeout=300):
    args = (code_or_args if isinstance(code_or_args, list)
            else [sys.executable, "-c", code_or_args])
    return subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("module", [
    "forces_resilient_planner_tpu_torch.config",
    "forces_resilient_planner_tpu_torch.engine.batch",
    "forces_resilient_planner_tpu_torch.engine.reference",
    "forces_resilient_planner_tpu_torch.engine.pipeline",
    "forces_resilient_planner_tpu_torch.engine.pipeline_batch",
    "forces_resilient_planner_tpu_torch.engine.workloads",
    "forces_resilient_planner_tpu_torch.corridor.decomp",
    "forces_resilient_planner_tpu_torch.tube.lyapunov",
    "forces_resilient_planner_tpu_torch.ops.tube_kernel",
    "forces_resilient_planner_tpu_torch.ops.corridor_kernel",
    "forces_resilient_planner_tpu_torch.ops.ipm_kernel",
    "forces_resilient_planner_tpu_torch.ops.lqr_kernel",
    "forces_resilient_planner_tpu_torch.solver.ipm_lanes",
    "forces_resilient_planner_tpu_torch.solver.riccati",
    "forces_resilient_planner_tpu_torch.solver.problems",
    "forces_resilient_planner_tpu_torch.tools.k1_phase_probe",
])
def test_port_imports_no_jax(module):
    """Neither jax nor any module of the JAX package is loaded."""
    proc = _run(
        f"import sys, {module}; "
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'forces_resilient_planner_tpu' "
        "or m.startswith('forces_resilient_planner_tpu.')); "
        "assert not bad, bad"
    )
    assert proc.returncode == 0, proc.stderr


def _imported_modules(path):
    """Every module an `import` or `from ... import` names in the file, at
    any depth (inside functions too)."""
    import ast

    names = set()
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_chip_smoke_imports_no_bench_graft_entry_or_jax_package():
    names = _imported_modules(os.path.join(REPO, "chip_smoke.py"))
    assert "forces_resilient_planner_tpu_torch.engine" in names
    for name in names:
        root = name.split(".")[0]
        assert root not in ("bench", "__graft_entry__", "jax",
                            "forces_resilient_planner_tpu"), name


def test_k23_probe_imports_no_jax_and_refuses_without_a_gpu():
    """The root probe of K2 and K3 names no JAX module, and without a card it
    stops before it times anything."""
    for name in _imported_modules(os.path.join(REPO, "k23_probe.py")):
        assert name.split(".")[0] not in (
            "jax", "forces_resilient_planner_tpu", "bench",
            "__graft_entry__"), name
    proc = _run([sys.executable, "k23_probe.py", "--reps", "1"])
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    assert '"card"' not in proc.stdout


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("source", _build.SOURCES)
def test_build_of_each_source_raises_without_nvcc(monkeypatch, tmp_path,
                                                  source):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert (_build.CSRC / source).is_file()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(source)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(source, lambda lib: None)
    assert not (tmp_path / "build").exists()


def test_every_kernel_source_is_built_and_hashed_with_the_header():
    on_disk = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert on_disk == sorted(_build.SOURCES)
    src, so, log = _build._paths("tube_stage.cu")
    assert so.parent == _build.BUILD_DIR and so.name.startswith("tube_stage_")
    assert '#include "common.cuh"' in src.read_text()
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build._paths("missing.cu")


def test_riccati_kernels_share_the_header_and_rebuild_with_it(monkeypatch,
                                                              tmp_path):
    """lqr.cu (K4, K5) and ipm_iteration.cu (K1) include riccati.cuh; a
    library's name changes with any header's contents."""
    assert "lqr.cu" in _build.SOURCES
    for source in ("lqr.cu", "ipm_iteration.cu"):
        assert '#include "riccati.cuh"' in (_build.CSRC / source).read_text()
    assert '#include "common.cuh"' in (_build.CSRC / "riccati.cuh").read_text()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._paths("lqr.cu")[1].name
    assert before == _build._paths("lqr.cu")[1].name
    (csrc / "riccati.cuh").write_text(
        (csrc / "riccati.cuh").read_text() + "\n// edited\n")
    assert _build._paths("lqr.cu")[1].name != before


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the repo reports nothing."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    proc = _run([sys.executable, "chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
