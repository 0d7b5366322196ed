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
    "forces_resilient_planner_tpu_torch.corridor.decomp",
    "forces_resilient_planner_tpu_torch.tube.lyapunov",
    "forces_resilient_planner_tpu_torch.ops.tube_kernel",
    "forces_resilient_planner_tpu_torch.ops.corridor_kernel",
])
def test_port_imports_no_jax(module):
    proc = _run(
        f"import sys, {module}; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))"
    )
    assert proc.returncode == 0, proc.stderr


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
