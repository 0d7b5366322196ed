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


PORT_MODULES = [
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
    "forces_resilient_planner_tpu_torch.tools.k4_phase_probe",
    "forces_resilient_planner_tpu_torch.engine.commander",
    "forces_resilient_planner_tpu_torch.engine.simulator",
    "forces_resilient_planner_tpu_torch.engine.depth_camera",
    "forces_resilient_planner_tpu_torch.engine.scenarios",
    "forces_resilient_planner_tpu_torch.engine.fleet",
    "forces_resilient_planner_tpu_torch.engine.planner",
    "forces_resilient_planner_tpu_torch.utils.timing",
    "forces_resilient_planner_tpu_torch.utils.scene",
    "forces_resilient_planner_tpu_torch.corridor.geometry",
    "forces_resilient_planner_tpu_torch.corridor.msgs",
    "forces_resilient_planner_tpu_torch.estimation",
    "forces_resilient_planner_tpu_torch.estimation.force_estimator",
    "forces_resilient_planner_tpu_torch.mapping.occ_grid",
    "forces_resilient_planner_tpu_torch.search.kinodynamic",
    "forces_resilient_planner_tpu_torch.tools.closed_loop_probe",
    "forces_resilient_planner_tpu_torch.dynamics.quadrotor",
    "forces_resilient_planner_tpu_torch.solver.nlp",
    "forces_resilient_planner_tpu_torch.solver.forces_api",
    "forces_resilient_planner_tpu_torch.tube.lyapunov",
    "forces_resilient_planner_tpu_torch.utils.checkpoint",
    "forces_resilient_planner_tpu_torch.parallel.mesh",
    "forces_resilient_planner_tpu_torch.entry",
    "forces_resilient_planner_tpu_torch.corridor.variants",
    "forces_resilient_planner_tpu_torch.oracle.cpu_oracle",
    "forces_resilient_planner_tpu_torch.examples.forces_api_migration",
    "forces_resilient_planner_tpu_torch.examples.config5_monte_carlo",
    "forces_resilient_planner_tpu_torch.ops._build",
    "forces_resilient_planner_tpu_torch.solver.ipm",
    "forces_resilient_planner_tpu_torch.utils.lanes",
    "forces_resilient_planner_tpu_torch.utils.rounding",
    "forces_resilient_planner_tpu_torch.utils.aot",
    "forces_resilient_planner_tpu_torch.oracle.pool",
    "forces_resilient_planner_tpu_torch.tools.parity_certificate",
    "forces_resilient_planner_tpu_torch.tools.stress_oracle",
    "forces_resilient_planner_tpu_torch.examples.config1_hover_to_goal",
    "forces_resilient_planner_tpu_torch.examples.config2_constant_force",
    "forces_resilient_planner_tpu_torch.examples.config3_obstacle_scene",
    "forces_resilient_planner_tpu_torch.examples.config4_batched",
    "forces_resilient_planner_tpu_torch.examples.config6_fleet",
]


@pytest.fixture(scope="module")
def imports():
    """Each module imported in a fresh interpreter of its own, 8 at a time:
    {module: the finished process}."""
    from concurrent.futures import ThreadPoolExecutor

    def check(module):
        return _run(
            f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'forces_resilient_planner_tpu' "
            "or m.startswith('forces_resilient_planner_tpu.')); "
            "assert not bad, bad"
        )
    with ThreadPoolExecutor(8) as pool:
        return dict(zip(PORT_MODULES, pool.map(check, PORT_MODULES)))


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_imports_no_jax(module, imports):
    """Neither jax nor any module of the JAX package is loaded."""
    proc = imports[module]
    assert proc.returncode == 0, proc.stderr


def _port_modules():
    """Every module file of the port, as a dotted name."""
    root = os.path.join(REPO, "forces_resilient_planner_tpu_torch")
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                rel = os.path.relpath(os.path.join(d, f[:-3]), REPO)
                out.add(rel.replace(os.sep, "."))
    return out


def test_the_import_scan_covers_every_port_module():
    """The scan above names every module of the port (a new module joins
    the list, or this fails)."""
    params = next(m for m in test_port_imports_no_jax.pytestmark
                  if m.name == "parametrize").args[1]
    assert _port_modules() <= set(params), sorted(_port_modules()
                                                  - set(params))


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
    """The root probe of K2, K3 and K4 names no JAX module, and without a
    card it stops before it times anything, with or without --k4."""
    for name in _imported_modules(os.path.join(REPO, "k23_probe.py")):
        assert name.split(".")[0] not in (
            "jax", "forces_resilient_planner_tpu", "bench",
            "__graft_entry__"), name
    for flags in ([], ["--k4", "--e2e"]):
        proc = _run([sys.executable, "k23_probe.py", "--reps", "1", *flags])
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
