"""The port's own copies of the configuration tree and of the benchmark
workloads equal their originals in the JAX package, bench.py,
__graft_entry__.py and tools/fleet_probe.py (no JAX compile but the fleet
scene's eager occupancy calls)."""
import dataclasses
import importlib.util
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import bench
from forces_resilient_planner_tpu import config as jax_config
from forces_resilient_planner_tpu_torch import config as port_config
from forces_resilient_planner_tpu_torch.engine import workloads

CLASSES = ("ModelConfig", "WeightConfig", "SolverConfig", "TubeConfig",
           "CorridorConfig", "SearchConfig", "MapConfig", "FSMConfig",
           "PlannerConfig")


def _plain(cfg):
    """asdict with numpy arrays as lists (== on arrays is elementwise)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        if isinstance(v, np.ndarray):
            return ("ndarray", v.dtype.str, v.tolist())
        return v
    return conv(dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", CLASSES)
def test_config_class_defaults_equal_the_originals(name):
    port, orig = getattr(port_config, name), getattr(jax_config, name)
    assert port is not orig
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(orig)]
    assert _plain(port()) == _plain(orig())


def test_default_config_equals_the_original():
    assert _plain(port_config.DEFAULT_CONFIG) == _plain(
        jax_config.DEFAULT_CONFIG)


@pytest.mark.parametrize("seed", [0, 1, 2, 1001])
def test_bench_seeds_equal_bench_py(seed):
    for got, want in zip(workloads.bench_seeds(seed), bench.bench_seeds(seed)):
        np.testing.assert_array_equal(got, want)
    small = workloads.bench_seeds(seed, n_goals=4, n_forces=3)
    for got, want in zip(small, bench.bench_seeds(seed, 4, 3)):
        np.testing.assert_array_equal(got, want)


def test_bench_grid_constants_equal_bench_py():
    np.testing.assert_array_equal(workloads.HALVES, bench.HALVES)
    assert (workloads.N_GOALS, workloads.N_FORCES) == (
        bench.N_GOALS, bench.N_FORCES)


def test_bench_config_equals_bench_py():
    assert _plain(workloads.bench_config()) == _plain(bench.bench_config())


def test_small_cfg_equals_graft_entry():
    assert _plain(workloads.small_cfg()) == _plain(__graft_entry__._small_cfg())


def _fleet_probe():
    path = pathlib.Path(bench.__file__).parent / "tools" / "fleet_probe.py"
    spec = importlib.util.spec_from_file_location("fleet_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_cfg_equals_fleet_probe():
    assert _plain(workloads.fleet_cfg()) == _plain(_fleet_probe().fleet_cfg())


def test_fleet_scene_equals_fleet_probe():
    fp = _fleet_probe()
    grid_j, obs_j, mask_j = fp.fleet_scene(fp.fleet_cfg(), jnp.float64)
    grid_t, obs_t, mask_t = workloads.fleet_scene(
        workloads.fleet_cfg(), torch.float64, device="cpu")
    for got, want in zip(grid_t, grid_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert obs_t.shape == (2048, 3) and int(mask_t.sum()) > 1000


def test_fleet_lanes_and_run_equal_bench_py():
    """The lanes of bench.py's _fleet_bench: its own generator lines run
    at B = 128, and its B, duration and replan cadence."""
    src = inspect.getsource(bench._fleet_bench)
    lines = src[src.index("    rng = np.random.default_rng(5)"):
                src.index("    res = fleet.run_fleet(")]
    scope = {"np": np, "B": workloads.FLEET_B}
    exec(inspect.cleandoc("\n" + lines), scope)
    for got, name in zip(workloads.fleet_lanes(), ("starts", "goals",
                                                   "f_true")):
        np.testing.assert_array_equal(got, scope[name])
    sig = inspect.signature(bench._fleet_bench).parameters
    assert sig["B"].default == workloads.FLEET_B
    assert sig["duration"].default == workloads.FLEET_DURATION
    assert "replan_every=10," in src and workloads.FLEET_REPLAN_EVERY == 10


def test_closed_loop_cfg_equals_the_closed_loop_tests():
    from test_closed_loop import CFG

    assert _plain(workloads.closed_loop_cfg()) == _plain(CFG)
