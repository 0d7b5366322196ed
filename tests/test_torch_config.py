"""The port's own copies of the configuration tree and of the benchmark
workloads equal their originals in the JAX package, bench.py and
__graft_entry__.py (no JAX compile: the originals import numpy only)."""
import dataclasses

import numpy as np
import pytest

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
