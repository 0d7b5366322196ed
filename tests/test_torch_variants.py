"""Port parity: corridor/variants.py of the torch port against the JAX
package's, at f64 on the CPU: tests/test_aux.py's seed-point and iterative
decompositions (:27, :46) on the same clouds, A and b within 1e-12 and the
simplified path identical, plus each file's own checks on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.corridor import variants as jv
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as TC
from forces_resilient_planner_tpu_torch.corridor import variants as tv

TOL = 1e-12


def _buffer(obs, keep, M=256):
    buf = np.zeros((M, 3))
    buf[: keep.sum()] = obs[keep]
    m = np.zeros(M, bool)
    m[: keep.sum()] = True
    return buf, m


def _seed_scene(seed):
    rng = np.random.default_rng(seed)
    obs = rng.uniform([-2, -2, 0], [2, 2, 2], (100, 3))
    keep = np.linalg.norm(obs - [0, 0, 1], axis=1) > 0.5
    return obs, keep, _buffer(obs, keep)


def _path_scene(seed):
    rng = np.random.default_rng(seed)
    obs = rng.uniform([-1, -4, 0], [6, 4, 2.4], (150, 3))
    keep = np.abs(obs[:, 1]) > 0.7
    t = np.linspace(0, 1, 12)[:, None]
    path = np.array([0.0, 0, 1.2]) + t * np.array([5.0, 0, 0])
    return path, _buffer(obs, keep)


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_seed_decompose_matches_jax(seed):
    obs, keep, (buf, m) = _seed_scene(seed)
    p = np.array([0.0, 0.0, 1.0])
    ref = jv.seed_decompose(jnp.asarray(p), 0.3, jnp.asarray(buf),
                            jnp.asarray(m), C.corridor)
    got = tv.seed_decompose(_t(p), 0.3, _t(buf), _t(m), TC.corridor)
    A, b = got.A.numpy(), got.b.numpy()
    assert A.shape == (30, 3) and b.shape == (30,)
    np.testing.assert_allclose(A, np.asarray(ref.A), rtol=0, atol=TOL)
    np.testing.assert_allclose(b, np.asarray(ref.b), rtol=0, atol=TOL)
    # tests/test_aux.py's checks: the seed inside, kept obstacles excluded
    assert np.all(A @ p - b <= 1e-9)
    rows = np.linalg.norm(A, axis=1) > 1e-9
    for o in obs[keep]:
        if np.all(np.abs(o - p) <= np.asarray(TC.corridor.local_bbox)):
            assert np.max(A[rows] @ o - b[rows]) >= -1e-7


@pytest.mark.parametrize("downsample", [0.0, 0.8])
def test_iterative_decompose_matches_jax(downsample):
    path, (buf, m) = _path_scene(11)
    ref = jv.iterative_decompose(path, jnp.asarray(buf), jnp.asarray(m),
                                 C.corridor, downsample_res=downsample)
    got = tv.iterative_decompose(path, _t(buf), _t(m), TC.corridor,
                                 downsample_res=downsample)
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(ref.path))
    assert int(got.n_segments) == int(ref.n_segments)
    np.testing.assert_allclose(got.A.numpy(), np.asarray(ref.A), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(ref.b), rtol=0,
                               atol=TOL)
    # tests/test_aux.py's checks: simplified, waypoints covered
    P, A, b = got.path.numpy(), got.A.numpy(), got.b.numpy()
    n = int(got.n_segments)
    assert n < len(path) - 1
    for i in range(n):
        mid = 0.5 * (P[i] + P[i + 1])
        assert np.all(A[i] @ mid - b[i] <= 1e-7)


def test_simplify_mask_is_jax_s():
    rng = np.random.default_rng(2)
    path = rng.normal(0, 1, (9, 3))
    A = rng.normal(0, 1, (8, 30, 3))
    A[:, 20:] = 0.0
    b = rng.uniform(0.0, 3.0, (8, 30))
    np.testing.assert_array_equal(tv._simplify_mask(path, A, b),
                                  jv._simplify_mask(path, A, b))
