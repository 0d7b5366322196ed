"""Port parity: engine/reference.py of the torch port against the JAX
sample_references / wrap_yaw_outputs at f64 on a batch of 12 robots drawn
from a seed: straight, curved and short paths (kino_size < N, down to a
single sample), time offsets off the Ts grid (and 0), yaws near the
+-pi wrap.  Tolerance 1e-12 absolute (the same formulas in the same order).

At an offset on the Ts grid, floor((i Ts + t_offset) / Ts) is decided by
the last bit: XLA:CPU contracts i Ts + t_offset into one fused
multiply-add under jit and multiplies by 1 / Ts, so jitted JAX can pick
the next path sample there (ROADMAP.md, Queue 3).  The port computes the
index as jitted JAX does (the fleet's offsets sit on the grid every tick);
the grid-offset test below holds it to jitted JAX at such offsets."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.engine import reference as jr
from forces_resilient_planner_tpu_torch.engine import reference as tr

N, TS, K = C.model.N, C.model.dt, 48
TOL = 1e-12


def _inputs():
    rng = np.random.default_rng(5)
    B = 12
    t = np.arange(K) * TS
    paths = []
    for b in range(B):
        v = rng.uniform(-2.0, 2.0, 2)
        w = rng.uniform(-1.5, 1.5)
        x = v[0] * t + 0.3 * np.sin(w * t)
        y = v[1] * t + 0.3 * np.cos(w * t)
        paths.append(np.stack([x, y, 1.2 + 0.1 * np.sin(t)], -1))
    paths = np.asarray(paths)
    sizes = np.array([K, K, 30, 21, 20, 19, 12, 5, 2, 1, K, 7])
    toff = rng.uniform(0.0, 0.4, B)
    toff[0] = 0.0
    last_yaw = rng.uniform(-np.pi, np.pi, B)
    last_yaw[:2] = [3.1, -3.1]
    pred = paths[:, 0] + rng.normal(0, 0.5, (B, 3))
    return paths, sizes, toff, last_yaw, pred


@pytest.fixture(scope="module")
def both():
    paths, sizes, toff, last_yaw, pred = _inputs()
    ref = jax.jit(jax.vmap(
        lambda p, s, o, y, q: jr.sample_references(p, s, o, y, q, N=N, Ts=TS)
    ))(paths, sizes, toff, last_yaw, pred)
    t = torch.as_tensor
    got = tr.sample_references(t(paths), t(sizes), t(toff), t(last_yaw),
                               t(pred), N=N, Ts=TS)
    return ref, got


@pytest.mark.parametrize("field", ["ref_pos", "ref_yaw", "stage0_jump"])
def test_sample_references_matches_jax(both, field):
    ref, got = both
    g = getattr(got, field)
    assert g.dtype == torch.float64
    np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, field)),
                               rtol=0, atol=TOL)


def test_short_paths_hold_their_last_sample(both):
    _, got = both
    paths, sizes, *_ = _inputs()
    for b in np.nonzero(sizes < N)[0]:
        last = paths[b, max(sizes[b] - 1, 0)]
        np.testing.assert_allclose(got.ref_pos[b, -1].numpy(), last, atol=TOL)


def test_wrap_yaw_outputs_matches_jax():
    rng = np.random.default_rng(8)
    Z = rng.normal(0, 1, (6, N, 17))
    Z[..., 16] = rng.uniform(-7.0, 7.0, (6, N))
    Z[0, :3, 16] = [np.pi, -np.pi, 3.1415926]
    ref = jax.vmap(jr.wrap_yaw_outputs)(jnp.asarray(Z))
    got = tr.wrap_yaw_outputs(torch.as_tensor(Z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_grid_offsets_round_op_by_op():
    """t_offset = k Ts on the grid (k = 0..25, the fleet's offsets): the
    samples jitted JAX picks, where the fused multiply-add of the index and
    the op-by-op fraction decide the last bit (within 1e-12 of it)."""
    paths, sizes, _, last_yaw, pred = _inputs()
    paths, sizes = paths[:1], sizes[:1]       # the full-length path
    toff = np.arange(26) * TS
    n = len(toff)
    ref = jax.jit(jax.vmap(
        lambda p, s, o, y, q: jr.sample_references(p, s, o, y, q, N=N, Ts=TS),
        in_axes=(None, None, 0, None, None),
    ))(paths[0], sizes[0], toff, last_yaw[0], pred[0])
    t = torch.as_tensor
    got = tr.sample_references(
        t(np.repeat(paths, n, 0)), t(np.repeat(sizes, n)), t(toff),
        t(np.repeat(last_yaw[:1], n)), t(np.repeat(pred[:1], n, 0)),
        N=N, Ts=TS)
    np.testing.assert_allclose(got.ref_pos.numpy(), np.asarray(ref.ref_pos),
                               rtol=0, atol=TOL)
    # the op-by-op index would pick another sample at some of them
    it = np.arange(N)[None] * TS + toff[:, None]
    plain = np.floor(it / TS).astype(int)
    frac = np.mod(it, TS) / TS
    p = paths[0]
    want = p[plain] + frac[..., None] * (p[plain + 1] - p[plain])
    assert np.abs(got.ref_pos.numpy() - want).max() > 1e-3
