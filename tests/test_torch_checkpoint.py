"""Port parity: utils/checkpoint.py of the torch port against the JAX
package's checkpoint module.  A chunk the port saves is read back by JAX's
checkpoint.load with identical leaves; a chunk JAX saves through its npz
branch (orbax made unimportable) is read by the port with identical
leaves; a JAX orbax chunk is refused by name, never skipped.  Also the
checkpoint part of tests/test_aux.py on the port."""
import json
import sys
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.utils import checkpoint as jck
from forces_resilient_planner_tpu_torch.utils import checkpoint as tck


class Res(NamedTuple):
    Z: object
    iters: object


def _state():
    rng = np.random.default_rng(4)
    return {
        "res": Res(Z=rng.normal(size=(3, 4, 17)).astype(np.float32),
                   iters=np.array([3, 7, 60], np.int32)),
        "codes": (np.array([1, 0, -6, -7], np.int64), np.array([True, False])),
        "mu": [np.float64(0.25), np.arange(5.0)],
        "skip": None,
    }


def _torch_state(state):
    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(conv(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return torch.as_tensor(np.array(x))

    return conv(state)


def _assert_same(got, want):
    gl, gt = tck.tree_flatten(got)
    wl, wt = jax.tree.flatten(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_flatten_order_is_jax_order():
    state = _state()
    leaves, treedef = tck.tree_flatten(state)
    for a, b in zip(leaves, jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = tck.tree_unflatten(treedef, leaves)
    assert isinstance(back["res"], Res) and back["skip"] is None
    assert isinstance(back["codes"], tuple) and isinstance(back["mu"], list)
    with pytest.raises(ValueError, match="more leaves"):
        tck.tree_unflatten(treedef, leaves + [1])


def test_port_chunk_is_read_by_jax(tmp_path):
    state = _state()
    path = tck.save(tmp_path / "chunk_0", _torch_state(state), {"k": 1})
    assert path.name == "chunk_0.npz"
    meta = json.loads((tmp_path / "chunk_0.meta.json").read_text())
    assert meta["format"] == "npz" and meta["k"] == 1
    assert meta["n_leaves"] == len(jax.tree.leaves(state))
    back = jck.load(tmp_path / "chunk_0", like=state)
    _assert_same(_torch_state(back), state)
    assert jck.SweepCheckpointer(tmp_path).done_chunks() == {0}


def test_jax_npz_chunk_is_read_by_the_port(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    state = _state()
    path = jck.save(tmp_path / "chunk_2", state)
    assert path.suffix == ".npz"
    back = tck.load(tmp_path / "chunk_2", like=_torch_state(state),
                    device="cpu")
    _assert_same(back, state)
    assert isinstance(back["res"], Res) and back["skip"] is None
    ck = tck.SweepCheckpointer(tmp_path)
    assert ck.done_chunks() == {2}
    leaves = ck.load_chunk(2, device="cpu")
    assert len(leaves) == len(jax.tree.leaves(state))


def test_jax_orbax_chunks_are_refused_by_name(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    tck.save(tmp_path / "chunk_0", (torch.zeros(2), torch.ones(2)))
    jck.save(tmp_path / "chunk_5", (np.zeros(2), np.ones(2)))
    assert (tmp_path / "chunk_5.orbax").exists()
    ck = tck.SweepCheckpointer(tmp_path)
    with pytest.raises(RuntimeError, match="chunk_5.orbax"):
        ck.done_chunks()
    with pytest.raises(RuntimeError, match="orbax checkpoint"):
        ck.load_chunk(5, device="cpu")


def test_checkpoint_part_of_test_aux(tmp_path):
    """tests/test_aux.py's checkpoint round trip, on the port."""
    state = {"Z": np.ones((4, 3)), "iters": np.asarray([3, 4])}
    path = tck.save(tmp_path / "ck", state, {"note": "test"})
    back = tck.load(path, like=state, device="cpu")
    np.testing.assert_allclose(back["Z"].numpy(), state["Z"])
    assert back["iters"].tolist() == [3, 4]
    meta = json.loads((tmp_path / "ck.meta.json").read_text())
    assert meta["note"] == "test" and meta["format"] == "npz"


def test_sweep_checkpointer_resume_set(tmp_path):
    ck = tck.SweepCheckpointer(tmp_path / "sweep")
    assert ck.done_chunks() == set()
    for c in (0, 1, 3):
        ck.save_chunk(c, (torch.full((4,), c, dtype=torch.int32),
                          torch.arange(4)))
    assert ck.done_chunks() == {0, 1, 3}
    ec, it = ck.load_chunk(3, like=(0, 0), device="meta")
    assert ec.device.type == "meta" and ec.dtype == torch.int32
    ec, it = ck.load_chunk(3, like=(0, 0), device="cpu")
    assert ec.tolist() == [3, 3, 3, 3] and it.tolist() == [0, 1, 2, 3]
