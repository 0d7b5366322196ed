"""Checkpoint / resume for sweep jobs (torch).

Port of forces_resilient_planner_tpu/utils/checkpoint.py.  The reference
has no persistence (SURVEY.md section 5: all state ephemeral); long
Monte-Carlo sweeps here checkpoint each chunk's results so a killed job
resumes from the last completed chunk.

The port writes and reads the JAX module's npz format only: `<path>.npz`
holding `leaf_{i}` arrays in pytree-flatten order, beside `<path>.meta.json`
with `"format": "npz"`.  The JAX module prefers orbax, which imports JAX;
a directory of orbax checkpoints is refused with an error that names them,
never skipped or recomputed.  The flatten below is the JAX package's order
over the containers a sweep saves: NamedTuple and tuple fields in order,
list items in order, dict values by sorted key; None holds no leaf.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree):
    """(leaves, treedef): treedef rebuilds the containers around leaves."""
    if tree is None:
        return [], ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        kind = ("dict", type(tree), tuple(keys))
    elif isinstance(tree, (tuple, list)):
        parts = [tree_flatten(v) for v in tree]
        kind = (("namedtuple" if _is_namedtuple(tree) else
                 "tuple" if isinstance(tree, tuple) else "list"), type(tree))
    else:
        return [tree], ("leaf",)
    leaves = [leaf for p in parts for leaf in p[0]]
    return leaves, kind + (tuple(p[1] for p in parts),)


def tree_unflatten(treedef, leaves):
    """Inverse of tree_flatten; leaves in flatten order."""
    it = iter(leaves)

    def build(td):
        kind = td[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            _, cls, keys, subs = td
            return cls((k, build(s)) for k, s in zip(keys, subs))
        _, cls, subs = td
        vals = [build(s) for s in subs]
        return cls(*vals) if kind == "namedtuple" else cls(vals)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def treedef_str(treedef) -> str:
    """A readable form of a treedef for the metadata file."""
    kind = treedef[0]
    if kind == "none":
        return "None"
    if kind == "leaf":
        return "*"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {treedef_str(s)}"
                               for k, s in zip(treedef[2], treedef[3])) + "}"
    inner = ", ".join(treedef_str(s) for s in treedef[2])
    return (f"{treedef[1].__name__}({inner})" if kind == "namedtuple"
            else f"[{inner}]" if kind == "list" else f"({inner})")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str | Path, state, metadata: dict | None = None) -> Path:
    """Save a pytree of tensors / arrays + metadata.  Returns the npz path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = tree_flatten(state)
    npz = path.with_suffix(".npz")
    np.savez_compressed(
        npz, **{f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)})
    path.with_suffix(".meta.json").write_text(json.dumps({
        "format": "npz",
        "treedef": treedef_str(treedef),
        "n_leaves": len(leaves),
        **(metadata or {}),
    }))
    return npz


def load(path: str | Path, like=None, *, device):
    """Load an npz checkpoint as tensors on `device`.  `like`: an example
    pytree giving the structure (else the list of leaves)."""
    path = Path(path)
    orbax = path if path.suffix == ".orbax" else path.with_suffix(".orbax")
    if path.suffix == ".orbax" or orbax.exists():
        raise RuntimeError(
            f"{orbax} is an orbax checkpoint; the port reads the npz format "
            "only (orbax imports JAX)")
    npz = path if path.suffix == ".npz" else path.with_suffix(".npz")
    with np.load(npz) as data:
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=device)
                  for i in range(len(data.files))]
    if like is None:
        return leaves
    return tree_unflatten(tree_flatten(like)[1], leaves)


class SweepCheckpointer:
    """Chunked Monte-Carlo sweeps with resume (BASELINE config 5 jobs)."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def done_chunks(self) -> set[int]:
        """The chunks saved here.  A directory that holds orbax chunks
        (the JAX module's preferred format) is refused."""
        orbax = sorted(p.name for p in self.dir.glob("chunk_*.orbax"))
        if orbax:
            raise RuntimeError(
                f"{self.dir} holds orbax chunks the port cannot read: "
                f"{', '.join(orbax)}")
        return {int(p.stem.split("_")[1])
                for p in self.dir.glob("chunk_*.npz")}

    def save_chunk(self, idx: int, result) -> Path:
        return save(self.dir / f"chunk_{idx}", result)

    def load_chunk(self, idx: int, like=None, *, device):
        return load(self.dir / f"chunk_{idx}", like=like, device=device)
