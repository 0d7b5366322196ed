"""Batch-width-independent sums.

A torch reduction kernel may order its additions differently for another
batch width, so the same lane summed inside a 24-lane and a 5-lane batch
can differ in the last bit.  The tiered solver compacts lanes into smaller
sub-batches and must reproduce the single-phase solver bit for bit, so the
solver path sums with elementwise adds in a fixed order instead.
"""
from __future__ import annotations

import torch


def sum_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over a small axis as a left-to-right chain of elementwise adds."""
    acc = x.select(dim, 0)
    for j in range(1, x.shape[dim]):
        acc = acc + x.select(dim, j)
    return acc


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the last (the lane axis) by a fixed pairwise
    tree: (..., B) -> (B,)."""
    x = x.reshape(-1, x.shape[-1])
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = x[0::2] + x[1::2]
    return x[0]


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of length 3, summed x, y, z in order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])
