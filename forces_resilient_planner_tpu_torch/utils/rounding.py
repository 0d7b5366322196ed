"""Elementwise arithmetic rounded the way the jitted JAX reference rounds it.

XLA:CPU compiles a fused elementwise expression with LLVM, whose backend
contracts a product that feeds an add into one fused multiply-add (one
rounding), and it runs a dot of length 3 as the chain
fma(a2, b2, fma(a1, b1, a0 * b0)), unjitted too: a dot contracts by
itself.  Where the corridor decomposition compares values that are equal in
exact arithmetic, as the distances and plane offsets of points on a voxel
grid are, that rounding decides the comparison, so the plain PyTorch
version rounds as XLA does at those sites (corridor/decomp.py), and the
CUDA kernel does too (ops/csrc/corridor.cu: __fma_rn there, every other
operation rounded on its own).

torch has no fused multiply-add: `fma` emulates a correctly rounded one
with elementwise operations.  This CPU build's torch.sqrt, sin, cos and
atan2 misround some float64 inputs by an ulp, where XLA:CPU's are
correctly rounded (sqrt) or glibc's (the others), so on CPU tensors `sqrt`
is numpy's and the float64 transcendentals are glibc's (the `math`
module's).  On CUDA tensors each is torch's own, which is what the kernel
calls.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# Veltkamp's splitter 2^ceil(p/2) + 1 for the precision p of each dtype
_SPLIT = {torch.float64: 134217729.0, torch.float32: 4097.0}
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _two_prod(a, b):
    """(p, e) with p = fl(a b) and p + e = a b exactly (Dekker)."""
    p = a * b
    s = _SPLIT[p.dtype]
    ca, cb = a * s, b * s
    ah = ca - (ca - a)
    bh = cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once to nearest (Boldo and Melquiond's emulation:
    the product's error and the sum's are added rounded to odd, then the
    sum rounded to nearest).  Exact for finite operands whose product
    neither overflows nor underflows; broadcasts like a * b + c."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    # round v to odd: where the sum was inexact and v's last bit is even,
    # the other neighbour of the exact sum
    even = (v.view(_BITS[v.dtype]) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(v, math.inf),
                         torch.full_like(v, -math.inf))
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of length 3 as XLA:CPU runs a dot:
    fma(a2, b2, fma(a1, b1, a0 b0))."""
    return fma(a[..., 2], b[..., 2],
               fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _libm(fn, torch_fn, *xs: torch.Tensor) -> torch.Tensor:
    if xs[0].device.type != "cpu" or xs[0].dtype != torch.float64:
        return torch_fn(*xs)
    arrays = np.broadcast_arrays(*(x.numpy() for x in xs))
    return torch.from_numpy(
        np.array(np.frompyfunc(fn, len(xs), 1)(*arrays), dtype=np.float64))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _libm(math.atan2, torch.atan2, y, x)


def _finite_only(fn):
    # math.cos and math.sin raise on infinities, where the others give NaN
    return lambda v: fn(v) if math.isfinite(v) else math.nan


def cos(x: torch.Tensor) -> torch.Tensor:
    return _libm(_finite_only(math.cos), torch.cos, x)


def sin(x: torch.Tensor) -> torch.Tensor:
    return _libm(_finite_only(math.sin), torch.sin, x)
