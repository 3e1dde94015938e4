"""Double-float (two-float32) building blocks of the f64-grade sweep.

Port of radiative_transfer_tpu/ops/df.py (its own copy: the JAX module
imports jax). A value is carried as an unevaluated sum hi + lo of two
float32 numbers with |lo| <= 0.5 ulp(hi), about 2^-48 relative, which is
what the double-float engine (ops/cuda_df.py) and its CUDA kernels
(csrc/df_sweep.cu) compute with.

The torch functions here are the plain versions' arithmetic on float32
tensors. Eager PyTorch on the CPU rounds every operation to a float32
tensor in memory, so no multiply-add is ever contracted into an FMA and
the JAX package's ``make_freeze`` (an opaque multiply by 1.0 that stops
XLA from contracting) has no counterpart. For the same reason the df
path uses no fused torch operation (``addcmul``, ``addcdiv``, ``lerp``,
``baddbmm`` and the like): each of them rounds once where the algorithm
rounds twice. The CUDA kernels get the same guarantee from the
``__fmul_rn``/``__fadd_rn``/``__fsub_rn`` intrinsics, which nvcc never
contracts.

Host-side packing (numpy, float64 in) makes the (hi, lo, split-hi,
split-lo) constant columns the kernels consume.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

# Veltkamp splitter for f32 (p=24): 2^ceil(p/2) + 1.
SPLITTER = np.float32(4097.0)


# ---------------------------------------------------------------------------
# Primitives (float32 tensors in, float32 tensors out)
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly, s = fl(a+b); no magnitude
    precondition."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def split(x: torch.Tensor):
    """Bitmask split: x == h + l exactly with h the top 12 significant bits
    and l the bottom 12, so every partial product of two split values is
    exact in f32. Integer-masked, as in the JAX package (not the float
    Veltkamp sequence, which a compiler may contract)."""
    h = (x.view(torch.int32) & -4096).view(torch.float32)
    return h, x - h


def prod_err(p, xh, xl, yh, yl):
    """Exact error of p = fl(x*y) given the splits of x and y:
    x*y == p + prod_err."""
    return ((xh * yh - p) + xh * yl + xl * yh) + xl * yl


def two_prod(x, y):
    """p + e == x*y exactly."""
    xh, xl = split(x)
    yh, yl = split(y)
    p = x * y
    return p, prod_err(p, xh, xl, yh, yl)


class DFConst(NamedTuple):
    """A double-float constant with its hi-part Veltkamp split precomputed
    on the host: value == hi + lo, hi == hh + hl exactly."""

    hi: torch.Tensor
    lo: torch.Tensor
    hh: torch.Tensor
    hl: torch.Tensor


def renorm(hi, delta):
    """Fold an f32 correction into a value: hi' + lo' == hi + delta
    exactly."""
    return two_sum(hi, delta)


# ---------------------------------------------------------------------------
# Host-side packing (numpy, f64 in)
# ---------------------------------------------------------------------------

def np_split(hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host Veltkamp split of f32 values (numpy f32)."""
    hi = np.asarray(hi, np.float32)
    c = np.float32(SPLITTER) * hi
    h = (c - (c - hi)).astype(np.float32)
    return h, (hi - h).astype(np.float32)


def np_df(x64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f64 -> (hi, lo) f32 pair with hi + lo == x64 to f64 roundoff."""
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo
