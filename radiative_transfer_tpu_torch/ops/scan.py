"""Batched first-order affine recurrences (the general engine's sweep core).

Port of radiative_transfer_tpu/ops/scan.py. The reference's spatial sweep
is a sequential per-cell loop carrying one upwind edge value per
(direction, group) (reference: src/solver.cpp:700-811). Each cell applies
an affine map to the carry,

    carry_j = a_j * carry_{j-1} + b_j,

and composition of affine maps is associative, so the N-cell chain is
evaluated in log depth, batched over every leading axis. The scan returns
the prefix composition (pref_a, pref_b), so that

    carry_j = pref_a_j * init + pref_b_j

holds for any boundary value `init` after the fact: the form the mesh
decomposition needs (parallel/sharded.py).

The scan is exact: every pass composes every pair it is given, nothing is
truncated (unlike the kernels' plain versions, ops/cuda_sweep.py, which
stop once the neglected upwind tail is below --scan-tol). Eager PyTorch
launches each operation separately, so the JAX chunked form's in-chunk
`lax.scan` (256 sequential steps) would be 256 rounds of launches here;
both levels are log-step (Hillis-Steele) prefixes instead, ceil(log2 n)
passes each. The associations differ from XLA's, so results agree with
the JAX package to roundoff, not bit for bit. Closed forms through
cumprod/cumsum are not used: products of a in (0, 1) underflow within a
few hundred cells on optically thick groups, and b / pref_a would divide
by those zeros.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Chunk length of the blocked scan (JAX's value, ops/scan.py).
_CHUNK = 256


def _combine(left, right):
    """Compose affine maps: apply `left`, then `right`."""
    a_l, b_l = left
    a_r, b_r = right
    return a_r * a_l, a_r * b_l + b_r


def _log_prefix(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix composition along the last axis, exact, in
    ceil(log2 n) Hillis-Steele passes (out of place: autograd follows)."""
    n = a.shape[-1]
    d = 1
    while d < n:
        a_lo, b_lo = a[..., :-d], b[..., :-d]
        a_hi, b_hi = a[..., d:], b[..., d:]
        na, nb = _combine((a_lo, b_lo), (a_hi, b_hi))
        a = torch.cat([a[..., :d], na], dim=-1)
        b = torch.cat([b[..., :d], nb], dim=-1)
        d *= 2
    return a, b


def affine_scan(a: torch.Tensor, b: torch.Tensor, axis: int = -1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix composition of x -> a*x + b along `axis`.

    Returns (pref_a, pref_b) with pref_j = f_j o ... o f_0. Along a long
    axis (a multiple of _CHUNK, at least 4 chunks, JAX's rule) the scan
    is blocked: a log-step prefix inside each chunk, a log-step exclusive
    prefix of the chunk totals, then one fix-up; otherwise one log-step
    prefix over the whole axis."""
    a, b = torch.broadcast_tensors(a, b)
    axis = axis % a.ndim
    if axis != a.ndim - 1:
        pa, pb = affine_scan(a.movedim(axis, -1), b.movedim(axis, -1))
        return pa.movedim(-1, axis), pb.movedim(-1, axis)
    n = a.shape[-1]
    if n % _CHUNK != 0 or n // _CHUNK < 4:
        return _log_prefix(a, b)
    batch, nc = a.shape[:-1], n // _CHUNK
    pa, pb = _log_prefix(a.reshape(*batch, nc, _CHUNK),
                         b.reshape(*batch, nc, _CHUNK))
    ca, cb = _log_prefix(pa[..., -1], pb[..., -1])      # (*batch, nc)
    # Exclusive across chunks: chunk 0 sees the identity map.
    ex_a = torch.cat([torch.ones_like(ca[..., :1]), ca[..., :-1]], dim=-1)
    ex_b = torch.cat([torch.zeros_like(cb[..., :1]), cb[..., :-1]], dim=-1)
    # Global prefix = (in-chunk prefix) o (exclusive chunk prefix).
    g_a = pa * ex_a[..., None]
    g_b = pa * ex_b[..., None] + pb
    return g_a.reshape(*batch, n), g_b.reshape(*batch, n)


def affine_scan_sequential(a: torch.Tensor, b: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same prefix by a sequential loop over the last axis (a test
    oracle for affine_scan)."""
    a, b = torch.broadcast_tensors(a, b)
    carry = (torch.ones_like(a[..., 0]), torch.zeros_like(b[..., 0]))
    outs_a, outs_b = [], []
    for j in range(a.shape[-1]):
        carry = _combine(carry, (a[..., j], b[..., j]))
        outs_a.append(carry[0])
        outs_b.append(carry[1])
    return torch.stack(outs_a, dim=-1), torch.stack(outs_b, dim=-1)


def apply_prefix(pref_a: torch.Tensor, pref_b: torch.Tensor,
                 init: torch.Tensor) -> torch.Tensor:
    """carry_j = pref_a_j * init + pref_b_j (init broadcast along the scan
    axis)."""
    return pref_a * init[..., None] + pref_b
