"""Radix-2 NTT / coset LDE over BabyBear on torch int32 tensors.

Counterpart of valida_tpu/poly/ntt.py, with its conventions:
* transforms act over axis 0 (trace rows); trailing axes (columns) ride along;
* `dif(a)`: natural-in -> bitrev-out, decimation in frequency;
* `dit(a)`: bitrev-in -> natural-out, decimation in time;
* no 1/N scaling inside dif/dit.

A CUDA tensor with at least 128 rows goes through the hand-written
kernels of poly/radix_ntt.py (as the reference routes device arrays to
poly/mxu_ntt.py).  Everything else runs the plain stage loop
below, two butterfly levels per pass, bit-identical to the reference's.
The elementwise passes (coset shift, 1/N scaling, bit-reversal gather)
stay plain PyTorch, as the reference leaves them to XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..convert import table
from ..field import babybear as bb
from . import radix_ntt

# ---------------------------------------------------------------------------
# Host tables (numpy, cached per static shape parameters)
# ---------------------------------------------------------------------------


def _powers_host(w: int, n: int) -> np.ndarray:
    """[1, w, w^2, ..., w^{n-1}] canonical, via numpy uint64 log-doubling."""
    out = np.ones(max(n, 1), dtype=np.uint64)
    if n <= 1:
        return out.astype(np.uint32)
    out[1] = w
    length = 2
    while length < n:
        step = int(out[length - 1]) * w % bb.P  # w^length
        take = min(length, n - length)
        out[length:length + take] = (
            out[:take] * np.uint64(step) % np.uint64(bb.P))
        length += take
    return out.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _root_powers(log_n: int, inverse: bool) -> np.ndarray:
    """Montgomery-form powers of the order-2^log_n root (length 2^(log_n-1))."""
    w = bb.two_adic_generator(log_n)
    if inverse:
        w = bb.h_inv(w)
    canon = _powers_host(w, max((1 << log_n) // 2, 1))
    return ((canon.astype(np.uint64) << 32) % np.uint64(bb.P)).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def bitrev_indices(log_n: int) -> np.ndarray:
    idx = np.arange(1 << log_n, dtype=np.uint32)
    rev = np.zeros(1 << log_n, dtype=np.uint32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev.astype(np.int32)


@functools.lru_cache(maxsize=None)
def shift_powers(shift: int, log_n: int, bitrev: bool = False) -> np.ndarray:
    """Montgomery powers shift^i for i < 2^log_n (optionally bitrev order)."""
    canon = _powers_host(shift % bb.P, 1 << log_n)
    if bitrev:
        canon = canon[bitrev_indices(log_n)]
    return ((canon.astype(np.uint64) << 32) % np.uint64(bb.P)).astype(np.uint32)


def _bcast(tw: torch.Tensor, ndim_rest: int) -> torch.Tensor:
    return tw.reshape(tuple(tw.shape) + (1,) * ndim_rest)


def _gather_bitrev(a: torch.Tensor, log_n: int) -> torch.Tensor:
    idx = table(bitrev_indices, log_n, device=a.device).long()
    return a.index_select(0, idx)


# ---------------------------------------------------------------------------
# Core stage loops
# ---------------------------------------------------------------------------


def dif(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Natural-in, bitrev-out DIF over axis 0 (no 1/N scaling)."""
    n = int(a.shape[0])
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    if n == 1:
        return a
    if a.device.type == "cuda" and log_n >= radix_ntt.MIN_LOG_N:
        return radix_ntt.dif(a, inverse)
    rest = tuple(a.shape[1:])
    nd = len(rest)
    pw = table(_root_powers, log_n, inverse, device=a.device)
    s = 0
    while log_n - s >= 2:  # radix-4: levels s and s+1 in one pass
        q = n >> (s + 2)
        tw_s = pw[::1 << s][:2 * q]
        t0 = _bcast(tw_s[:q], nd)[None]
        t1 = _bcast(tw_s[q:], nd)[None]
        te = _bcast(pw[::1 << (s + 1)][:q], nd)[None]
        x = a.reshape((1 << s, 2, 2, q) + rest)
        x00, x01 = x[:, 0, 0], x[:, 0, 1]
        x10, x11 = x[:, 1, 0], x[:, 1, 1]
        lo0 = bb.add(x00, x10)
        lo1 = bb.add(x01, x11)
        hi0 = bb.mul(bb.sub(x00, x10), t0)
        hi1 = bb.mul(bb.sub(x01, x11), t1)
        y0 = bb.add(lo0, lo1)
        y1 = bb.mul(bb.sub(lo0, lo1), te)
        y2 = bb.add(hi0, hi1)
        y3 = bb.mul(bb.sub(hi0, hi1), te)
        a = torch.stack([y0, y1, y2, y3], dim=1).reshape((n,) + rest)
        s += 2
    if s < log_n:  # odd log_n: one radix-2 tail stage
        half = n >> (s + 1)
        tw = pw[::1 << s][:half]
        x = a.reshape((1 << s, 2, half) + rest)
        x0, x1 = x[:, 0], x[:, 1]
        lo = bb.add(x0, x1)
        hi = bb.mul(bb.sub(x0, x1), _bcast(tw, nd)[None])
        a = torch.stack([lo, hi], dim=1).reshape((n,) + rest)
    return a


def dit(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Bitrev-in, natural-out radix-2 DIT over axis 0 (no 1/N scaling)."""
    n = int(a.shape[0])
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    if n == 1:
        return a
    rest = tuple(a.shape[1:])
    nd = len(rest)
    pw = table(_root_powers, log_n, inverse, device=a.device)
    s = log_n - 1
    while s >= 1:  # radix-4: levels s then s-1 in one pass
        q = n >> (s + 1)
        te = _bcast(pw[::1 << s][:q], nd)[None]
        tw_lo = pw[::1 << (s - 1)][:2 * q]
        t0 = _bcast(tw_lo[:q], nd)[None]
        t1 = _bcast(tw_lo[q:], nd)[None]
        x = a.reshape((1 << (s - 1), 2, 2, q) + rest)
        x00, x01 = x[:, 0, 0], x[:, 0, 1]
        x10, x11 = x[:, 1, 0], x[:, 1, 1]
        o0 = bb.mul(x01, te)
        a0 = bb.add(x00, o0)
        a1 = bb.sub(x00, o0)
        o1 = bb.mul(x11, te)
        b0 = bb.add(x10, o1)
        b1 = bb.sub(x10, o1)
        c0 = bb.mul(b0, t0)
        c1 = bb.mul(b1, t1)
        a = torch.stack(
            [bb.add(a0, c0), bb.add(a1, c1), bb.sub(a0, c0), bb.sub(a1, c1)],
            dim=1,
        ).reshape((n,) + rest)
        s -= 2
    if s == 0:  # odd log_n: one radix-2 tail stage
        half = n >> 1
        x = a.reshape((1, 2, half) + rest)
        e = x[:, 0]
        o = bb.mul(x[:, 1], _bcast(pw[:half], nd)[None])
        a = torch.stack([bb.add(e, o), bb.sub(e, o)], dim=1).reshape((n,) + rest)
    return a


# ---------------------------------------------------------------------------
# User-facing transforms (Montgomery-form int32 tensors)
# ---------------------------------------------------------------------------


def ntt(a: torch.Tensor) -> torch.Tensor:
    """Coefficients (natural) -> evaluations (natural)."""
    log_n = int(a.shape[0]).bit_length() - 1
    return dit(_gather_bitrev(a, log_n), False)


def intt(a: torch.Tensor) -> torch.Tensor:
    """Evaluations (natural) -> coefficients (natural)."""
    log_n = int(a.shape[0]).bit_length() - 1
    coeffs = _gather_bitrev(dif(a, inverse=True), log_n)
    return bb.mul(coeffs, bb.to_monty_int(bb.h_inv(1 << log_n)))


def coset_eval_from_coeffs(coeffs: torch.Tensor, shift: int,
                           out_bitrev: bool = False) -> torch.Tensor:
    """Evaluate polynomial (natural coeffs, len N) on coset shift·H_N."""
    log_n = int(coeffs.shape[0]).bit_length() - 1
    sp = table(shift_powers, shift, log_n, device=coeffs.device)
    scaled = bb.mul(coeffs, _bcast(sp, coeffs.dim() - 1))
    if out_bitrev:
        return dif(scaled, False)
    return ntt(scaled)


