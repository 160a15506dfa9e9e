"""Two-adic evaluation domains and zerofiers.

Counterpart of valida_tpu/poly/domain.py: Z_H(x) = x^N - 1 has closed-form
values on a coset of a larger subgroup, periodic along the coset.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..convert import from_reference
from ..field import babybear as bb
from .ntt import _powers_host


@functools.lru_cache(maxsize=None)
def coset_points(log_n: int, shift: int) -> np.ndarray:
    """Points shift·g^i of the coset in natural order, Montgomery form
    (host table, np.uint32 [2^log_n])."""
    canon = _powers_host(bb.two_adic_generator(log_n), 1 << log_n)
    canon = canon.astype(np.uint64) * np.uint64(shift % bb.P) % np.uint64(bb.P)
    return ((canon << 32) % np.uint64(bb.P)).astype(np.uint32)


def coset_points_device(log_n: int, shift: int, device, start: int = 0,
                        count: int | None = None,
                        mul=bb.mul) -> torch.Tensor:
    """The words of `coset_points` (or of its rows [start, start + count)),
    built on `device` from log_n scalar constants (square and multiply over
    the bits of the index, by `mul`) rather than copied from a host
    table."""
    n = (1 << log_n) if count is None else count
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    acc = torch.full((n,), bb.monty_scalar(shift % bb.P), dtype=torch.int32,
                     device=device)
    g = bb.two_adic_generator(log_n)
    for b in range(log_n):
        gb = bb.monty_scalar(bb.h_exp(g, 1 << b))
        acc = torch.where(((idx >> b) & 1).bool(), mul(acc, gb), acc)
    return acc


class ZerofierOnCoset:
    """Z_H(x) = x^N - 1 (H of size N = 2^log_n) on the coset shift·K with K
    of size N·2^log_blowup.

    Z repeats with period 2^log_blowup along the natural-order coset:
    Z(shift·k^j) = shift^N · (k^N)^j - 1, and k^N has order 2^log_blowup.
    Arrays are host np.uint32 in Montgomery form.
    """

    def __init__(self, log_n: int, log_blowup: int, shift: int):
        self.log_n = log_n
        self.log_blowup = log_blowup
        self.shift = shift % bb.P
        n = 1 << log_n
        k = bb.two_adic_generator(log_n + log_blowup)
        kn = bb.h_exp(k, n)  # order 2^log_blowup
        sn = bb.h_exp(self.shift, n)
        zs = [bb.h_sub(sn * bb.h_exp(kn, j) % bb.P, 1)
              for j in range(1 << log_blowup)]
        self._z_period = np.array([bb.monty_scalar(z) for z in zs],
                                  dtype=np.uint32)
        self._zinv_period = np.array(
            [bb.monty_scalar(bb.h_inv(z)) for z in zs], dtype=np.uint32)

    def zerofier_evals(self) -> np.ndarray:
        """Z_H over the whole coset (natural order), [N·2^b]."""
        return np.tile(self._z_period, 1 << self.log_n)

    def zerofier_inv_evals(self) -> np.ndarray:
        return np.tile(self._zinv_period, 1 << self.log_n)

    def lagrange_basis_unnormalized(self, i: int) -> np.ndarray:
        """L_i(x) ∝ Z_H(x)/(x - g^i) over the coset (natural order)."""
        x = from_reference(coset_points(self.log_n + self.log_blowup,
                                        self.shift))
        gi = bb.h_exp(bb.two_adic_generator(self.log_n), i)
        denom = bb.sub(x, bb.monty_scalar(gi))
        z = from_reference(self.zerofier_evals())
        return bb.mul(z, bb.inv(denom)).numpy().view(np.uint32)
