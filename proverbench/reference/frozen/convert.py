"""Moving u32 arrays between the reference's numpy form and the port's
int32 tensors (bit views, no value change)."""

from __future__ import annotations

import numpy as np
import torch


def _check_transfer(what: str, device) -> None:
    """Raise inside a CUDA graph capture (machine/jit_prover.py)."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(f"{what} inside a captured stage: the graph would "
                           f"replay a stale host buffer (make the array a "
                           f"`table` built by the stage's eager first run)")


def from_reference(arr, device="cpu") -> torch.Tensor:
    """u32 array (trace, table, digests; any integer dtype whose values fit
    in 32 bits) -> int32 tensor holding the same bit patterns."""
    _check_transfer("a host upload", device)
    a = np.asarray(arr)
    if a.dtype != np.uint32:
        if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
            raise ValueError("values do not fit in u32")
        a = a.astype(np.uint32)
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a.view(np.int32).copy())
    if torch.device(device).type == "cuda":
        # from page-locked memory the copy is queued behind the device's
        # work instead of waiting for it
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> np.uint32 array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32, got {t.dtype}")
    _check_transfer("a copy to the host", t.device)
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32).copy()


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2^32) -> int32 with the same low bits."""
    return (((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def u32_as_int64(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & 0xFFFFFFFF


_TABLES: dict = {}


def table(make, *args, device):
    """Device copy of the host table `make(*args)` (a cached numpy
    function returning an array or a tuple of arrays), made once per
    device."""
    key = (make, args, str(device))
    t = _TABLES.get(key)
    if t is None:
        arr = make(*args)
        t = (tuple(from_reference(a, device) for a in arr)
             if isinstance(arr, tuple) else from_reference(arr, device))
        _TABLES[key] = t
    return t


_INDICES: dict = {}


# ---------------------------------------------------------------------------
# PCS proofs across the two packages
# ---------------------------------------------------------------------------
#
# A proof of either package holds numpy u32 arrays, tuples and python ints
# under the same field names; only the dataclasses differ.  The two
# functions below rebuild one package's dataclasses from the other's
# values, so a proof made by one can be handed to the other's verifier.
# The reference's classes are passed in (its modules commit.fri and
# commit.pcs), since this package imports nothing of it.


# ---------------------------------------------------------------------------
# Machine proofs across the two packages
# ---------------------------------------------------------------------------
#
# Machines are carried across by building them from the same seed in each
# package; their proofs by the two functions below, field by field.


