"""The device NTT: natural-in, bitrev-out DIF over axis 0, as kernels.

Counterpart of valida_tpu/poly/mxu_ntt.py (named for the TPU's matrix unit,
which the H100 lacks).  Outputs are bit-identical to poly/ntt.dif.

Both kernels (csrc/ntt.cu) run radix-2 butterflies in shared memory, pass
by pass: level s pairs row j with row j + h, h = n >> (s+1), in place, and
multiplies the difference by pw[(j mod h) << s], pw = ntt._root_powers.
The log_n levels are split into the fewest passes of at most `T_MAX`
(`_pass_levels`).  A pass over levels s0 .. s0+T-1 cuts the rows into row
sets (hi << (log_n-s0)) + i·S + low, i < 2^T, S = 2^(log_n-s0-T), which
those levels pair among themselves; a tile (a row set's 2^T rows x a group
of columns, at most 64 KB) is loaded into shared memory once, all T levels
run there, and it is written back once, so every word crosses device memory
twice a pass and the butterflies cost 8 integer instructions each.  The
first pass reads the input and writes the output, the later ones run in
place: no scratch.

* `dif_whole` -> ntt_dif_whole (replaces mxu_ntt._mega_pallas): widths
  that are a multiple of 128, in 16-byte units, 4 columns a thread.
* `dif_ragged` -> ntt_dif_ragged (replaces mxu_ntt._step_pallas and
  _tail_pallas, the two pieces of the TPU's radix-128 four-step transform):
  every other width, one word a thread, the columns cut into
  `_column_groups` with the last group's edge masked, in passes short
  enough for whole rows where pieces of rows would waste sectors
  (`_ragged_t_max`).  The TPU needs the steps because its matrix unit does
  7 levels as one [128,128] product; butterflies need neither the matrices
  nor the split.

`dif_passes_plain` follows the same passes, row sets and twiddle index
formula (`_pass_twiddle_index`) on any width, so a CPU test catches an
indexing error of either kernel.  A CPU tensor runs it; a CUDA tensor runs
the kernel or raises.  The reference's lane padding to a multiple of 8 (a
Mosaic tile rule) is gone: the ragged kernel masks the column edge itself.
"""

from __future__ import annotations

import torch

from .. import _build
from ..convert import table
from ..field import babybear as bb

MIN_LOG_N = 7  # ntt.dif runs smaller transforms in its plain stage loop
T_MAX = 11  # most butterfly levels of one pass
TILE_WORDS = 1 << 14  # most words of a ragged tile (64 KB), R_TILE_WORDS
RAGGED_THREADS = 256  # threads of a ragged block (R_THREADS), a lane each
L2_WORDS = 50 << 18  # the H100's 50 MB L2 cache in words

# ---------------------------------------------------------------------------
# Pass geometry (the kernels' own, computed again on the host)
# ---------------------------------------------------------------------------


def _pass_levels(log_n: int, t_max: int = T_MAX) -> list:
    """Level counts of both kernels' passes: the fewest passes of at most
    t_max levels, as even as they go, the larger first (csrc/ntt.cu's
    launchers compute the same split)."""
    k = -(-log_n // t_max)
    base, extra = divmod(log_n, k)
    return [base + 1] * extra + [base] * (k - extra)


def _column_groups(rest_n: int, t: int) -> list:
    """[(c0, width)] of the ragged kernel's column groups in a pass of t
    levels: the fewest groups of at most min(TILE_WORDS >> t,
    RAGGED_THREADS) columns, as even as they go, the last one narrower
    where the width does not divide (csrc/ntt.cu::ragged_columns)."""
    c_max = min(TILE_WORDS >> t, RAGGED_THREADS)
    k = -(-rest_n // c_max)
    cols = -(-rest_n // k)
    return [(c0, min(cols, rest_n - c0)) for c0 in range(0, rest_n, cols)]


def _ragged_t_max(log_n: int, rest_n: int) -> int:
    """Most levels of a ragged pass.  A row piece that starts inside a
    32-byte sector moves a sector more than it holds; unless a row is a
    multiple of 8 words, every piece narrower than a row does.  Once the
    array outgrows the L2 cache, tiles of whole rows (2^t x rest_n <=
    TILE_WORDS) pay for one pass more: on the H100 three passes of whole
    rows beat two of pieces at 2^19 and 2^20 rows x 51, 79 and 100 columns,
    and lost at widths 10, 32, 64 and 200 and at 2^16 and 2^17 rows
    (experiments/kernel_experiments.py)."""
    if rest_n % 8 == 0 or rest_n << log_n <= L2_WORDS:
        return T_MAX
    t = min(T_MAX, (TILE_WORDS // rest_n).bit_length() - 1)
    if t >= 1 and -(-log_n // t) <= -(-log_n // T_MAX) + 1:
        return t
    return T_MAX


def _pass_twiddle_index(log_n: int, s0: int, t: int, lv: int,
                        device) -> torch.Tensor:
    """Indices [2^(t-1-lv), S] into ntt._root_powers for local level lv of
    the pass over levels s0 .. s0+t-1, S = 2^(log_n-s0-t) its row stride:
    the row set with offset `low` multiplies the difference of its tile
    rows i and i + hl, hl = 2^(t-1-lv), by entry ((i mod hl)·S + low) <<
    (s0+lv), the kernel's formula.  It is (j mod h) << s of the whole
    transform's level s = s0+lv, h = hl·S, for the global row j."""
    stride = 1 << (log_n - s0 - t)
    k = torch.arange(1 << (t - 1 - lv), device=device)[:, None]
    low = torch.arange(stride, device=device)[None, :]
    return (k * stride + low) << (s0 + lv)


# ---------------------------------------------------------------------------
# Plain PyTorch version (exact; any device)
# ---------------------------------------------------------------------------


def dif_passes_plain(a: torch.Tensor, log_n: int, inverse: bool,
                     t_max: int = T_MAX) -> torch.Tensor:
    """Plain version of both kernels, pass by pass as they run them:
    a [n, rest_n] of any width (columns are independent, so the column
    groups of a pass need no counterpart here)."""
    from .ntt import _root_powers

    n, rest_n = a.shape
    pw = table(_root_powers, log_n, inverse, device=a.device)
    s0 = 0
    for t in _pass_levels(log_n, t_max):
        stride = 1 << (log_n - s0 - t)
        for lv in range(t):
            hl = 1 << (t - 1 - lv)
            tw = pw[_pass_twiddle_index(log_n, s0, t, lv, a.device)]
            # [hi, tile rows as (block, half, i mod hl), low, columns]
            x = a.reshape(1 << s0, 1 << lv, 2, hl, stride, rest_n)
            x0, x1 = x[:, :, 0], x[:, :, 1]
            lo = bb.add_plain(x0, x1)
            hi = bb.mul_plain(bb.sub_plain(x0, x1), tw[:, :, None])
            a = torch.stack([lo, hi], dim=2).reshape(n, rest_n)
        s0 += t
    return a


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensor -> plain version, CUDA tensor -> kernel
# ---------------------------------------------------------------------------


def dif_whole(a: torch.Tensor, log_n: int, inverse: bool,
              t_max: int = T_MAX) -> torch.Tensor:
    """The whole DIF of a [n, rest_n], rest_n a multiple of 128, through
    one call of the kernel's entry (a launch per pass)."""
    if a.device.type == "cpu":
        return dif_passes_plain(a, log_n, inverse, t_max)
    from .ntt import _root_powers

    rest_n = a.shape[1]
    _build.check_input(a, "ntt_dif_whole x", (1 << log_n, rest_n))
    if rest_n % 128 or not 1 <= t_max <= T_MAX or a.data_ptr() % 16:
        raise ValueError("ntt_dif_whole: expected a 16-byte aligned array "
                         f"whose width is a multiple of 128 and 1 <= t_max "
                         f"<= {T_MAX}, got width {rest_n}, t_max {t_max}")
    pw = table(_root_powers, log_n, inverse, device=a.device)
    out = torch.empty_like(a)
    _build.launch("ntt", "ntt_dif_whole_launch", a, out, pw, log_n, rest_n,
                  t_max)
    _build.count_launch("ntt_dif_whole")
    return out


def dif_ragged(a: torch.Tensor, log_n: int, inverse: bool,
               t_max: int | None = None) -> torch.Tensor:
    """The whole DIF of a [n, rest_n] of any width through one call of the
    kernel's entry (a launch per pass); t_max by default `_ragged_t_max`."""
    rest_n = a.shape[1]
    if t_max is None:
        t_max = _ragged_t_max(log_n, rest_n)
    if a.device.type == "cpu":
        return dif_passes_plain(a, log_n, inverse, t_max)
    from .ntt import _root_powers

    _build.check_input(a, "ntt_dif_ragged x", (1 << log_n, rest_n))
    if rest_n < 1 or not 1 <= t_max <= T_MAX:
        raise ValueError(f"ntt_dif_ragged: expected 1 <= t_max <= {T_MAX} "
                         f"and a column, got width {rest_n}, t_max {t_max}")
    pw = table(_root_powers, log_n, inverse, device=a.device)
    out = torch.empty_like(a)
    _build.launch("ntt", "ntt_dif_ragged_launch", a, out, pw, log_n, rest_n,
                  t_max)
    _build.count_launch("ntt_dif_ragged")
    return out


# ---------------------------------------------------------------------------
# Public transform
# ---------------------------------------------------------------------------


def _pass_kernel(rest_n: int):
    """The wrapper that runs a width: the whole-width kernel's 16-byte
    units need a multiple of 128 columns, the ragged one takes the rest."""
    return dif_whole if rest_n % 128 == 0 else dif_ragged


def dif(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Natural-in, bitrev-out DIF over axis 0; bit-identical to ntt.dif.

    a: int32 [N, ...] Montgomery form, N a power of two >= 128.  Widths
    that are a multiple of 128 run ntt_dif_whole, the rest ntt_dif_ragged."""
    n = int(a.shape[0])
    log_n = n.bit_length() - 1
    if 1 << log_n != n or log_n < MIN_LOG_N:
        raise ValueError("radix_ntt.dif needs a power-of-two length >= 128")
    a2 = a.reshape(n, -1).contiguous()
    return _pass_kernel(a2.shape[1])(a2, log_n, inverse).reshape(a.shape)
