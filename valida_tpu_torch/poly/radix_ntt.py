"""The device NTT: natural-in, bitrev-out DIF over axis 0, as kernels.

Counterpart of valida_tpu/poly/mxu_ntt.py (named for the TPU's matrix unit,
which the H100 lacks).  Outputs are bit-identical to poly/ntt.dif.

`dif_whole` -> ntt_dif_whole (replaces mxu_ntt._mega_pallas), for the
widths the reference sends to its whole-transform kernel (`_mega_supported`).
Radix-2 butterflies in shared memory: level s pairs row j with row j + h,
h = n >> (s+1), in place, and multiplies the difference by
pw[(j mod h) << s], pw = ntt._root_powers.  The log_n levels are split
into the fewest passes of at most `T_MAX` (`_pass_levels`).  A pass over
levels s0 .. s0+T-1 cuts the rows into row sets
(hi << (log_n-s0)) + i·S + low, i < 2^T, S = 2^(log_n-s0-T), which those
levels pair among themselves; a tile (a row set's 2^T rows x a few columns,
64 KB) is loaded into shared memory once, all T levels run there, and it
is written back once, so every word crosses device memory twice a pass
and the butterflies cost 8 integer instructions each.  The first pass reads
the input and writes the output, the later ones run in place: no scratch.
`dif_whole_plain` follows the same passes, row sets and twiddle index
formula (`_pass_twiddle_index`), so a CPU test catches an indexing error.

`step` -> ntt_step (replaces mxu_ntt._step_pallas) and `tail` -> ntt_tail
(replaces mxu_ntt._tail_pallas) serve the other widths with the
reference's radix-128 four-step scheme and its tables: up to 7 butterfly
levels at once as a 128-point DFT product along axis 0, by the identity

    X[u + B·v] = DFT_M( w^{u·t} · Σ_i (w^M)^{u·i} x[i·M + t] )[v]

(`w` the order-L root, B = 128, M = L/B): one exact [128,128] modular
product (128 wide multiply-adds per word on the CUDA cores, which is what
bounds these two), a pointwise twiddle, and a bit-reversal of the output
rows folded into the matrix, then recursion on the M-point blocks.  The
log2(N) mod 7 remainder step comes first, so the last (M = 1) step is
always a full 128-point transform without twiddle.

Each kernel (csrc/ntt.cu) stands beside its plain PyTorch version.  A CPU
tensor runs the plain version; a CUDA tensor runs the kernel.  The
reference's lane padding to a multiple of 8 (a Mosaic tile rule) is gone:
the step kernels mask the ragged column edge themselves.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..convert import table
from ..field import babybear as bb

B = 128
LOG_B = 7
T_MAX = 11  # most butterfly levels of one pass of the whole-transform kernel

# ---------------------------------------------------------------------------
# Host tables (own copies of the reference's, cached per shape)
# ---------------------------------------------------------------------------


def _dft_matrix(root: int, size: int) -> np.ndarray:
    """[size, size] canonical u32: D[u, i] = root^(u*i) mod p."""
    pw = np.ones(size, dtype=np.uint64)
    for k in range(1, size):
        pw[k] = pw[k - 1] * root % bb.P
    exps = (np.arange(size, dtype=np.uint64)[:, None]
            * np.arange(size, dtype=np.uint64)[None, :]) % size
    return pw[exps.astype(np.int64)].astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _step_dft(log_len: int, inverse: bool, radix_log: int) -> np.ndarray:
    """[128, 128] canonical DFT matrix of a radix-2^radix_log step of the
    order-2^log_len transform, embedded at full width as kron(D_R, I_rep)
    (rep = 128/R), with output rows in bit-reversed order."""
    from .ntt import bitrev_indices

    size = 1 << radix_log
    rep = B // size
    w = bb.two_adic_generator(log_len)
    if inverse:
        w = bb.h_inv(w)
    w_b = pow(w, (1 << log_len) // size, bb.P)
    d = _dft_matrix(w_b, size).astype(np.uint64)
    d = d[bitrev_indices(radix_log)]
    if rep > 1:
        d = np.kron(d, np.eye(rep, dtype=np.uint64))
    return d


@functools.lru_cache(maxsize=None)
def _tail_dft(inverse: bool) -> np.ndarray:
    """[128, 128] canonical matrix of the final (M = 1) 128-point step."""
    from .ntt import bitrev_indices

    w = bb.two_adic_generator(LOG_B)
    if inverse:
        w = bb.h_inv(w)
    d = _dft_matrix(w, B).astype(np.uint64)
    return d[bitrev_indices(LOG_B)]


@functools.lru_cache(maxsize=None)
def _step_twiddles(log_len: int, inverse: bool, radix_log: int) -> np.ndarray:
    """Montgomery table [M4, 128] in _step_dft's embedded row order: row
    a*rep + s at position t holds w^(rev(a) * (s*M4 + t)), M4 = 2^(log_len-7)."""
    from .ntt import _powers_host, bitrev_indices

    size = 1 << radix_log
    rep = B // size
    m4 = 1 << (log_len - LOG_B)
    w = bb.two_adic_generator(log_len)
    if inverse:
        w = bb.h_inv(w)
    rev = bitrev_indices(radix_log)
    rows = []
    for a in range(size):
        wu = pow(w, int(rev[a]), bb.P)
        row_base = _powers_host(wu, m4).astype(np.uint64)  # w^(u*t)
        for s in range(rep):
            scale = np.uint64(pow(wu, s * m4, bb.P))
            rows.append(row_base * scale % np.uint64(bb.P))
    tw = np.stack(rows)
    return ((tw.T << 32) % np.uint64(bb.P)).astype(np.uint32)


def _radix_schedule(log_n: int) -> list:
    """Per-step level counts, remainder first, so the last (twiddle-free,
    M = 1) step is always a full 2^7-point transform."""
    r0 = log_n % LOG_B
    return ([r0] if r0 else []) + [LOG_B] * (log_n // LOG_B)


def _mega_supported(log_n: int, rest_n: int) -> bool:
    """Shapes the whole-transform kernel takes (the reference's routing)."""
    return log_n >= 2 * LOG_B and rest_n % 128 == 0 and rest_n <= 2048


def _steps(log_n: int):
    """[(blocks, log_len, radix_log, last)] of the schedule."""
    out, blocks, log_len = [], 1, log_n
    schedule = _radix_schedule(log_n)
    for i, radix_log in enumerate(schedule):
        out.append((blocks, log_len, radix_log, i == len(schedule) - 1))
        blocks <<= radix_log
        log_len -= radix_log
    return out


def _pass_levels(log_n: int, t_max: int = T_MAX) -> list:
    """Level counts of the whole-transform kernel's passes: the fewest
    passes of at most t_max levels, as even as they go, the larger first
    (csrc/ntt.cu::ntt_dif_whole_launch computes the same split)."""
    k = -(-log_n // t_max)
    base, extra = divmod(log_n, k)
    return [base + 1] * extra + [base] * (k - extra)


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
# Plain PyTorch versions (exact; any device)
# ---------------------------------------------------------------------------


def _mod_matmul_plain(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(D @ x) mod p over axis -2, as int64 in [0, p).

    The contraction runs as float64 products of D (< 2^31) with 11-bit
    limbs of x: every partial sum stays below 128·2^31·2^11 = 2^49 < 2^53,
    so each product is exact on any device (integer matmul has no CUDA
    implementation)."""
    dd = d.to(torch.float64)
    xl = x.to(torch.int64)
    acc = None
    for shift in (0, 11, 22):
        limb = ((xl >> shift) & 0x7FF).to(torch.float64)
        part = torch.matmul(dd, limb).to(torch.int64) % bb.P
        part = part * ((1 << shift) % bb.P) % bb.P
        acc = part if acc is None else (acc + part) % bb.P
    return acc


def step_plain(x3: torch.Tensor, d: torch.Tensor, tw: torch.Tensor,
               rest_n: int) -> torch.Tensor:
    """One non-final step on x3 [blocks, 128, M4·rest_n]: the modular
    product with d [128,128], then the Montgomery twiddle tw [M4, 128]."""
    blocks, _, cols = x3.shape
    m4 = cols // rest_n
    y = _mod_matmul_plain(d, x3).view(blocks, B, m4, rest_n)
    t = tw.to(torch.int64).t().reshape(1, B, m4, 1)
    y = y * t % bb.P * bb.R_INV % bb.P
    return y.reshape(blocks, B, cols).to(torch.int32)


def tail_plain(x3: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The final step on x3 [blocks, 128, rest_n]: blockwise 128-point
    transforms, no twiddle."""
    return _mod_matmul_plain(d, x3).to(torch.int32)


def dif_whole_plain(a: torch.Tensor, log_n: int, inverse: bool,
                    t_max: int = T_MAX) -> torch.Tensor:
    """Plain version of the whole-transform kernel, pass by pass as the
    kernel runs them: a [n, rest_n]."""
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
            lo = bb.add(x0, x1)
            hi = bb.mul(bb.sub(x0, x1), tw[:, :, None])
            a = torch.stack([lo, hi], dim=2).reshape(n, rest_n)
        s0 += t
    return a


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensor -> plain version, CUDA tensor -> kernel
# ---------------------------------------------------------------------------


def step(x3: torch.Tensor, d: torch.Tensor, tw: torch.Tensor,
         rest_n: int) -> torch.Tensor:
    if x3.device.type == "cpu":
        return step_plain(x3, d, tw, rest_n)
    blocks, _, cols = x3.shape
    _build.check_input(x3, "ntt_step x", (blocks, B, cols))
    _build.check_input(d, "ntt_step d", (B, B))
    _build.check_input(tw, "ntt_step tw", (cols // rest_n, B))
    y = torch.empty_like(x3)
    _build.launch("ntt", "ntt_step_launch", x3, y, d, tw, blocks, cols, rest_n)
    _build.LAUNCHES["ntt_step"] += 1
    return y


def tail(x3: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    if x3.device.type == "cpu":
        return tail_plain(x3, d)
    blocks, _, cols = x3.shape
    _build.check_input(x3, "ntt_tail x", (blocks, B, cols))
    _build.check_input(d, "ntt_tail d", (B, B))
    y = torch.empty_like(x3)
    _build.launch("ntt", "ntt_tail_launch", x3, y, d, blocks, cols)
    _build.LAUNCHES["ntt_tail"] += 1
    return y


def dif_whole(a: torch.Tensor, log_n: int, inverse: bool,
              t_max: int = T_MAX) -> torch.Tensor:
    """The whole DIF of a [n, rest_n], rest_n a multiple of 128, through
    one call of the kernel's entry (a launch per pass)."""
    if a.device.type == "cpu":
        return dif_whole_plain(a, log_n, inverse, t_max)
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
    _build.LAUNCHES["ntt_dif_whole"] += 1
    return out


# ---------------------------------------------------------------------------
# Public transform
# ---------------------------------------------------------------------------


def _run_steps(a, log_n, inverse, step_fn, tail_fn):
    n, rest_n = a.shape
    for blocks, log_len, radix_log, last in _steps(log_n):
        if last:
            d = table(_tail_dft, inverse, device=a.device)
            a = tail_fn(a.reshape(blocks, B, rest_n), d)
        else:
            d = table(_step_dft, log_len, inverse, radix_log, device=a.device)
            tw = table(_step_twiddles, log_len, inverse, radix_log,
                       device=a.device)
            m4 = 1 << (log_len - LOG_B)
            a = step_fn(a.reshape(blocks, B, m4 * rest_n), d, tw, rest_n)
    return a.reshape(n, rest_n)


def _dif(a, inverse, whole_fn, step_fn, tail_fn):
    n = int(a.shape[0])
    log_n = n.bit_length() - 1
    if 1 << log_n != n or log_n < LOG_B:
        raise ValueError("radix_ntt.dif needs a power-of-two length >= 128")
    rest = tuple(a.shape[1:])
    a2 = a.reshape(n, -1).contiguous()
    if _mega_supported(log_n, a2.shape[1]):
        out = whole_fn(a2, log_n, inverse)
    else:
        out = _run_steps(a2, log_n, inverse, step_fn, tail_fn)
    return out.reshape((n,) + rest)


def dif(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Natural-in, bitrev-out DIF over axis 0; bit-identical to ntt.dif.

    a: int32 [N, ...] Montgomery form, N a power of two >= 128.  Widths
    the whole-transform kernel takes go there; the rest run step by step."""
    return _dif(a, inverse, dif_whole, step, tail)


def dif_plain(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """`dif` through the plain versions only, on any device."""
    return _dif(a, inverse, dif_whole_plain, step_plain, tail_plain)
