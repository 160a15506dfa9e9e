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



MIN_LOG_N = 7  # ntt.dif runs smaller transforms in its plain stage loop
T_MAX = 11  # most butterfly levels of one pass
TILE_WORDS = 1 << 14  # most words of a ragged tile (64 KB), R_TILE_WORDS
RAGGED_THREADS = 256  # threads of a ragged block (R_THREADS), a lane each
L2_WORDS = 50 << 18  # the H100's 50 MB L2 cache in words

# ---------------------------------------------------------------------------
# Pass geometry (the kernels' own, computed again on the host)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Plain PyTorch version (exact; any device)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensor -> plain version, CUDA tensor -> kernel
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Public transform
# ---------------------------------------------------------------------------


