#!/usr/bin/env python3
"""Drive valida_tpu_torch's trace commit, PCS proof and machine prover on
one CUDA GPU and hold every kernel against its plain PyTorch version.

    python3 chip_smoke.py

Builds the kernels from valida_tpu_torch/csrc with nvcc on first use, then:
1. prints the card's name and power limit;
2. builds every kernel (one nvcc per source, in parallel) and the native
   interpreter core (g++), and times them;
3. compares each kernel with its plain version on the card, word for word:
   ntt_dif_whole (one, two and three passes, even and uneven splits,
   constant arrays of 0 and p - 1), ntt_dif_ragged (the same, at ragged
   widths from 1 to 200 columns), keccak256 and poseidon2 at the listed
   shapes; then (field): the field kernels of csrc/field.cu,
   field_elementwise (every op code), field_ext_mul, field_inv and
   field_ext_inv, on random words from a numpy seed at 2^20 and 2^21
   elements (canonical words and any u32 bit pattern), on every pair of
   edge words (0, 1, p - 1, p, 2p, 2^31 - 1, 2^31, 2^32 - 1, ...), and on the
   prover's broadcast patterns ([K, Q] x [K, 1], [n, 1] x [1, 5], a 0-d
   tensor, a scalar word, a strided view, a column, an empty tensor);
4. runs three commits through `commit_forward`, each with the launch
   counters set to 0 just before it and read just after, requires every
   kernel of that path to have launched (the field kernels on every path),
   records every kernel call of the commit (of the field kernels' calls
   every 64th of each kernel) and holds its output against the plain
   version on the same inputs, and checks each root against the one the
   JAX package's numpy path computed:
   (a) `__graft_entry__.entry()`'s seed-0 [2^12, 32] trace,
   (b) the full-size commit, 2^19 x 128 (bench.py's shape),
   (c) 2^19 x 51, an odd width;
   then (s): the streamed commit (`lde_commit_streamed`) of
   benchmarks/sweep.py's input at 2^24 x 64, blowup 1, under Keccak and
   under Poseidon2, with the same counters and recorded calls, each timed
   (best of 3) with its device memory peak; the Keccak root and every level
   held to the monolithic commit's (`coset_lde`, `merkle_levels`) in the
   same call, whose time and peak print beside; a tiled run (col_tile 16,
   row_tile 2^20) at 2^22 x 64 held to the untiled one; the roots at 2^16 x
   64 held to the JAX package's;
   then (p): the distributed primitives of valida_tpu_torch.parallel on a
   one-rank NCCL group (`make_mesh(1)`): `dist_dif` forward and inverse at
   2^20 x 51 and 2^19 x 128, `dist_coset_lde` at 2^20 x 51,
   `sharded_prove_fn` at B = 2, N = 2^19, C = 51, K = 8 and
   `dryrun_multichip(1)`, counted and recorded, each held to the
   single-card functions' words, then timed beside them;
   then three PCS proofs through `TwoAdicFriPcs` (commit two rounds, open
   at extension points, verify on the host, reject a tampered proof), with
   the same counters, recorded calls and pinned digests of the JAX
   package's proof:
   (d) Poseidon2 trees, 2^19 x 128 and 2^16 x 51, then 2^19 x 10,
   (d') the same at 2^16 x 128, 2^13 x 51 and 2^16 x 10,
   (e) (d')'s shape with Keccak trees;
   then four machine proofs through `Machine.prove` on the card and
   `Machine.verify` on the host, with the same counters and recorded calls:
   (m) `random_mini_machine(48, seed=3)`, the golden fixture's machine and
       config, whose proof must serialize to the bytes of
       tests/fixtures/mini_proof_v1.cbor;
   (f') `random_ragged_machine(2^14, seed=7)` under `default_config()` and
   (g') the same with Poseidon2 trees, each proof's serialized bytes held to
       the SHA-256 of the JAX package's;
   (f) `random_ragged_machine(2^20, seed=7)` under `default_config()`
       (heights 2^20, 2^17, 16, 1; debug checks on): its preprocessed and
       main-trace roots held to the JAX package's, and a changed opened
       trace value and a changed cumulative sum each rejected with the
       error class the JAX package's verifier raises;
   then BasicMachine (Valida VM) programs, interpreted on the host by the
   Python step loop (`run`) or the C++ core (`run_native`, its op logs as
   lists or as arrays) and proved on the card under `default_config()`,
   with the same counters and recorded calls:
   (n) fib(25) by `run`, with its interpreter profile (clock 192, 401
       memory operations, 105 adds, fib(25) at fp + 4), its proof's bytes
       held to the SHA-256 of the JAX package's;
   (h') the ALU loop at 2^13 cycles, likewise, once by each interpreter;
   (h) the ALU loop at 2^20 cycles (the "alu_u32 full ISA trace") by
       `run`: its preprocessed and main-trace roots held to the JAX
       package's, the port's verifier, and the two tampers of (f);
   (k) the same by `run_native(build_lists=False)`: its op arrays held to
       (h)'s logs converted, then as (h);
   then (quot): the quotient kernel of csrc/constraint.cu
   (`constraint_eval`) held against `quotient_rows_plain` word for word
   for every chip of (k)'s machine at (k)'s heights, on random LDE words,
   in the bit-reversed form the staged prover reads in place, the natural
   form with a stride, and (cpu, mem) a mesh rank's block and halo from
   row0 = Q/2, and each chip's kernel timed beside its plain version and
   bound (a machine prove launches it once a chip, on every machine path;
   every call a recorded path makes, (jm)'s one-rank NCCL mesh form
   included, is held against plain as it returns);
   then the staged prover (`prove_jit`: each stage a CUDA graph captured
   at its first call and replayed after), the kernel calls of its eager
   first runs recorded and held against plain, the graphs released after
   each path:
   (f' jit), (g' jit) (f') and (g') by `prove_jit`, twice each (the second
       replays only), to the same SHA-256 pins;
   (h' jit) (h') by `prove_jit` to its pin, then the same ALU loop with one
       immediate changed, whose prove must replay the same graphs (no new
       capture) and give the eager prover's bytes of that program;
   then two machine compositions by the C++ core in array mode, each proof
   held to the SHA-256 of the JAX package's: (x) `ExtendedMachine` (the
   native field chip) and (l) `LoadStoreMachine` (no ALU chips);
   then (cli): `python -m valida_tpu_torch.tooling.cli` asm, run, prove
   and verify of tests/programs/fibonacci.val, each in a process of its
   own: the output tape, the proof file's SHA-256, verify's exit 0 and a
   flipped byte's exit 1 (prove's launch counters read in its process);
   then `prove --jit`, its file's SHA-256 and its time beside prove's;
5. times each kernel at the main path's shapes with CUDA events, beside its
   bound and its plain version (the field kernels, shorter than the host's
   enqueue of them, as CUDA graph replays), and times commits (b) and (c),
   the NTT, (d)'s commit and opening, (f)'s and (k)'s prove (median of 5, by stage,
   memory peak; (k): median of 3) and verify, (f)'s with a profile, and
   (h)'s prove by stage beside (k)'s; then path (j): (k)'s machine and op
   arrays under `default_config(debug_checks=False)` by `warmup_jit`
   (timed, kernel calls recorded) and `prove_jit`: its bytes held to an
   eager prove's in this run, its roots to (h)'s pins, the port's verifier
   and the two tampers, no capture in a warm prove, the median of 5
   proves, the memory peak with the graph pool, one prove by stage and one
   profiled, whose runs of our kernels on the device, and launches
   counted, must equal those of (k)'s recorded eager prove (the field
   kernels': those of (j)'s own eager first runs in its warm-up, since
   (k) runs the debug checks and (j) does not);
   then, on a one-rank NCCL process group (`make_mesh(1)`), the
   distributed staged prover: (jm) (j)'s machine and config by
   `warmup_jit(mesh=)` and `prove_jit(mesh=)`: its stage calls == the
   warm-up's, its bytes == (j)'s by SHA-256, its roots
   == (h)'s pins, the verifier and the two tampers, no capture and no
   eager collective in a warm prove, timed as (j) beside it, its warm
   prove's kernel runs on the device and counted launches == its eager
   first run's; (g'm) (g') by `prove_jit(mesh=)` twice, to (g')'s pin;
   the graphs released before the group is destroyed;
   and the ALU loop at 2^16 cycles, each proof's SHA-256 held to the JAX
   package's pin (`parallel.dryrun.ALU_LOOP_SHA256`), launches counted
   and kernel calls recorded: (k16) the eager prover under
   `default_config()`, (j16) `warmup_jit` then `prove_jit` under
   `default_config(debug_checks=False)`, (jm16) the same on the one-rank
   mesh; then (dryrun) `python -m valida_tpu_torch.parallel.dryrun 1
   --prove 16` in a process of its own, which must exit 0 with its proof
   equal to an eager prove's and the pin, and verified;
6. prints one JSON line of kernels, then the device line last.
Any mismatch, build failure or launch error raises: the exit code is then
non-zero and the last line is not printed.  With no GPU it exits 1.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

P = 2013265921
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# the H100's L2 holds 50 MB: the field kernels' timings read their operands
# from sets that hold four times that together (graph_ms)
L2_ROTATION = 4 * 50 * 2**20
# 32-bit integer add, logic, shift and multiply results per clock per SM on
# compute capability 9.0 (64 INT32 units per SM: NVIDIA H100 architecture
# whitepaper; CUDA C++ Programming Guide, arithmetic instruction throughput).
# The peak is this times the SM count times the card's maximum SM clock.
INT32_OPS_PER_CLOCK_PER_SM = 64
# 32-bit instructions of one radix-2 butterfly, as few as sm_90 needs: the
# Montgomery product of the difference is 3 multiplies (the 64-bit product,
# its low half by p^-1, the high half of that by p) and 2 others (subtract;
# add p and take the minimum, one fused add-minimum); the unreduced
# difference a + p - b is 1 three-input add; the modular sum is 2 (add;
# subtract p and minimum, fused).  Multiplies run on one unit at
# INT32_OPS_PER_CLOCK_PER_SM; the other 5 run on the integer ALUs at the
# same rate or on the multiplier (as a multiply-add by 1), so the two units
# share them: the least time is the larger of the multiplies alone and half
# of all instructions, both at that rate.  BUTTERFLY_OPS is that count of
# issue slots on one unit.
BUTTERFLY_MUL_OPS = 3
BUTTERFLY_ALU_OPS = 5
BUTTERFLY_OPS = max(BUTTERFLY_MUL_OPS,
                    (BUTTERFLY_MUL_OPS + BUTTERFLY_ALU_OPS) / 2)
# 32-bit instructions of one Keccak-f round on 64-bit lanes kept as 32-bit
# halves, with 3-input logic (LOP3) fused: theta 80 (column parities 20,
# five 1-bit rotations 10, lane updates 50), rho 48 (24 two-word funnel
# shifts), chi 50 (one LOP3 per half), iota 2.
KECCAK_F_OPS = 24 * 180
# 32-bit instructions of one Poseidon2 permutation with its block's
# absorption, as few as sm_90 needs.  A Montgomery product is 3 multiplies
# (the 64-bit product, its low half by p^-1, the high half of that by p)
# and 2 other instructions (subtract; add p and take the minimum, which is
# one fused add-minimum); a modular addition is 2 (add; subtract p and
# minimum, fused); a word is taken mod p by the product that absorbs it.
# Products: 8 external rounds x 16 lanes x 4 (x^7) + 13 internal rounds x
# (4 + 16 for the diagonal) = 772, and 8 to absorb a block.  Additions: 9
# external linear layers x 72 (per block of four 11, block sums 12, adding
# them 16) + 8 x 16 external constants + 13 x (1 constant + 15 lane sum +
# 16) = 1,192, and 8 to absorb.
# The two units share the additions as in a butterfly: the least time is
# the larger of the multiplies alone and half of all instructions.
POSEIDON2_PRODUCTS = 8 * 16 * 4 + 13 * (4 + 16) + 8
POSEIDON2_ADDITIONS = 9 * 72 + 8 * 16 + 13 * (1 + 15 + 16) + 8
POSEIDON2_MUL_OPS = POSEIDON2_PRODUCTS * 3
POSEIDON2_ALU_OPS = POSEIDON2_PRODUCTS * 2 + POSEIDON2_ADDITIONS * 2
POSEIDON2_BLOCK_OPS = max(POSEIDON2_MUL_OPS,
                          (POSEIDON2_MUL_OPS + POSEIDON2_ALU_OPS) / 2)

# issue slots of the field kernels (csrc/field.cuh), counted as above: a
# Montgomery product is 3 multiplies and 2 others; taking an operand word
# mod p (`canon`) is 3 others (add 2p where negative, subtract p, minimum).
# field_elementwise's mul: one product of two operands.  field_ext_mul,
# per element: 25 wide products accumulated by multiply-adds and 5
# reductions of 2 multiplies; 10 operands taken mod p, 5 doublings (2),
# 10 folds of the 64-bit sums and 5 reductions' corrections (2 each).
# field_inv: 39 products (29 squarings, 10 products) and one canon.
# field_ext_inv: 56 products (12 for three Frobenius maps, whose
# coefficient 0 is kept, 5 to scale by the norm's inverse, 39 in it), 2
# extension products as above without their canon, the norm's one
# coefficient (5 wide products and a reduction: 7 multiplies; 4 doublings,
# 2 folds and a correction: 14 others) and 5 canon.  The least time is the
# larger of the multiplies alone and half of all instructions, as for a
# butterfly.
CANON_OPS = 3
FIELD_OPS = {
    "field_elementwise": max(3, (3 + 2 + 2 * CANON_OPS) / 2),
    "field_ext_mul": max(35, (35 + 10 * CANON_OPS + 5 * 2 + 10 * 2
                              + 5 * 2) / 2),
    "field_inv": max(39 * 3, (39 * 5 + CANON_OPS) / 2),
    "field_ext_inv": max(56 * 3 + 2 * 35 + 7,
                         (56 * 5 + 2 * (35 + 40) + 7 + 14
                          + 5 * CANON_OPS) / 2),
}
# the field kernels (csrc/field.cu), which every path runs: a commit or a
# PCS proof runs the element-wise kernel (a PCS opening the extension
# product and inverse too), a BasicMachine prove all four
FIELD = ("field_elementwise", "field_ext_mul", "field_inv", "field_ext_inv")
FIELD_PCS = ("field_elementwise", "field_ext_mul", "field_ext_inv")
# a BasicMachine prove runs them and the quotient kernel
# (csrc/constraint.cu); the test machines' traces take no inverse, and the
# quotient's selector tables, which do, are built once per shape: a prove
# of theirs launches field_inv only where its shapes are new
MACHINE = FIELD + ("constraint_eval",)
RAGGED = FIELD_PCS + ("constraint_eval",)
# a path's field kernel calls held against plain: every FIELD_SAMPLE-th of
# each kernel (the first, then every 64th); a 2^20-cycle prove makes tens
# of thousands
FIELD_SAMPLE = 64

# 32-byte roots of commit_forward on default_rng(0) traces, computed by the
# JAX package's numpy path (tests/test_torch_commit.py::reference_commit_root)
GOLDEN = {
    (12, 32): "7cd48af1bdcfc50144513e2c26477c4de1d67e451e1152f067c39ff26463eeae",
    (19, 128): "af0e46960537c735b35b8bb12f0f7cc94b63e8e72a9185ec6ce319982343578e",
    (19, 51): "d9e86f3998abc1f8bac936f0adbe3457982f9e1360545d4dad503ea4c05aed0a",
}
# sum of the default_rng(0) trace's words mod 2^64, so that a different
# random stream shows as such and not as a wrong root
TRACE_SUMS = {(12, 32): 131840869016140, (19, 128): 67547734501292161,
              (19, 51): 26913798385434980}

# the commits of the main path: (log_n, cols) and the kernels each must run
PATHS = {
    "a": ((12, 32), ("ntt_dif_ragged", "keccak256", "field_elementwise")),
    "b": ((19, 128), ("ntt_dif_whole", "keccak256", "field_elementwise")),
    "c": ((19, 51), ("ntt_dif_ragged", "keccak256", "field_elementwise")),
}

# path (s): the streamed commit (valida_tpu_torch/commit/streamed.py) of
# benchmarks/sweep.py's input at the sweep's largest size, blowup 1, under
# each hasher, and the kernels each must and must not launch; the size,
# col_tile and row_tile of the tiled run; and the roots at 2^16 x 64 as the
# JAX package's numpy monolithic tree makes them (tests/
# test_torch_streamed.py::reference_streamed_root)
STREAMED_SHAPE = (24, 64)
STREAMED_TILED = ((22, 64), 16, 1 << 20)
STREAMED_PATHS = {
    "s keccak": ("keccak", ("ntt_dif_ragged", "keccak256",
                            "field_elementwise"),
                 ("ntt_dif_whole", "poseidon2")),
    "s poseidon2": ("poseidon2", ("ntt_dif_ragged", "poseidon2",
                                  "field_elementwise"),
                    ("ntt_dif_whole", "keccak256")),
}
STREAMED_GOLDEN = {
    "keccak":
        "6a0313650df25ac0378aec8adec1d89bce29c976489508c74b8e2772f26c6aaa",
    "poseidon2":
        "3812582230eeb73bbd437a3024a75f057bb37d6fddf13e5664dc1658d2fd421b",
}
# path (p): the distributed primitives (valida_tpu_torch/parallel) on a
# one-rank NCCL group: dist_dif at these (log_n, cols), dist_coset_lde at
# the first, sharded_prove_fn at (B, log_n, C, K), then the dry run; the
# kernels the path must and must not launch
DIST_DIF_SHAPES = [(20, 51), (19, 128)]
DIST_PROVE_SHAPE = (2, 19, 51, 8)
DIST_KERNELS = (("ntt_dif_whole", "ntt_dif_ragged", "keccak256",
                 "field_elementwise"), ("poseidon2",))

# the PCS proofs of the main path: (log_n, cols) of the three committed
# matrices (round 1 commits the first two, round 2 the third), the Merkle
# hasher, and the kernels each must and must not launch
PCS_PATHS = {
    "d": (((19, 128), (16, 51), (19, 10)), "poseidon2",
          ("poseidon2", "ntt_dif_whole", "ntt_dif_ragged") + FIELD_PCS,
          ("keccak256",)),
    "d'": (((16, 128), (13, 51), (16, 10)), "poseidon2",
           ("poseidon2", "ntt_dif_whole", "ntt_dif_ragged") + FIELD_PCS,
           ("keccak256",)),
    "e": (((16, 128), (13, 51), (16, 10)), "keccak",
          ("keccak256", "ntt_dif_whole", "ntt_dif_ragged") + FIELD_PCS,
          ("poseidon2",)),
}
# the opening point, an element of the degree-5 extension
PCS_Z = (1234567891, 987654321, 192837465, 564738291, 1029384756)
# default_config's FRI parameters (valida_tpu/core/config.py)
PCS_FRI = dict(log_blowup=1, num_queries=40, proof_of_work_bits=8,
               log_final=0)
# SHA-256 of the opened values and of the proof's words (proof_digest) and
# the two commitment roots, as the JAX package's numpy path produces them
# (tests/test_torch_pcs.py::reference_pcs_digests); at full width only the
# roots, which alone take it half an hour (::reference_pcs_roots)
PCS_GOLDEN = {
    "d": {
        "roots": ["edf2a50f1a1aa1735a939c46a5fce81a"
                  "9e76c74ac3612c51d7b4a15099a79b4c",
                  "0904782deffeb43f7132e117f28e4755"
                  "727bd26f19406a1274788c718c540e52"],
    },
    "d'": {
        "opened": "553285ed35cc59b76af54b2fc13c9910"
                  "4a148bb2a702f250fbc5009cacd87a0b",
        "proof": "f6f1b843a59f799fad813694bdbf3894"
                 "de171b6a627d5dd4b8f92778656d0456",
        "roots": ["c36c9147a247a70d79b77e4539e34e10"
                  "3efaa43f50d5cb60027f110812d65009",
                  "fa771c67f88fae3491a4dd4a39251d39"
                  "3f8c85160045a65724affd45d7690f24"],
    },
    "e": {
        "opened": "553285ed35cc59b76af54b2fc13c9910"
                  "4a148bb2a702f250fbc5009cacd87a0b",
        "proof": "78a592401eaaee3e48b5d3641a4f016c"
                 "6daa0a4a04be2eb2c9e09661b701c751",
        "roots": ["71ec0f126007be04d5dc77925347e25e"
                  "b3aa6d7738e5d520f9898578bf7bddc7",
                  "5132686b6a2ba0e1b065631fed934c58"
                  "33813ad3b3851e9175cf8efe0d3af6bf"],
    },
}

# the machine proofs of the main path: random_ragged_machine(2^log_pairs,
# seed=7) under default_config(hasher=...), and the kernels each must and
# must not launch.  (m) is the golden fixture's machine and config.
MACHINE_PATHS = {
    "m": (None, "keccak", ("keccak256", "ntt_dif_ragged") + RAGGED,
          ("poseidon2",)),
    "f'": (14, "keccak", ("keccak256", "ntt_dif_ragged") + RAGGED,
           ("poseidon2",)),
    "g'": (14, "poseidon2", ("poseidon2", "ntt_dif_ragged") + RAGGED,
           ("keccak256",)),
    "f": (20, "keccak", ("keccak256", "ntt_dif_ragged") + RAGGED,
          ("poseidon2",)),
}
FIXTURE = "tests/fixtures/mini_proof_v1.cbor"
# SHA-256 of the serialized proofs of (f') and (g') as the JAX package's
# numpy path makes them (tests/test_torch_machine.py::
# reference_machine_digest), and (f)'s preprocessed and main-trace roots
# (::reference_machine_roots)
MACHINE_GOLDEN = {
    "f'": "a39bfd949f99556153d5e7e38933031ecaf42575767c1bd9b969e21095b73579",
    "g'": "dbed0c5628f19d5c2b0e09da52dd8a3f7db033a99eba31d974a07dd14db0c086",
}
F_ROOTS = [
    "8faf36969aa9c1be23d84d92e1fcc7eeabee1d3f07acd4d2e67796bda7910e7c",
    "dbb207f4e5635f7d882c16ec684487c4d1d6dfdbcd4005f9975dce574cb26e8b",
]


# the BasicMachine programs of the main path: the program (fib(25), the
# Rust reference's basic/tests/test_prover.rs program, or the ALU loop of
# 2^k cycles, alu_loop_program(2^k // 14) as benchmarks/big_trace.py), the
# interpreter ("run": the Python step loop; "lists" and "arrays": the C++
# core, run_native(build_lists=True / False)) and the kernels each must and
# must not launch.  A path's pin is that of the first word of its name.
BASIC_KERNELS = (("keccak256", "ntt_dif_ragged") + MACHINE, ("poseidon2",))
# the distributed prover's paths (jm) and (g'm) on one rank: every LDE of
# 128 rows or more runs dist_dif, whose two steps' widths are multiples of
# 128 there (ntt_dif_whole)
MESH_KERNELS = {"jm": (("keccak256", "ntt_dif_whole") + MACHINE,
                       ("poseidon2",)),
                "g'm": (("poseidon2", "ntt_dif_whole") + RAGGED,
                        ("keccak256",))}
BASIC_PATHS = {
    "n": ("fib", "run"),
    "h'": (13, "run"),
    "h' lists": (13, "lists"),
    "h' arrays": (13, "arrays"),
    "h": (20, "run"),
    "k": (20, "arrays"),
}
# SHA-256 of the serialized proof of (n) under default_config() as the JAX
# package's numpy path makes it (tests/test_torch_basic.py::
# reference_basic_digest("fib", "default")), and (h)'s and (k)'s
# preprocessed and main-trace roots (::reference_basic_roots(20)).  The
# pins of the ALU loop at 2^13 ((h')) and 2^16 cycles ((k16), (j16),
# (jm16)) are the port's `parallel.dryrun.ALU_LOOP_SHA256`, which `dryrun
# --prove` checks too.
BASIC_GOLDEN = {
    "n": "5d802fc413fa21a9b8787c60064927ceafeeca2151cfc1111fe2f5d341a6247d",
}
H_ROOTS = [
    "dfc416a5150a9c2007d4b56131dbb0e8bbefea1237284931fcd604f382132751",
    "3d2555748ffa293ffaff1a4a4dce23ed2015c28c0ecf27c9444e5d49bbf311a6",
]

# the machine compositions (tests/test_compositions.py's programs), run by
# the C++ core in array mode and proved under default_config(): (machine
# class in valida_tpu_torch.machine.compositions, assembly)
COMPOSITION_PATHS = {
    "x": ("ExtendedMachine", """\
main:
    imm32 -4(fp), 0, 15, 66, 64
    feadd -12(fp), -4(fp), -4(fp)
    femul -16(fp), -12(fp), -4(fp)
    fesub -20(fp), -4(fp), -12(fp)
    write 0, -16, 0, 0, 1
    stop
"""),
    "l": ("LoadStoreMachine", """\
main:
    imm32 -4(fp), 0, 0, 0, 77
    imm32 -8(fp), 0, 0, 1, 0
    sw -8(fp), -4(fp)
    imm32 -16(fp), 0, 0, 1, 0
    loadu8 -12(fp), -16(fp)
    beq skip, -4(fp), -12(fp)
    imm32 -4(fp), 0, 0, 0, 0
skip:
    write 0, -4, 0, 0, 1
    stop
"""),
}
# SHA-256 of their serialized proofs as the JAX package's numpy path makes
# them (tests/test_torch_compositions.py::reference_composition_digest)
COMPOSITION_GOLDEN = {
    "x": "f51b54c986562c532662878612ff5a9f9116bd94c428cab096d6d244351f9eee",
    "l": "61a0e50221a25749a3fd2ea8f8b0d0be746644f3cdbaaf406192dc6687e4f9fe",
}
# path (cli): `python -m valida_tpu_torch.tooling.cli` on
# tests/programs/fibonacci.val with advice byte 25, and the SHA-256 of the
# proof file `prove` writes, as the JAX package's numpy path makes it
# (tests/test_torch_tooling.py::reference_cli_digest)
CLI_PROGRAM, CLI_ADVICE = "tests/programs/fibonacci.val", bytes([25])
CLI_GOLDEN = "8c35dd4e62ee2e7b9fccce7d6c4b46fac39a63b37ca477e20b6a1926754ca169"
# runs the CLI's main with its arguments and then prints the process's
# kernel launch counts
CLI_COUNTING = ("import json, sys; from valida_tpu_torch import _build; "
                "from valida_tpu_torch.tooling.cli import main; "
                "rc = main(sys.argv[1:]); "
                "print('launches', json.dumps(_build.LAUNCHES)); sys.exit(rc)")


def _tamper_opened_trace_value(proof):
    """A copy of a machine proof of either package with the first opened
    trace value of the first chip changed."""
    import copy

    bad = copy.deepcopy(proof)
    vals = bad.chip_proofs[0].opened_values.trace_local
    v = list(vals[0])
    v[0] = (v[0] + 1) % P
    vals[0] = tuple(v)
    return bad


def _tamper_cumulative_sum(proof):
    """A copy with the first chip's cumulative sum changed."""
    import copy

    bad = copy.deepcopy(proof)
    cs = list(bad.chip_proofs[0].cumulative_sum)
    cs[0] = (cs[0] + 1) % P
    bad.chip_proofs[0].cumulative_sum = tuple(cs)
    return bad


# the tampers of path (f) and the VerificationError subclass the JAX
# package's verifier raises for each (tests/test_torch_machine.py holds
# both packages to it at a small size)
TAMPERS = {
    "opened trace value": (_tamper_opened_trace_value,
                           "InvalidOpeningArgument"),
    "cumulative sum": (_tamper_cumulative_sum, "OodEvaluationMismatch"),
}


def _u32_words(items) -> np.ndarray:
    parts = [np.asarray(x, dtype=np.uint32).reshape(-1) for x in items]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint32)


def words_hex(words) -> str:
    """u32 words as the hex of their little-endian bytes."""
    return np.asarray(words, dtype=np.uint32).astype("<u4").tobytes().hex()


def proof_digest(opened, proof) -> dict:
    """SHA-256 of a PCS proof of either package, read by field name and
    flattened to little-endian u32 words in a fixed order: `opened` is
    every opened value (round, matrix, point, column: 5 words); `proof`
    is the commit-phase roots, the final polynomial, the proof-of-work
    witness, the direct-opened polynomials, then per query the input
    openings (opened rows, then the path) of every round and the
    commit-phase openings (pair row, then the path) of every layer."""
    fri = proof.fri
    items = list(fri.commit_phase_commits)
    items += [fri.final_poly, fri.pow_witness]
    items += list(proof.direct_polys)
    for qp in proof.query_proofs:
        for op in qp.input_openings:
            items += list(op.opened_rows) + list(op.path)
        for op in qp.fri_query.commit_phase_openings:
            items += [op.pair_row] + list(op.path)
    values = [val for rnd in opened for mat in rnd for pt in mat
              for val in pt]
    return {
        "opened": hashlib.sha256(_u32_words(values).tobytes()).hexdigest(),
        "proof": hashlib.sha256(_u32_words(items).tobytes()).hexdigest(),
    }


def pcs_matrices(shapes) -> list:
    """The committed matrices of a PCS path: default_rng(0) draws, in
    order, canonical u32 [2^log_n, cols]."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, P, size=(1 << log_n, cols), dtype=np.uint32)
            for log_n, cols in shapes]


def pcs_points(shapes) -> list:
    """Round 1 opens its first matrix at z and z*g (g generates the
    matrix's domain) and its second at z; round 2 opens at z."""
    g = pow(31, (P - 1) >> shapes[0][0], P)
    zg = tuple(c * g % P for c in PCS_Z)
    return [[[PCS_Z, zg], [PCS_Z]], [[PCS_Z]]]


def pcs_prove(pcs, challenger, mats, points):
    """Commit two rounds, observe both roots, open.  Takes the PCS and the
    challenger of either package; returns ((root, data) per round, opened
    values, proof)."""
    rounds = [pcs.commit_batches(mats[:2]), pcs.commit_batches(mats[2:])]
    for root, _ in rounds:
        challenger.observe_digest(root)
    opened, proof = pcs.open_multi_batches(
        [(data, pts) for (_, data), pts in zip(rounds, points)], challenger)
    return rounds, opened, proof


def pcs_verify(pcs, challenger, shapes, roots, points, opened, proof):
    """Replay the transcript and verify; raises the package's FriError."""
    for root in roots:
        challenger.observe_digest(root)
    dims = [[(1 << n, c) for n, c in shapes[:2]],
            [(1 << n, c) for n, c in shapes[2:]]]
    pcs.verify_multi_batches(list(zip(roots, points)), dims, opened, proof,
                             challenger)


SOURCES = {
    "poseidon2": ("valida_tpu_torch/csrc/poseidon2.cu",
                  "valida_tpu/crypto/poseidon2.py:229"),
    "ntt_dif_whole": ("valida_tpu_torch/csrc/ntt.cu",
                      "valida_tpu/poly/mxu_ntt.py:463"),
    "ntt_dif_ragged": ("valida_tpu_torch/csrc/ntt.cu",
                       "valida_tpu/poly/mxu_ntt.py:353, "
                       "valida_tpu/poly/mxu_ntt.py:397"),
    "keccak256": ("valida_tpu_torch/csrc/keccak.cu",
                  "valida_tpu/crypto/keccak.py:212"),
    # no Pallas kernel: the JAX package's u32 Montgomery code, which XLA
    # fuses inside its jitted stages
    "field_elementwise": ("valida_tpu_torch/csrc/field.cu",
                          "valida_tpu/field/babybear.py:136"),
    "field_ext_mul": ("valida_tpu_torch/csrc/field.cu",
                      "valida_tpu/field/ext.py:60"),
    "field_inv": ("valida_tpu_torch/csrc/field.cu",
                  "valida_tpu/field/babybear.py:195"),
    "field_ext_inv": ("valida_tpu_torch/csrc/field.cu",
                      "valida_tpu/field/ext.py:98"),
    # no Pallas kernel: the JAX package's quotient stage, which XLA fuses
    "constraint_eval": ("valida_tpu_torch/csrc/constraint.cu",
                        "valida_tpu/machine/jit_prover.py:1015"),
}


_T0 = time.perf_counter()


def log(*args):
    """Print a line after the seconds since the script began, so that a
    run's log shows what each path costs."""
    print(f"[{time.perf_counter() - _T0:6.1f} s]", *args, flush=True)


def trace(log_n, cols):
    rng = np.random.default_rng(0)
    t = rng.integers(0, P, size=(1 << log_n, cols), dtype=np.uint32)
    want = TRACE_SUMS[(log_n, cols)]
    got = int(t.sum(dtype=np.uint64))
    if got != want:
        raise RuntimeError(f"default_rng(0) trace {log_n}x{cols} differs "
                           f"from the one the golden root was made from")
    return t


def sweep_input(log_n, cols, device):
    """benchmarks/sweep.py's LDE input, made on `device`: Montgomery int32
    [2^log_n, cols] of x = i·747796405 + 2891336453 mod 2^32, x ^= x >> 16,
    mod p, for i the row-major word index.  Made in slices of 2^22 words,
    so that the int64 temporaries stay small."""
    import torch

    n_words = (1 << log_n) * cols
    out = torch.empty(n_words, dtype=torch.int32, device=device)
    step = 1 << 22
    for w0 in range(0, n_words, step):
        i = torch.arange(w0, min(w0 + step, n_words), dtype=torch.int64,
                         device=device)
        x = (i * 747796405 + 2891336453) & 0xFFFFFFFF
        x ^= x >> 16
        out[w0:w0 + step] = (x % P * ((1 << 32) % P) % P).to(torch.int32)
    return out.view(1 << log_n, cols)


def streamed_path(dev, run_recorded, wall_ms) -> dict:
    """Path (s): the streamed commit of benchmarks/sweep.py's input at
    STREAMED_SHAPE, blowup 1.  Each hasher's commit is counted and recorded
    by `run_recorded`, then timed (best of 3) and its device memory peak
    taken; the Keccak tree's root and every level are held to the
    monolithic commit's (coset_lde, then merkle_levels) in this call, whose
    time and peak print beside; then a tiled run at STREAMED_TILED against
    the untiled one, and the roots at 2^16 x 64 against STREAMED_GOLDEN.
    Returns each hasher's launch counts by path name."""
    import torch
    from valida_tpu_torch.commit.streamed import lde_commit_streamed
    from valida_tpu_torch.convert import to_numpy
    from valida_tpu_torch.crypto import merkle
    from valida_tpu_torch.field import babybear as bb
    from valida_tpu_torch.poly import ntt

    launches = {}

    def peak_gib(fn):
        """fn()'s device memory peak over what was held before it, GiB."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**30, \
            base / 2**30

    def monolithic(x, hasher):
        rows = bb.from_monty(ntt.coset_lde(x, 1, bb.GENERATOR,
                                           out_bitrev=True))
        root, levels = merkle.merkle_levels([rows], hasher)
        return to_numpy(root), levels

    log_n, cols = STREAMED_SHAPE
    x = sweep_input(log_n, cols, dev)
    streamed = {}
    for path, (hasher, needed, forbidden) in STREAMED_PATHS.items():
        what = f"streamed ({path}) 2^{log_n} x {cols}, blowup 1"
        (root, levels), launches[path] = run_recorded(
            what, needed, forbidden,
            lambda: lde_commit_streamed(x, 1, bb.GENERATOR, hasher))
        del levels
        times = wall_ms(lambda: lde_commit_streamed(x, 1, bb.GENERATOR,
                                                    hasher), 3)
        again, peak, base = peak_gib(
            lambda: lde_commit_streamed(x, 1, bb.GENERATOR, hasher)[0])
        if not np.array_equal(again, root):
            raise RuntimeError(f"{what}: two commits gave two roots")
        streamed[hasher] = dict(ms=min(times), peak_gib=peak)
        log(f"{what}: root {words_hex(root)}; wall-clock {min(times):.3f} "
            f"ms (best of 3; all {' '.join(f'{t:.3f}' for t in times)}); "
            f"device memory peak {peak:.3f} GiB above the {base:.3f} GiB "
            f"held before it (the input {x.numel() * 4 / 2**30:.3f} GiB)")
    what = f"streamed (s keccak) 2^{log_n} x {cols}"
    (mono_root, mono_levels), mono_peak, base = peak_gib(
        lambda: monolithic(x, "keccak"))
    times = wall_ms(lambda: monolithic(x, "keccak"), 1)
    root, levels = lde_commit_streamed(x, 1, bb.GENERATOR, "keccak")
    if not np.array_equal(root, mono_root) or sorted(levels) != sorted(
            mono_levels) or not all(torch.equal(levels[k], mono_levels[k])
                                    for k in levels):
        raise RuntimeError(f"{what}: the root or a level differs from the "
                           f"monolithic commit's")
    log(f"{what}: root and all {len(levels)} levels == the monolithic "
        f"commit's; monolithic wall-clock {times[0]:.3f} ms (one warm "
        f"run) against {streamed['keccak']['ms']:.3f}, device memory peak "
        f"{mono_peak:.3f} GiB above the {base:.3f} GiB held before it, "
        f"against the streamed {streamed['keccak']['peak_gib']:.3f} GiB")
    del x, levels, mono_levels
    (log_n, cols), col_tile, row_tile = STREAMED_TILED
    x = sweep_input(log_n, cols, dev)
    root, levels = lde_commit_streamed(x, 1, bb.GENERATOR, "keccak")
    tiled_root, tiled = lde_commit_streamed(x, 1, bb.GENERATOR, "keccak",
                                            col_tile=col_tile,
                                            row_tile=row_tile)
    if not np.array_equal(root, tiled_root) or not all(
            torch.equal(levels[k], tiled[k]) for k in levels):
        raise RuntimeError(f"streamed 2^{log_n} x {cols}: col_tile "
                           f"{col_tile}, row_tile {row_tile} differ from "
                           f"the untiled commit")
    log(f"streamed 2^{log_n} x {cols}, col_tile {col_tile}, row_tile "
        f"{row_tile}: root and levels == the untiled commit's")
    del x, levels, tiled
    x = sweep_input(16, 64, dev)
    for hasher, want in STREAMED_GOLDEN.items():
        got = words_hex(lde_commit_streamed(x, 1, bb.GENERATOR, hasher)[0])
        if got != want:
            raise RuntimeError(f"streamed 2^16 x 64 {hasher}: root {got}, "
                               f"the JAX package's {want}")
    log(f"streamed 2^16 x 64: keccak and poseidon2 roots == JAX package's")
    del x
    torch.cuda.empty_cache()
    return launches


def dist_path(dev, run_recorded, cuda_ms, rand_field) -> dict:
    """Path (p): the distributed primitives of valida_tpu_torch.parallel on
    a one-rank NCCL process group on this card (the machine has one):
    dist_dif forward and inverse at DIST_DIF_SHAPES, dist_coset_lde at the
    first of them, sharded_prove_fn at DIST_PROVE_SHAPE and the dry run,
    counted and recorded by `run_recorded`; each result held to the
    single-card function's on the same inputs (computed before, outside the
    counted run: ntt.dif, ntt.coset_lde, commit_forward per trace and one
    cumulative sum mod p), then dist_dif and dist_coset_lde timed beside
    them.  Returns the path's launch counts."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as tdist
    from valida_tpu_torch.commit.lde_commit import commit_forward
    from valida_tpu_torch.field import babybear as bb
    from valida_tpu_torch.parallel import dist_ntt, mesh as pmesh
    from valida_tpu_torch.parallel.dryrun import dryrun_multichip
    from valida_tpu_torch.poly import ntt

    def composed(traces, q, counts):
        """(roots, φ's last row) on one card, without the mesh."""
        roots = torch.stack([commit_forward(t, device=dev) for t in traces])
        terms = (q.long() * counts.long()[..., None] % P
                 * pow(1 << 32, P - 2, P) % P)
        phi = terms.sum(dim=2).cumsum(dim=1) % P
        return roots, phi[:, -1].to(torch.int32)

    xs = {shape: rand_field((1 << shape[0], shape[1]))
          for shape in DIST_DIF_SHAPES}
    want = {(shape, inv): ntt.dif(x, inv)
            for shape, x in xs.items() for inv in (False, True)}
    lde_in = xs[DIST_DIF_SHAPES[0]]
    want["lde"] = ntt.coset_lde(lde_in, 1, bb.GENERATOR, out_bitrev=True)
    b, log_n, c, k = DIST_PROVE_SHAPE
    prove_in = (rand_field((b, 1 << log_n, c)),
                rand_field((b, 1 << log_n, k, 5)),
                torch.randint(0, 3, (b, 1 << log_n, k), dtype=torch.int32,
                              device=dev))
    want["prove"] = composed(*prove_in)
    rng = np.random.default_rng(0)  # the dry run's inputs at one rank
    want["dryrun"] = composed(*(
        torch.from_numpy(a.view(np.int32)).to(dev) for a in (
            rng.integers(0, P, size=(1, 64, 8), dtype=np.uint32),
            rng.integers(0, P, size=(1, 64, 2, 5), dtype=np.uint32),
            rng.integers(0, 2, size=(1, 64, 2), dtype=np.uint32))))

    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300),
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = pmesh.make_mesh(1)

            def run():
                out = {key: dist_ntt.dist_dif(xs[key[0]], mesh, "sp", key[1])
                       for key in want if isinstance(key, tuple)}
                out["lde"] = dist_ntt.dist_coset_lde(lde_in, mesh, 1,
                                                     bb.GENERATOR)
                out["prove"] = pmesh.sharded_prove_fn(mesh)(*prove_in)
                out["dryrun"] = tuple(
                    torch.from_numpy(a.view(np.int32)).to(dev)
                    for a in dryrun_multichip(1, "cuda"))
                return out

            what = "distributed (p), one NCCL rank"
            got, counts = run_recorded(what, *DIST_KERNELS, run)
            for key, w in want.items():
                pairs = zip(got[key], w) if key in ("prove", "dryrun") else [
                    (got[key], w)]
                if not all(torch.equal(g, e) for g, e in pairs):
                    raise RuntimeError(f"{what}: {key} differs from the "
                                       f"single-card result")
            log(f"{what}: dist_dif (forward and inverse at "
                + ", ".join(f"2^{n} x {cols}" for n, cols in DIST_DIF_SHAPES)
                + f"), dist_coset_lde, sharded_prove_fn at B={b}, N=2^{log_n}"
                f", C={c}, K={k} and dryrun_multichip(1) == the single-card "
                f"functions' words")
            for (shape, inv) in [key for key in want if isinstance(key,
                                                                   tuple)]:
                x = xs[shape]
                t_dist = cuda_ms(
                    lambda: dist_ntt.dist_dif(x, mesh, "sp", inv), 10)
                t_dif = cuda_ms(lambda: ntt.dif(x, inv), 10)
                log(f"{what}: dist_dif 2^{shape[0]} x {shape[1]} "
                    f"{'inverse' if inv else 'forward'} {t_dist:.4f} ms, "
                    f"ntt.dif {t_dif:.4f} ms ({t_dist / t_dif:.2f}x)")
            t_dist = cuda_ms(lambda: dist_ntt.dist_coset_lde(
                lde_in, mesh, 1, bb.GENERATOR), 10)
            t_lde = cuda_ms(lambda: ntt.coset_lde(lde_in, 1, bb.GENERATOR,
                                                  out_bitrev=True), 10)
            log(f"{what}: dist_coset_lde 2^{DIST_DIF_SHAPES[0][0]} x "
                f"{DIST_DIF_SHAPES[0][1]} blowup 1 {t_dist:.4f} ms, "
                f"ntt.coset_lde {t_lde:.4f} ms ({t_dist / t_lde:.2f}x)")
        finally:
            tdist.destroy_process_group()
    log("distributed (p): more than one rank is held only by the CPU tests "
        "on gloo (tests/test_torch_dist.py, 2, 4 and 8 ranks); a timing "
        "across cards waits for a machine with four")
    return counts


# (field): the words where the arithmetic turns, as u32 bit patterns:
# 0, 1, 2, p - 2, p - 1, p, p + 1, 2p - 1, 2p, 2^31 - 1, 2^31 (the first
# negative int32), 2^31 + 1, R (one in Montgomery form), 0x77FFFFFF,
# 2^32 - 2, 2^32 - 1
FIELD_EDGE = [0, 1, 2, P - 2, P - 1, P, P + 1, 2 * P - 1, 2 * P,
              (1 << 31) - 1, 1 << 31, (1 << 31) + 1, 268435454, 0x77FFFFFF,
              (1 << 32) - 2, (1 << 32) - 1]


def field_phase(dev, check) -> None:
    """(field): each field kernel of csrc/field.cu held against its plain
    version on the card, word for word (`check(name, got, want, what)`
    raises on a difference): field_elementwise's every op code, then
    field_ext_mul, field_inv and field_ext_inv, on random words from a
    numpy seed at 2^20 and 2^21 elements (below p, and any u32 bit
    pattern), on every pair of FIELD_EDGE words, and on the broadcast
    patterns of the prover's calls."""
    import torch
    from valida_tpu_torch.field import babybear as bb
    from valida_tpu_torch.field import ext as extf

    rng = np.random.default_rng(2)

    def words(shape, top=1 << 32):
        return torch.from_numpy(rng.integers(0, top, shape, dtype=np.uint32)
                                .view(np.int32)).to(dev)

    binary = {name: (getattr(bb, name), getattr(bb, f"{name}_plain"))
              for name in ("mul", "add", "sub")}
    unary = {name: (getattr(bb, name), getattr(bb, f"{name}_plain"))
             for name in ("neg", "double", "to_monty", "from_monty",
                          "from_wrapped_u32")}
    edge = torch.from_numpy(np.array(FIELD_EDGE, dtype=np.uint32)
                            .view(np.int32)).to(dev)
    n_e = edge.numel()
    pairs = (edge.repeat_interleave(n_e), edge.repeat(n_e))
    k, q = 51, 1 << 15
    cases = {  # what -> (a, b)
        "edge word pairs": pairs,
        "2^20 words below p": (words(1 << 20, P), words(1 << 20, P)),
        "2^21 words below p": (words(1 << 21, P), words(1 << 21, P)),
        "2^21 u32 words": (words(1 << 21), words(1 << 21)),
        "[K, Q] x [K, 1] (air/builder.py)": (words((k, q), P),
                                             words((k, 1), P)),
        "[n, 1] x [1, 5] (air/lookup.py)": (words((1 << 20, 1), P),
                                            words((1, 5), P)),
        "0-d tensor": (words((), P), words((1 << 20, 3), P)),
        "scalar word": (words((1 << 20, 5), P), 123456789),
        "strided view": (words((1 << 12, 256), P)[1::2, ::3],
                         words((1 << 11, 86), P)),
        "a column": (words((1 << 20, 4), P)[:, 2], words(1 << 20, P)),
        "transposed": (words((512, 2048), P).t(), words((2048, 512), P)),
        "empty": (words((0, 5)), words((0, 5))),
    }
    for what, (a, b) in cases.items():
        for name, (fn, plain) in binary.items():
            check("field_elementwise", fn(a, b), plain(a, b),
                  f"{name}, {what}")
        for name, (fn, plain) in unary.items():
            check("field_elementwise", fn(a), plain(a), f"{name}, {what}")
    log("field_elementwise == plain for mul, add, sub, neg, double, "
        "to_monty, from_monty, from_wrapped_u32 on: " + "; ".join(cases))

    def ext(shape, top=P):
        return words(tuple(shape) + (5,), top)

    e_pairs = (pairs[0][:, None].expand(-1, 5).contiguous(),
               pairs[1][:, None].expand(-1, 5).contiguous())
    e_cases = {
        "edge words in every coefficient": e_pairs,
        "2^20 elements below p": (ext([1 << 20]), ext([1 << 20])),
        "2^21 elements below p": (ext([1 << 21]), ext([1 << 21])),
        "2^21 elements of u32 words": (ext([1 << 21], 1 << 32),
                                       ext([1 << 21], 1 << 32)),
        "[n, 5] x [5]": (ext([1 << 20]), ext([])),
        "[n, 1, 5] x [1, m, 5]": (ext([1 << 10, 1]), ext([1, 1 << 10])),
        "strided view": (ext([1 << 20, 2])[:, 1], ext([1 << 20])),
        "empty": (ext([0]), ext([0])),
    }
    for what, (a, b) in e_cases.items():
        check("field_ext_mul", extf.ext_mul(a, b), extf.ext_mul_plain(a, b),
              what)
        check("field_ext_inv", extf.ext_inv(a), extf.ext_inv_plain(a), what)
        check("field_inv", bb.inv(a[..., 1]), bb.inv_plain(a[..., 1]), what)
    zeros = torch.zeros(1 << 10, 5, dtype=torch.int32, device=dev)
    check("field_ext_inv", extf.ext_inv(zeros), zeros, "zero elements")
    check("field_inv", bb.inv(zeros), zeros, "zero words")
    x = words(1 << 21, P)
    check("field_inv", bb.inv_batch(x), bb.inv_batch_plain(x),
          "inv_batch, 2^21 words below p")
    log("field_ext_mul, field_ext_inv, field_inv == plain on: "
        + "; ".join(e_cases) + "; zeros; inv_batch == its product tree")


# 32-bit instructions of one row of a chip's constraint program, as
# (multiplies, all), counted as the row interpreter (csrc/constraint.cuh)
# computes each instruction form on canonical operands, and as few as sm_90
# needs: a base add or sub is 3 (add or subtract; compare and select, or a
# fused add-minimum), a neg 3; a Montgomery product 3 multiplies and 2
# others.  An operation on an extension operand does this on each of the 5
# coefficients that change: ext + base and ext - base only coefficient 0,
# base - ext all 5 (4 negated).  An extension product is field_ext_mul's
# count without its 10 canon: 35 multiplies (25 wide products as
# multiply-adds, 5 reductions of 2) and 40 others (5 doublings, 10 folds,
# 5 corrections, 2 each).  ACC adds a constraint times its power of alpha
# to 64-bit accumulators: each wide product a multiply-add and a fold (2),
# 25 of them and 5 doublings for an extension constraint, 5 for a base one
# (1 times a base one).  Each row also takes each column word it reads mod
# p once (`canon`, 3), and ends in 5 reductions (2 multiplies, 2 others)
# and 5 products by 1/Z_H.  The uniform program runs once per block of
# rows and is left out.  The least time is the larger of the multiplies
# alone and half of all instructions, as for a butterfly.
CONSTRAINT_FORM_OPS = {
    ("add", False, False): (0, 3), ("sub", False, False): (0, 3),
    ("neg", False): (0, 3),
    ("add", True, False): (0, 3), ("add", False, True): (0, 3),
    ("add", True, True): (0, 15), ("sub", True, False): (0, 3),
    ("sub", False, True): (0, 15), ("sub", True, True): (0, 15),
    ("neg", True): (0, 15),
    ("mul", False, False): (3, 5), ("mul", True, False): (15, 25),
    ("mul", False, True): (15, 25), ("mul", True, True): (35, 75),
    ("acc", False, False): (1, 3), ("acc", True, False): (5, 15),
    ("acc", False, True): (5, 15), ("acc", True, True): (25, 85),
}
CONSTRAINT_ROW_END_OPS = (5 * 2 + 5 * 3, 5 * 4 + 5 * 5)


def constraint_slots(prog) -> float:
    """Issue slots of one row of a chip's constraint program
    (air/program.py `Program`): its instruction forms (`forms`) by
    CONSTRAINT_FORM_OPS, a canon for each column word its row program
    reads, and the row's end (CONSTRAINT_ROW_END_OPS)."""
    from valida_tpu_torch.air import program

    muls, ops = CONSTRAINT_ROW_END_OPS
    for form, n in prog.forms.items():
        m, a = CONSTRAINT_FORM_OPS[form]
        muls, ops = muls + n * m, ops + n * a
    words = {program.K_MAIN_L: 1, program.K_MAIN_N: 1, program.K_PREP_L: 1,
             program.K_PREP_N: 1, program.K_PERM_L: 5, program.K_PERM_N: 5}
    read = set()  # the column operands (kind, index) of the row program
    for c, _dst, a, b in prog.code[prog.n_uniform:].tolist():
        operands = [((c >> 8) & 15, a)]
        if c & 15 != program.OP_NEG:
            operands.append(((c >> 12) & 15, b))
        read.update(o for o in operands if o[0] in words)
    ops += CANON_OPS * sum(words[kind] for kind, _ in read)
    return max(muls, ops / 2)


def quot_phase(dev, check, machine, degrees, cfg, rand_field, cuda_ms,
               int32_ops_per_s) -> dict:
    """(quot): the quotient kernel of csrc/constraint.cu held against
    `quotient_rows_plain` on the card, word for word (`check` raises on a
    difference), for every chip of `machine` (the ALU loop at 2^20 cycles)
    at its log-degree in `degrees`, on random LDE words (words 0, 1 and
    p - 1 among them): in the bit-reversed form the staged prover reads in
    place and the natural form with a stride the eager prover reads; for
    cpu and mem also a mesh rank's form (a block of half the domain from
    row0 = Q/2 and its 2^qd halo rows).  Then each chip's kernel in the
    bit-reversed form, (j)'s, timed beside its plain version and its bound:
    bytes, each LDE row read once, the selectors and the output; issue
    slots, `constraint_slots` of its program.  Returns the numbers by
    chip."""
    import torch
    from valida_tpu_torch.air import program, quotient

    log_blowup, shift = cfg.pcs.log_blowup, cfg.pcs.coset_shift()

    def lde(rows, cols):
        if not cols:
            return None
        x = rand_field((rows, cols))
        flat = x.view(-1)
        for step, word in ((89, 0), (97, 1), (101, P - 1)):
            flat[::step] = word
        return x

    numbers = {}
    for chip in machine.chips():
        ld = degrees[chip.name]
        qd = quotient.get_log_quotient_degree(machine, chip)
        prog = program.chip_program(machine, chip, ld)
        w, pw, n_perm = prog.widths
        length, stride = 1 << (ld + log_blowup), 1 << (log_blowup - qd)
        q = length // stride
        bufs = [lde(length, pw), lde(length, w), lde(length, 5 * n_perm)]
        ch, al, cs = rand_field((3, 5)), rand_field((5,)), rand_field((5,))
        args = (machine, chip, ld, qd, *bufs, cs, ch, al, shift)
        forms = {"bit-reversed": dict(stride=stride, bitrev=True),
                 "natural": dict(stride=stride)}
        for form, kw in forms.items():
            check("constraint_eval", quotient.quotient_rows(*args, **kw),
                  quotient.quotient_rows_plain(*args, **kw),
                  f"{chip.name} 2^{ld} rows, {form}")
        if chip.name in ("cpu", "mem"):
            rows = q // 2
            halo = [lde(rows + (1 << qd), c) for c in (pw, w, 5 * n_perm)]
            hargs = (machine, chip, ld, qd, *halo, cs, ch, al, shift, q // 2)
            check("constraint_eval", quotient.quotient_rows(*hargs, rows=rows),
                  quotient.quotient_rows_plain(*hargs, rows=rows),
                  f"{chip.name} a mesh rank's block and halo")
            del halo
        kw = forms["bit-reversed"]
        ms = cuda_ms(lambda: quotient.quotient_rows(*args, **kw), 5)
        plain_ms = cuda_ms(lambda: quotient.quotient_rows_plain(*args, **kw),
                           1)
        nbytes = q * (w + pw + 5 * n_perm + 3 + 5) * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = q * constraint_slots(prog) / int32_ops_per_s * 1e3
        numbers[chip.name] = dict(
            rows=q, widths=(w, pw, n_perm), instructions=prog.n_row,
            uniform=prog.n_uniform, slot_words=prog.slot_words, ms=ms,
            plain_ms=plain_ms, t_bytes=t_bytes, t_ops=t_ops)
        log(f"(quot) {chip.name}: 2^{ld} rows, Q = {q}, widths {w}+{pw}+"
            f"{n_perm}x5, {prog.n_row} row / {prog.n_uniform} uniform "
            f"instructions, {prog.slot_words} slot words: == plain "
            f"({', '.join(forms)}"
            + (", block and halo" if chip.name in ("cpu", "mem") else "")
            + f"); {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms ("
            + ("bytes" if t_bytes >= t_ops else "operations")
            + f"; bytes {t_bytes:.4f}, operations {t_ops:.4f})")
        del bufs, args
    return numbers


def run_cli(log) -> dict:
    """Path (cli): `python -m valida_tpu_torch.tooling.cli` asm, run,
    prove and verify of CLI_PROGRAM with CLI_ADVICE, each action in a
    process of its own on the card, and `prove --jit` (one prove_jit, whose
    every stage captures) timed beside `prove`.  Checks the output tape,
    each proof file's SHA-256 against CLI_GOLDEN, verify's exit 0 and a
    flipped byte's exit 1.  Returns the prove process's kernel launch
    counts."""
    import tempfile

    cli = [sys.executable, "-m", "valida_tpu_torch.tooling.cli"]

    seconds = {}

    def call(args, expect, command=cli):
        t0 = time.perf_counter()
        proc = subprocess.run(command + args, cwd=ROOT, capture_output=True,
                              text=True)
        if proc.returncode != expect:
            raise RuntimeError(f"cli {args[0]}: exit {proc.returncode}, "
                               f"expected {expect}:\n{proc.stdout}"
                               f"{proc.stderr}")
        label = " ".join(os.path.basename(a) for a in args)
        seconds[label] = time.perf_counter() - t0
        log(f"cli {label}: exit {proc.returncode} in {seconds[label]:.3f} s")
        return proc.stdout

    with tempfile.TemporaryDirectory() as d:
        prog, tape, advice, proof, proof_jit, bad = (
            os.path.join(d, f) for f in ("prog.bin", "out.tape",
                                         "advice.bin", "proof.cbor",
                                         "proof_jit.cbor", "bad.cbor"))
        with open(advice, "wb") as f:
            f.write(CLI_ADVICE)
        call(["asm", CLI_PROGRAM, prog], 0)
        call(["run", prog, tape, advice], 0)
        with open(tape, "rb") as f:
            result = int.from_bytes(f.read(), "little")
        if result != 75025:
            raise RuntimeError(f"cli run: output tape {result}, expected "
                               f"fib(25) = 75025")
        out = call(["prove", prog, proof, advice], 0,
                   [sys.executable, "-c", CLI_COUNTING])
        counts = json.loads(next(line for line in out.splitlines()
                                 if line.startswith("launches "))[9:])
        log(f"cli prove launches: {counts}")
        missing = [k for k in BASIC_KERNELS[0] if counts[k] == 0]
        extra = [k for k in BASIC_KERNELS[1] if counts[k] != 0]
        if missing or extra:
            raise RuntimeError(f"cli prove launched none of {missing} or "
                               f"{extra}, which it must not")
        with open(proof, "rb") as f:
            blob = f.read()
        digest = hashlib.sha256(blob).hexdigest()
        if digest != CLI_GOLDEN:
            raise RuntimeError(f"cli prove: the proof file's sha256 is "
                               f"{digest}, the JAX package's {CLI_GOLDEN}")
        log(f"cli prove: {len(blob)} bytes, sha256 == JAX package's")
        out = call(["prove", prog, proof_jit, advice, "--jit"], 0,
                   [sys.executable, "-c", CLI_COUNTING])
        log("cli prove --jit launches: " + next(
            line for line in out.splitlines() if line.startswith("launches ")))
        with open(proof_jit, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != CLI_GOLDEN:
            raise RuntimeError(f"cli prove --jit: the proof file's sha256 is "
                               f"{digest}, the JAX package's {CLI_GOLDEN}")
        log(f"cli prove --jit: sha256 == JAX package's; the process took "
            f"{seconds['prove prog.bin proof_jit.cbor advice.bin --jit']:.3f}"
            f" s against prove's "
            f"{seconds['prove prog.bin proof.cbor advice.bin']:.3f} s")
        call(["verify", prog, proof], 0)
        flipped = bytearray(blob)
        flipped[-20] ^= 1  # a late byte: an opened value
        with open(bad, "wb") as f:
            f.write(flipped)
        call(["verify", prog, bad], 1)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from valida_tpu_torch import _build, utils
    from valida_tpu_torch.air import quotient
    from valida_tpu_torch.commit.fri import FriConfig, FriError
    from valida_tpu_torch.commit.lde_commit import commit_forward
    from valida_tpu_torch.commit.pcs import TwoAdicFriPcs
    from valida_tpu_torch.convert import table, to_int32_bits, to_numpy
    from valida_tpu_torch.crypto import keccak, merkle
    from valida_tpu_torch.crypto import poseidon2 as p2
    from valida_tpu_torch.field import babybear as bb
    from valida_tpu_torch.field import ext as extf
    from valida_tpu_torch.core.config import default_config
    from valida_tpu_torch.crypto.challenger import DuplexChallenger
    from valida_tpu_torch.chips.alu import _ops_to_arrays
    from valida_tpu_torch.core.program import ProgramROM
    from valida_tpu_torch.core import opcodes as OC
    from valida_tpu_torch.machine import compositions, examples, jit_prover
    from valida_tpu_torch.machine.basic import BasicMachine
    from valida_tpu_torch.machine.verifier import VerificationError
    from valida_tpu_torch.native import ALU_LOGS
    from valida_tpu_torch.native import build as native_build
    from valida_tpu_torch.parallel.dryrun import (ALU_LOOP_SHA256,
                                                  alu_loop_machine)
    from valida_tpu_torch.tooling.assembler import assemble
    from valida_tpu_torch.poly import ntt, radix_ntt
    from valida_tpu_torch.tooling.serde import (deserialize_proof,
                                                serialize_proof)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand_field(shape):
        return torch.randint(0, P, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    def rand_words(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    def err(got, want):
        diff = (got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64)
                                                      & 0xFFFFFFFF)
        return int(diff.abs().max()) if diff.numel() else 0

    def cuda_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def wall_ms(fn, runs):
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_ops_per_s = INT32_OPS_PER_CLOCK_PER_SM * sms * int(clock) * 1e6
    log(f"int32 peak {int32_ops_per_s:.6g} op/s ({sms} SMs at {clock} MHz)")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}: {sorted(logs)} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line:
                log(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    log(f"build: the native interpreter core {native_build.build().name} in "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. every kernel against its plain version, on the card
    max_err = dict.fromkeys(SOURCES, 0)

    def check(name, got, want, what):
        e = err(got, want)
        max_err[name] = max(max_err[name], e)
        if e != 0:
            raise RuntimeError(f"{name} differs from its plain version at "
                               f"{what}: max |diff| = {e}")

    # the two pass kernels against their one plain version: the smallest
    # sizes, uneven splits, the main path's sizes, three passes, the widest
    # rows; then three passes with an uneven split at a cheaper size; then
    # constant arrays of 0 and p - 1, the ends of the range a butterfly's
    # unreduced difference spans
    def passes_plain(x, log_n, inv, t_max):
        # columns are independent: slices keep the plain version's int64
        # temporaries small at the largest size
        return torch.cat([radix_ntt.dif_passes_plain(c.contiguous(), log_n,
                                                     inv, t_max)
                          for c in x.split(16 if log_n > 21 else x.shape[1],
                                           dim=1)], dim=1)

    def check_passes(name, fn, shapes, fills):
        for log_n, cols, t_max in shapes:
            for inv in (False, True):
                x = rand_field((1 << log_n, cols))
                if log_n == 14:  # between the random rows: p - 1, 0x77FFFFFF
                    x[::2] = P - 1
                    x[1::3] = 0x77FFFFFF
                check(name, fn(x, log_n, inv, t_max),
                      passes_plain(x, log_n, inv, t_max),
                      f"({log_n}, {cols}, inverse={inv}, t_max={t_max})")
                del x
        for log_n, cols in fills:
            for inv in (False, True):
                for fill in (0, P - 1):
                    x = torch.full((1 << log_n, cols), fill,
                                   dtype=torch.int32, device=dev)
                    check(name, fn(x, log_n, inv, 11),
                          radix_ntt.dif_passes_plain(x, log_n, inv),
                          f"({log_n}, {cols}, inverse={inv}) of all {fill}")
        log(f"{name} == plain at (log_n, cols: levels of the passes) "
            + " ".join(
                f"({a},{b}:"
                f"{'+'.join(str(t) for t in radix_ntt._pass_levels(a, c))})"
                for a, b, c in shapes)
            + ", fwd+inv, rows of p-1 and 0x77FFFFFF at log_n 14; and on "
              "arrays of all 0 and all p-1 at "
            + " ".join(f"({a},{b})" for a, b in fills) + ", fwd+inv")

    check_passes("ntt_dif_whole", radix_ntt.dif_whole,
                 [(7, 128, 11), (10, 128, 11), (13, 128, 11), (14, 128, 11),
                  (15, 128, 11), (15, 256, 11), (20, 128, 11), (21, 128, 11),
                  (23, 128, 11), (14, 256, 11), (14, 2048, 11),
                  (14, 4096, 11), (20, 128, 8), (16, 384, 6)],
                 [(14, 128), (15, 128), (20, 128)])
    # ntt_dif_ragged: the paths' widths at the ends of their sizes (2^12 and
    # 2^13 x 32; 2^13 to 2^20 x 51; 2^16 to 2^20 x 10; step 4 holds every
    # call of the paths), odd widths from 1 to 200 columns, and three uneven
    # passes
    check_passes("ntt_dif_ragged", radix_ntt.dif_ragged,
                 [(8, 51, 11), (12, 32, 11), (13, 32, 11), (15, 79, 11),
                  (17, 51, 11), (20, 51, 11), (20, 10, 11), (21, 51, 11),
                  (14, 1, 11), (14, 3, 11), (14, 10, 11), (14, 127, 11),
                  (14, 129, 11), (14, 200, 11), (20, 51, 8), (16, 79, 6)],
                 [(14, 51), (20, 51), (20, 10)])
    splits = []
    for log_n, cols in [(12, 32), (16, 51), (19, 51), (20, 51), (20, 10)]:
        levels = radix_ntt._pass_levels(
            log_n, radix_ntt._ragged_t_max(log_n, cols))
        groups = radix_ntt._column_groups(cols, levels[0])
        splits.append(f"2^{log_n} x {cols}: levels "
                      f"{'+'.join(map(str, levels))}, column groups "
                      f"{'+'.join(str(w) for _, w in groups)}")
    log("ntt_dif_ragged on the paths (first pass's groups): "
        + "; ".join(splits))

    for n_words in [1, 8, 16, 32, 33, 34, 35, 51, 68, 128]:
        for batch in [1, 3, 2047, 1 << 16]:
            w = rand_words((batch, n_words))
            check("keccak256", keccak.keccak256_words(w),
                  keccak.keccak256_words_plain(w), f"({batch}, {n_words})")
    log("keccak256 == plain at n_words {1..128} x batch {1,3,2047,2^16}")

    # words at and around the multiples of p that a u32 can hold
    edge = to_int32_bits(torch.tensor(
        [0, P - 1, P, 2 * P - 1, 2 * P, 0xFFFFFFFF], dtype=torch.int64,
        device=dev))
    for n_words in [1, 7, 8, 9, 10, 16, 51, 128, 179]:
        for batch in [1, 3, 127, 128, 129, 2047, 1 << 16]:
            w = rand_words((batch, n_words))
            flat = w.view(-1)
            k = min(flat.numel(), 3 * edge.numel())
            flat[:k] = edge.repeat(3)[:k]
            flat[-k:] = edge.repeat(3)[:k]
            check("poseidon2", p2.hash_words(w), p2.hash_words_plain(w),
                  f"({batch}, {n_words})")
    log("poseidon2 == plain at n_words {1,7,8,9,10,16,51,128,179} x batch "
        "{1,3,127,128,129,2047,2^16}, with words 0, p-1, p, 2p-1, 2p, 2^32-1")

    # (field): the field kernels against their plain versions, word for
    # word, on words from a numpy seed
    t0 = time.perf_counter()
    field_phase(dev, check)
    log(f"(field) took {time.perf_counter() - t0:.1f} s")

    # 4. the main path: three commits, the launch counters around each.
    # Every kernel call is recorded (its input, and its output as the kernel
    # left it) and held against the plain version on the same input as it
    # returns.  A launch being captured into a CUDA graph is not: it runs
    # at the graph's replays, and the staged prover's eager first run of
    # the same stage was recorded.
    # the C entries' arguments after (input, output), to the plain version
    plain_of = {
        "ntt_dif_whole": lambda x, pw, log_n, rest_n, t_max:
            passes_plain(x, log_n, pw.equal(table(
                ntt._root_powers, log_n, True, device=dev)), t_max),
        "ntt_dif_ragged": lambda x, pw, log_n, rest_n, t_max:
            passes_plain(x, log_n, pw.equal(table(
                ntt._root_powers, log_n, True, device=dev)), t_max),
        "keccak256": lambda w, batch, n_words:
            keccak.keccak256_words_plain(w),
        "poseidon2": lambda w, batch, n_words: p2.hash_words_plain(w),
    }
    calls = []  # (kernel, input shape) of each call held against plain
    # kernel runs on the device of the launches made outside a capture (an
    # NTT call runs one a pass), reset by run_recorded
    device_runs = dict.fromkeys(SOURCES, 0)
    recording = [""]  # the path being recorded
    small_seen, passed_over = {}, {}
    launch = _build.launch
    # a proof makes some 230 hash calls, most of them on a few rows: all
    # calls on more than SMALL_HASH rows are recorded, and every eighth of
    # the rest (the first, the ninth, ...)
    SMALL_HASH = 1 << 12
    sample_small = [False]
    field_seen = {}
    # the field kernels' plain versions, by field_elementwise's op code
    # (csrc/field.cuh `Op`) or by kernel
    field_plain = {
        **{code: getattr(bb, f"{op}_plain") for op, code in bb.OPS.items()},
        "field_ext_mul": extf.ext_mul_plain, "field_inv": bb.inv_plain,
        "field_ext_inv": extf.ext_inv_plain}

    def held_field(name, args):
        """A field kernel's output against its plain version on the same
        operands (the launch's arguments after the entry's name), in row
        blocks of at most 2^24 words: max |diff|, and the output."""
        if name == "field_elementwise":
            op, a, b, a_word, b_word, out = args[:6]
            fn = field_plain[op]
            ops = [a_word if a is None else a]
            if op < bb.OPS["neg"]:  # the binary ops
                ops.append(b_word if b is None else b)
        else:
            out, fn, ops = args[-2], field_plain[name], list(args[:-2])
        if out.dim() == 0 or out.numel() <= 1 << 24:
            return err(out, fn(*ops)), out
        ops = [x.expand(out.shape) if isinstance(x, torch.Tensor) else x
               for x in ops]
        rows = max(1, (1 << 24) // (out.numel() // out.shape[0]))
        return max(err(out[i:i + rows], fn(*[
            x[i:i + rows] if isinstance(x, torch.Tensor) else x
            for x in ops])) for i in range(0, out.shape[0], rows)), out

    def recording_launch(lib_name, fn, *args):
        if torch.cuda.is_current_stream_capturing():
            # a launch being captured into a graph runs at the graph's
            # replays: the stage's eager first run was recorded instead
            launch(lib_name, fn, *args)
            return
        name = fn.removesuffix("_launch")
        if lib_name == "constraint":
            # held against its plain version where its wrapper returns
            # (held_quotient), which knows the machine and the chip
            device_runs[name] += 1
            launch(lib_name, fn, *args)
            return
        if lib_name == "field":
            # every FIELD_SAMPLE-th call of each field kernel is held
            device_runs[name] += 1
            launch(lib_name, fn, *args)
            seen = field_seen[name] = field_seen.get(name, 0) + 1
            if seen % FIELD_SAMPLE != 1:
                passed_over[name] = passed_over.get(name, 0) + 1
                return
            e, out = held_field(name, args)
            max_err[name] = max(max_err[name], e)
            if e != 0:
                raise RuntimeError(f"{name} differs from its plain version "
                                   f"at {recording[0]} output "
                                   f"{tuple(out.shape)}: max |diff| = {e}")
            calls.append((name, tuple(out.shape)))
            return
        x, y, *rest = args
        device_runs[name] += (len(radix_ntt._pass_levels(rest[1], rest[3]))
                              if name.startswith("ntt") else 1)
        if (sample_small[0] and name in ("poseidon2", "keccak256")
                and x.shape[0] <= SMALL_HASH):
            seen = small_seen[name] = small_seen.get(name, 0) + 1
            if seen % 8 != 1:
                passed_over[name] = passed_over.get(name, 0) + 1
                launch(lib_name, fn, x, y, *rest)
                return
        x_in = x.clone()
        launch(lib_name, fn, x, y, *rest)
        # held at once, so that no recorded tensor outlives its call
        check(name, y, plain_of[name](x_in, *rest),
              f"{recording[0]} input {tuple(x_in.shape)}")
        calls.append((name, tuple(x_in.shape)))

    kernel_branch = quotient._quotient_rows_kernel

    def held_quotient(*args):
        """A quotient kernel call (`_quotient_rows_kernel`), held word for
        word against `quotient_rows_plain` on the same inputs as it
        returns (the plain version launches none of our kernels: it
        computes with the `*_plain` field functions)."""
        out = kernel_branch(*args)
        if torch.cuda.is_current_stream_capturing():
            return out
        (machine, chip, log_degree, qd, prep, main, perm, cs, ch, alpha,
         shift, row0, rows, stride, bitrev) = args
        want = quotient.quotient_rows_plain(
            machine, chip, log_degree, qd, prep, main, perm, cs, ch, alpha,
            shift, row0, rows=rows, stride=stride, bitrev=bitrev)
        e = err(out, want)
        max_err["constraint_eval"] = max(max_err["constraint_eval"], e)
        if e != 0:
            raise RuntimeError(f"constraint_eval differs from its plain "
                               f"version at {recording[0]} chip {chip.name} "
                               f"output {tuple(out.shape)}: max |diff| = {e}")
        calls.append(("constraint_eval", tuple(out.shape)))
        return out

    # the launches and kernel runs made building the quotient's selector
    # tables, once per shape and not in a stage's graph: a warm prove
    # repeats none of them, so its comparisons with eager first runs leave
    # them out (reset with the counters)
    table_setup = {"launches": dict.fromkeys(device_runs, 0),
                   "runs": dict.fromkeys(device_runs, 0)}
    build_tables = quotient.selector_tables

    def counted_tables(*args):
        launched, ran = dict(_build.LAUNCHES), dict(device_runs)
        out = build_tables(*args)
        for k in device_runs:
            table_setup["launches"][k] += _build.LAUNCHES[k] - launched[k]
            table_setup["runs"][k] += device_runs[k] - ran[k]
        return out

    def run_recorded(what, needed, forbidden, fn, sample=False):
        """Run fn() with the launch counters at 0 and every kernel call
        recorded and held against the plain version as it returns;
        require the path's kernels to have launched and the forbidden ones
        not to.  Returns (fn's result, the counters)."""
        recording[0] = what
        calls.clear()
        small_seen.clear()
        field_seen.clear()
        passed_over.clear()
        sample_small[0] = sample
        torch.cuda.synchronize()
        _build.reset_launches()
        for k in device_runs:
            device_runs[k] = 0
            table_setup["launches"][k] = table_setup["runs"][k] = 0
        _build.launch = recording_launch
        quotient._quotient_rows_kernel = held_quotient
        quotient.selector_tables = counted_tables
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            _build.launch = launch
            quotient._quotient_rows_kernel = kernel_branch
            quotient.selector_tables = build_tables
        counts = dict(_build.LAUNCHES)
        replayed = dict(_build.GRAPH_LAUNCHES)
        log(f"{what} launches: {counts}"
            + (f", of which by CUDA graph replays {replayed}"
               if any(replayed.values()) else ""))
        missing = [k for k in needed if counts[k] == 0]
        if missing:
            raise RuntimeError(f"{what} launched none of {missing}")
        extra = [k for k in forbidden if counts[k] != 0]
        if extra:
            raise RuntimeError(f"{what} must not launch {extra}")
        seen = {}
        for name, shape in calls:
            seen.setdefault(name, []).append(shape)
        held = {k: len(v) + passed_over.get(k, 0) for k, v in seen.items()}
        if held != {k: n - replayed[k] for k, n in counts.items()
                    if n - replayed[k]}:
            raise RuntimeError(f"{what}: recorded calls do not match the "
                               f"launch counters")
        log(f"{what}: {len(calls)} of {sum(counts.values())} kernel calls "
            f"held against plain, all equal"
            + (f" (passed over: {passed_over})" if passed_over else "")
            + ", at " + "; ".join(
                f"{k} {len(set(v))} shapes, up to "
                f"{max(v, key=lambda s: int(np.prod(s)))}" if k in FIELD
                else f"{k} {sorted(set(v))}"
                for k, v in sorted(seen.items())))
        calls.clear()
        return out, counts

    launches, traces = {}, {}
    for path, (shape, needed) in PATHS.items():
        t = traces[shape] = torch.from_numpy(
            trace(*shape).view(np.int32)).to(dev)
        what = f"commit ({path}) 2^{shape[0]} x {shape[1]}"
        root, launches[path] = run_recorded(
            what, needed, (), lambda: commit_forward(t, device="cuda"))
        got = words_hex(to_numpy(root))
        if got != GOLDEN[shape]:
            raise RuntimeError(f"commit ({path}) root is {got}, the JAX "
                               f"package's is {GOLDEN[shape]}")
        log(f"{what}: root {got} == JAX package's")

    t0 = time.perf_counter()
    launches.update(streamed_path(dev, run_recorded, wall_ms))
    log(f"path (s) took {time.perf_counter() - t0:.1f} s")

    # path (p): the distributed primitives on a one-rank NCCL group, each
    # result held to the single-card function's on the same inputs (made
    # first, outside the counted run), then timed beside it
    t0 = time.perf_counter()
    launches["p"] = dist_path(dev, run_recorded, cuda_ms, rand_field)
    log(f"path (p) took {time.perf_counter() - t0:.1f} s")

    # the PCS proofs: commit two rounds, open, verify on the host, reject a
    # tampered proof, compare with the JAX package's digests
    pcs_state = {}
    for path, (shapes, hasher, needed, forbidden) in PCS_PATHS.items():
        what = f"pcs ({path}) {hasher} " + " ".join(
            f"2^{n}x{c}" for n, c in shapes)
        pcs = TwoAdicFriPcs(FriConfig(hasher=hasher, **PCS_FRI),
                            coset_shift=31)
        mats = [torch.from_numpy(m.view(np.int32)).to(dev)
                for m in pcs_matrices(shapes)]
        points = pcs_points(shapes)
        (rounds, opened, proof), launches[path] = run_recorded(
            what, needed, forbidden,
            lambda: pcs_prove(pcs, DuplexChallenger(), mats, points),
            sample=True)
        roots = [root for root, _ in rounds]
        t0 = time.perf_counter()
        pcs_verify(pcs, DuplexChallenger(), shapes, roots, points, opened,
                   proof)
        t_verify = time.perf_counter() - t0
        bad = [[[list(pt) for pt in mat] for mat in rnd] for rnd in opened]
        v = bad[0][0][1][7]
        bad[0][0][1][7] = (v[0], v[1], (v[2] + 1) % P, v[3], v[4])
        try:
            pcs_verify(pcs, DuplexChallenger(), shapes, roots, points, bad,
                       proof)
        except FriError as e:
            log(f"{what}: verified on the host in {t_verify:.1f} s; one "
                f"changed opened value is rejected: {e}")
        else:
            raise RuntimeError(f"{what}: a tampered proof was accepted")
        got = proof_digest(opened, proof)
        got["roots"] = [words_hex(r) for r in roots]
        log(f"{what}: {len(proof.fri.commit_phase_commits)} FRI layers, "
            f"witness {proof.fri.pow_witness}, digests {got}")
        want = PCS_GOLDEN.get(path, {})
        for key, value in want.items():
            if got[key] != value:
                raise RuntimeError(f"{what}: {key} is {got[key]}, the JAX "
                                   f"package's is {value}")
        if want:
            log(f"{what}: {sorted(want)} == JAX package's")
        if path == "d":
            pcs_state = dict(pcs=pcs, mats=mats, points=points, rounds=rounds)

    def check_tampers(what, machine, cfg, proof):
        for case, (tamper, expected) in TAMPERS.items():
            try:
                machine.verify(cfg, tamper(proof))
            except VerificationError as e:
                if type(e).__name__ != expected:
                    raise RuntimeError(
                        f"{what}: a changed {case} raised "
                        f"{type(e).__name__}, the JAX package's verifier "
                        f"raises {expected}") from e
                log(f"{what}: a changed {case} is rejected: "
                    f"{type(e).__name__}: {e}")
            else:
                raise RuntimeError(f"{what}: a changed {case} was accepted")

    # the machine proofs: (m) the golden fixture, (f') and (g') pinned whole
    # proofs, (f) the full-width ragged machine; proved on the card through
    # Machine.prove, verified by the port's host verifier
    machine_state = {}
    for path, (log_pairs, hasher, needed, forbidden) in MACHINE_PATHS.items():
        if path == "m":
            machine = examples.random_mini_machine(48, seed=3)
            cfg = default_config(num_queries=3, proof_of_work_bits=1)
            what = "machine (m) random_mini_machine(48, seed=3)"
        else:
            machine = examples.random_ragged_machine(1 << log_pairs, seed=7)
            cfg = default_config(hasher=hasher)
            what = (f"machine ({path}) random_ragged_machine(2^{log_pairs}, "
                    f"seed=7) {hasher}")
        t0 = time.perf_counter()
        proof, launches[path] = run_recorded(
            what, needed, forbidden, lambda: machine.prove(cfg), sample=True)
        t_prove = time.perf_counter() - t0
        blob = serialize_proof(proof)
        digest = hashlib.sha256(blob).hexdigest()
        t0 = time.perf_counter()
        machine.verify(cfg, proof)
        t_verify = time.perf_counter() - t0
        log(f"{what}: log-degrees {[cp.log_degree for cp in proof.chip_proofs]}"
            f", proved (launches recorded) in {t_prove:.1f} s, verified on "
            f"the host in {t_verify:.2f} s, {len(blob)} bytes, sha256 {digest}")
        if path == "m":
            with open(os.path.join(ROOT, FIXTURE), "rb") as f:
                want = f.read()
            if blob != want:
                raise RuntimeError(f"{what}: the proof's bytes differ from "
                                   f"{FIXTURE}")
            machine.verify(cfg, deserialize_proof(want))
            log(f"{what}: bytes == {FIXTURE}, which the port verifies")
        elif path in MACHINE_GOLDEN:
            if digest != MACHINE_GOLDEN[path]:
                raise RuntimeError(f"{what}: sha256 is {digest}, the JAX "
                                   f"package's is {MACHINE_GOLDEN[path]}")
            log(f"{what}: sha256 == JAX package's")
        else:
            roots = [words_hex(proof.commitments.preprocessed),
                     words_hex(proof.commitments.main_trace)]
            if roots != F_ROOTS:
                raise RuntimeError(f"{what}: preprocessed and main roots "
                                   f"{roots}, the JAX package's {F_ROOTS}")
            log(f"{what}: preprocessed and main-trace roots == JAX "
                f"package's")
            check_tampers(what, machine, cfg, proof)
            machine_state = dict(machine=machine, cfg=cfg, proof=proof)

    def prove_jit_twice(label, path, machine, cfg, needed, forbidden, pin,
                        mesh=None):
        """A path of the staged prover: the first prove runs each stage
        eagerly once (its kernel calls recorded and held against plain),
        captures it and replays it; the second only replays.  Both proofs
        must serialize to `pin` (a SHA-256).  Returns the second proof."""
        for run in ("first", "warm"):
            what = f"{path}, prove_jit {run}"
            captures = jit_prover.stats["captures"]
            t0 = time.perf_counter()
            proof, launches[f"{label} {run}"] = run_recorded(
                what, needed, forbidden,
                lambda: jit_prover.prove_jit(machine, cfg, mesh=mesh),
                sample=True)
            t_prove = time.perf_counter() - t0
            new = jit_prover.stats["captures"] - captures
            digest = hashlib.sha256(serialize_proof(proof)).hexdigest()
            log(f"{what}: {t_prove:.2f} s, {new} graphs captured, "
                f"{len(jit_prover.STAGE_LOG)} stage calls, sha256 {digest}")
            if digest != pin:
                raise RuntimeError(f"{what}: sha256 is {digest}, the JAX "
                                   f"package's is {pin}")
            if run == "warm" and new:
                raise RuntimeError(f"{what}: a warm prove captured {new} "
                                   f"graphs")
        log(f"{path}: sha256 == JAX package's, first and warm")
        return proof

    # the staged prover on (f') and (g')
    for path in ("f'", "g'"):
        log_pairs, hasher, needed, forbidden = MACHINE_PATHS[path]
        machine = examples.random_ragged_machine(1 << log_pairs, seed=7)
        cfg = default_config(hasher=hasher)
        proof = prove_jit_twice(
            f"{path} jit",
            f"machine ({path} jit) random_ragged_machine(2^{log_pairs}, "
            f"seed=7) {hasher}", machine, cfg, needed, forbidden,
            MACHINE_GOLDEN[path])
        machine.verify(cfg, proof)
    jit_prover.release_graphs()
    torch.cuda.empty_cache()

    # the BasicMachine: (n) fib(25) and (h') the ALU loop at 2^13 cycles,
    # whole proofs pinned, (h') by each of the three interpreters; (h) and
    # (k) the ALU loop at 2^20 cycles by the Python step loop and by the
    # C++ core in array mode, roots pinned, (k)'s op arrays held to (h)'s
    # logs.  The prover builds the op-log chips' traces on the card from
    # their uploaded op arrays.
    def basic_machine(prog, interpreter):
        if prog == "fib":
            program, fp = examples.fib_program(), 0x1000
        else:
            program = examples.alu_loop_program((1 << prog) // 14)
            fp = 0x1000000
        if interpreter == "run":
            return examples.run_program(program, fp)
        m = BasicMachine()
        m.program().set_program_rom(ProgramROM(program))
        m.cpu().fp = fp
        m.run_native(build_lists=interpreter == "lists")
        return m

    def first_op_array_difference(machine, ref):
        """(chip, field) of the first op array of `machine` that differs
        from `ref`'s, or None."""
        for chip in ("cpu", "mem"):
            got = getattr(machine, chip)().op_arrays()
            want = getattr(ref, chip)().op_arrays()
            for i, (g, w) in enumerate(zip(got, want, strict=True)):
                if g.dtype != w.dtype or not np.array_equal(g, w):
                    return chip, i
        for accessor, kinds in ALU_LOGS.values():
            if accessor == "native_field":
                continue
            got = getattr(machine, accessor)().operations
            want = _ops_to_arrays(getattr(ref, accessor)().operations, kinds)
            for i, (g, w) in enumerate(zip(got, want, strict=True)):
                if not np.array_equal(g, w):
                    return accessor, i
        return None

    basic_pins = {**BASIC_GOLDEN, "h'": ALU_LOOP_SHA256[13]}
    basic_state = {}
    for path, (prog, interpreter) in BASIC_PATHS.items():
        t0 = time.perf_counter()
        machine = basic_machine(prog, interpreter)
        t_interp = time.perf_counter() - t0
        what = (f"basic ({path}) " + ("fib(25)" if prog == "fib" else
                                      f"ALU loop 2^{prog} cycles")
                + f" by {interpreter}")
        log(f"{what}: interpreted {machine.cpu().clock} cycles on the host "
            f"in {t_interp:.3f} s")
        if prog == "fib":
            profile = (machine.cpu().clock,
                       sum(len(v) for v in machine.mem().operations.values()),
                       len(machine.add_u32().operations),
                       machine.mem().cells[0x1000 + 4])
            if profile != (192, 401, 105, 75025):
                raise RuntimeError(f"{what}: interpreter profile (clock, "
                                   f"memory ops, adds, fp+4) {profile}, "
                                   f"expected (192, 401, 105, 75025)")
        if path == "k":
            t0 = time.perf_counter()
            differs = first_op_array_difference(machine, basic_state["h"]["machine"])
            if differs is not None:
                raise RuntimeError(f"{what}: op arrays {differs} differ from "
                                   f"(h)'s logs converted")
            log(f"{what}: every op array (cpu, mem, 8 ALU chips) == (h)'s "
                f"logs converted ({time.perf_counter() - t0:.1f} s)")
        cfg = default_config()
        t0 = time.perf_counter()
        proof, launches[path] = run_recorded(
            what, *BASIC_KERNELS, lambda: machine.prove(cfg), sample=True)
        t_prove = time.perf_counter() - t0
        runs = dict(device_runs)
        blob = serialize_proof(proof)
        digest = hashlib.sha256(blob).hexdigest()
        t0 = time.perf_counter()
        machine.verify(cfg, proof)
        t_verify = time.perf_counter() - t0
        degrees = {c.name: cp.log_degree
                   for c, cp in zip(machine.chips(), proof.chip_proofs)}
        log(f"{what}: log-degrees {degrees}, proved (launches recorded) in "
            f"{t_prove:.1f} s, verified on the host in {t_verify:.2f} s, "
            f"{len(blob)} bytes, sha256 {digest}; ntt_dif_whole launched "
            f"{launches[path]['ntt_dif_whole']} times")
        pin = path.split()[0]
        if pin in basic_pins:
            if digest != basic_pins[pin]:
                raise RuntimeError(f"{what}: sha256 is {digest}, the JAX "
                                   f"package's is {basic_pins[pin]}")
            log(f"{what}: sha256 == JAX package's")
        else:
            roots = [words_hex(proof.commitments.preprocessed),
                     words_hex(proof.commitments.main_trace)]
            if roots != H_ROOTS:
                raise RuntimeError(f"{what}: preprocessed and main roots "
                                   f"{roots}, the JAX package's {H_ROOTS}")
            log(f"{what}: preprocessed and main-trace roots == JAX "
                f"package's")
            check_tampers(what, machine, cfg, proof)
            basic_state[path] = dict(machine=machine, cfg=cfg, proof=proof,
                                     degrees=degrees, interpret_s=t_interp,
                                     launches=launches[path],
                                     device_runs=runs)

    # (quot): the quotient kernel against its plain version for every chip
    # of (k)'s machine at (k)'s heights, and timed there ((j)'s shapes)
    t0 = time.perf_counter()
    quot_numbers = quot_phase(
        dev, check, basic_state["k"]["machine"], basic_state["k"]["degrees"],
        default_config(), rand_field, cuda_ms, int32_ops_per_s)
    torch.cuda.empty_cache()
    log(f"(quot) took {time.perf_counter() - t0:.1f} s")

    # the staged prover on (h'), then on the same loop with the divisor's
    # immediate changed from 3 to 5: the same shapes, so the same graphs
    # replay with the other program's ROM and values
    cfg = default_config()
    prove_jit_twice("h' jit", "basic (h' jit) ALU loop 2^13 cycles by arrays",
                    basic_machine(13, "arrays"), cfg, *BASIC_KERNELS,
                    basic_pins["h'"])
    program = examples.alu_loop_program((1 << 13) // 14)
    if program[1] != examples.instruction(OC.IMM32, -8, 0, 0, 0, 3):
        raise RuntimeError("the ALU loop's second instruction is not the "
                           "divisor's immediate")
    program[1] = examples.instruction(OC.IMM32, -8, 0, 0, 0, 5)
    variant = BasicMachine()
    variant.program().set_program_rom(ProgramROM(program))
    variant.cpu().fp = 0x1000000
    variant.run_native(build_lists=False)
    what = "basic (h' jit variant) ALU loop 2^13 cycles, divisor 5"
    captures = jit_prover.stats["captures"]
    proof, launches["h' jit variant"] = run_recorded(
        what, *BASIC_KERNELS, lambda: jit_prover.prove_jit(variant, cfg),
        sample=True)
    new = jit_prover.stats["captures"] - captures
    blob = serialize_proof(proof)
    digest = hashlib.sha256(blob).hexdigest()
    if new or blob != serialize_proof(variant.prove(cfg)):
        raise RuntimeError(f"{what}: {new} graphs captured (expected 0), or "
                           f"the bytes differ from the eager prover's")
    if digest == basic_pins["h'"]:
        raise RuntimeError(f"{what}: the variant's proof is (h')'s")
    variant.verify(cfg, proof)
    log(f"{what}: no graph captured, bytes == the eager prover's (sha256 "
        f"{digest}, not (h')'s), verified on the host")
    jit_prover.release_graphs()
    torch.cuda.empty_cache()
    del variant

    # the compositions, interpreted by the C++ core in array mode
    for path, (cls, asm) in COMPOSITION_PATHS.items():
        machine = getattr(compositions, cls)()
        machine.program().set_program_rom(
            ProgramROM.from_machine_code(assemble(asm)))
        machine.cpu().fp = 0x1000
        machine.run_native(build_lists=False)
        what = f"composition ({path}) {cls}"
        cfg = default_config()
        proof, launches[path] = run_recorded(
            what, *BASIC_KERNELS, lambda: machine.prove(cfg), sample=True)
        machine.verify(cfg, proof)
        digest = hashlib.sha256(serialize_proof(proof)).hexdigest()
        if digest != COMPOSITION_GOLDEN[path]:
            raise RuntimeError(f"{what}: sha256 is {digest}, the JAX "
                               f"package's is {COMPOSITION_GOLDEN[path]}")
        log(f"{what}: {len(machine.chips())} chips, "
            f"{machine.cpu().clock} cycles, verified on the host; sha256 "
            f"== JAX package's")

    # (cli): the port's CLI, each action in a process of its own
    launches["cli"] = run_cli(log)

    # 5. timings at the main path's shapes
    kernels = []

    def graph_ms(fn, sets, iters):
        """Device ms of one fn(*operands) call: max(iters, len(sets)) calls,
        the k-th on sets[k % len(sets)], captured into a CUDA graph and
        replayed, so that the host's cost of enqueueing a kernel shorter
        than it (the field kernels at 2^21 words) is left out.  The sets
        hold more than L2 together and every call's output is kept, so each
        call reads and writes device memory, as on the main path."""
        fn(*sets[0])
        torch.cuda.synchronize()
        calls = max(iters, len(sets))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [fn(*sets[k % len(sets)]) for k in range(calls)]
        ms = cuda_ms(graph.replay, 3) / calls
        del graph, outs
        torch.cuda.synchronize()
        return ms

    def report(name, fn, plain_fn, nbytes, ops, iters, plain_iters,
               timer=None):
        timer = timer or cuda_ms
        ms = timer(fn, iters)
        plain_ms = timer(plain_fn, plain_iters)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / int32_ops_per_s * 1e3
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(n[name] for n in launches.values()),
            "launches_per_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        log(f"{name}: {ms:.4f} ms/call, plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({kernels[-1]['bound_by']})")

    # ntt_dif_whole: the LDE's forward DIF of commit (b), 2^20 x 128
    n, cols = 1 << 20, 128
    x = rand_field((n, cols))
    table_bytes = ntt._root_powers(20, False).nbytes  # n/2 root powers
    report("ntt_dif_whole", lambda: radix_ntt.dif_whole(x, 20, False),
           lambda: radix_ntt.dif_passes_plain(x, 20, False),
           2 * n * cols * 4 + table_bytes, n // 2 * 20 * cols * BUTTERFLY_OPS,
           10, 2)

    # ntt_dif_ragged: the forward DIF of commit (c), 2^20 x 51, and of (d)'s
    # second round, 2^20 x 10
    cols = 51
    x = rand_field((n, cols))
    report("ntt_dif_ragged", lambda: radix_ntt.dif_ragged(x, 20, False),
           lambda: radix_ntt.dif_passes_plain(x, 20, False),
           2 * n * cols * 4 + table_bytes, n // 2 * 20 * cols * BUTTERFLY_OPS,
           10, 2)
    cols = 10
    x = rand_field((n, cols))
    ms10 = cuda_ms(lambda: radix_ntt.dif_ragged(x, 20, False), 10)
    plain10 = cuda_ms(lambda: radix_ntt.dif_passes_plain(x, 20, False), 2)
    t_bytes = (2 * n * cols * 4 + table_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n // 2 * 20 * cols * BUTTERFLY_OPS / int32_ops_per_s * 1e3
    log(f"ntt_dif_ragged at 2^20 x 10: {ms10:.4f} ms/call, plain "
        f"{plain10:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    del x

    # keccak256: the leaf level of commit (b), 2^20 rows of 128 words
    rows, n_words = 1 << 20, 128
    w = rand_words((rows, n_words))
    n_blocks = n_words // 34 + 1
    report("keccak256", lambda: keccak.keccak256_words(w),
           lambda: keccak.keccak256_words_plain(w),
           rows * (n_words + 8) * 4, rows * n_blocks * KECCAK_F_OPS, 10, 1)
    log(f"keccak leaf rows/s at 2^20 x 128 words: "
        f"{rows / (kernels[-1]['ms'] / 1e3):.6g}")

    # poseidon2: the leaf level of path (d), 2^20 rows of 128 words, and
    # its first compression, 2^19 rows of 16 words
    rows, n_words = 1 << 20, 128
    w = rand_field((rows, n_words))
    report("poseidon2", lambda: p2.hash_words(w),
           lambda: p2.hash_words_plain(w), rows * (n_words + 8) * 4,
           rows * -(-n_words // 8) * POSEIDON2_BLOCK_OPS, 10, 1)
    log(f"poseidon2 leaf rows/s at 2^20 x 128 words: "
        f"{rows / (kernels[-1]['ms'] / 1e3):.6g}")
    rows, n_words = 1 << 19, 16
    w16 = rand_field((rows, n_words))
    ms16 = cuda_ms(lambda: p2.hash_words(w16), 10)
    plain16 = cuda_ms(lambda: p2.hash_words_plain(w16), 1)
    t_bytes = rows * (n_words + 8) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = rows * 2 * POSEIDON2_BLOCK_OPS / int32_ops_per_s * 1e3
    log(f"poseidon2 at 2^19 x 16 words: {ms16:.4f} ms/call, plain "
        f"{plain16:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    del w, w16

    # the field kernels at the main path's shapes: 2^21 words (the
    # quotient's domain of a 2^20-row trace at blowup 2), 2^21 extension
    # elements.  A call there is shorter than the host's enqueue of it, so
    # kernel and plain version are timed as CUDA graph replays (the eager
    # per-call time prints beside), each call on one of a rotation of
    # operand sets that hold L2_ROTATION bytes together.
    # field_elementwise's row is its product; its other ops print beside.
    # The plain version of field_inv is inv_batch's product tree, which the
    # main path ran before the kernels (square and multiply prints beside)
    n = 1 << 21

    def operand_sets(*shapes):
        set_bytes = sum(4 * int(np.prod(shape)) for shape in shapes)
        return [tuple(rand_field(shape) for shape in shapes)
                for _ in range(-(-L2_ROTATION // set_bytes))]

    base1, base2 = operand_sets((n,)), operand_sets((n,), (n,))
    ext1, ext2 = operand_sets((n, 5)), operand_sets((n, 5), (n, 5))
    for name, fn, plain_fn, sets, nbytes, plain_iters in [
            ("field_elementwise", bb.mul, bb.mul_plain, base2, 3 * 4 * n, 5),
            ("field_inv", bb.inv, bb.inv_batch_plain, base1, 2 * 4 * n, 3),
            ("field_ext_mul", extf.ext_mul, extf.ext_mul_plain, ext2,
             3 * 20 * n, 3),
            ("field_ext_inv", extf.ext_inv, extf.ext_inv_plain, ext1,
             2 * 20 * n, 2)]:
        report(name, fn, plain_fn, nbytes, n * FIELD_OPS[name], 20,
               plain_iters,
               timer=lambda f, iters, sets=sets: graph_ms(f, sets, iters))
        log(f"{name}: eager, {cuda_ms(lambda: fn(*sets[0]), 20):.4f} "
            f"ms/call (the host's enqueue) against {kernels[-1]['ms']:.4f} "
            f"in a graph ({len(sets)} operand sets)")
    for what, name, sets, scalar in [
            ("add", "add", base2, ()), ("sub", "sub", base2, ()),
            ("neg", "neg", base1, ()), ("to_monty", "to_monty", base1, ()),
            ("from_monty", "from_monty", base1, ()),
            ("from_wrapped_u32", "from_wrapped_u32", base1, ()),
            ("mul by a scalar word", "mul", base1, (123456789,))]:
        fn, plain_fn = getattr(bb, name), getattr(bb, f"{name}_plain")
        ms = graph_ms(lambda *x: fn(*x, *scalar), sets, 20)
        plain_ms = graph_ms(lambda *x: plain_fn(*x, *scalar), sets, 5)
        words_moved = n * (1 + len(sets[0]))
        log(f"field_elementwise {what} at 2^21 words (graph replays): "
            f"{ms:.4f} ms/call, plain {plain_ms:.4f} ms, bound "
            f"{4 * words_moved / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    log(f"field_inv's square-and-multiply plain version (inv_plain) at 2^21 "
        f"words: {cuda_ms(lambda: bb.inv_plain(base1[0][0]), 2):.4f} ms")
    del base1, base2, ext1, ext2

    # constraint_eval: (quot)'s per-chip times summed over the 15 chips of
    # (j)'s machine (one prove's quotients), against the sum of their bounds
    src, replaces = SOURCES["constraint_eval"]
    t_bytes = sum(v["t_bytes"] for v in quot_numbers.values())
    t_ops = sum(v["t_ops"] for v in quot_numbers.values())
    kernels.append({
        "name": "constraint_eval", "route": "cuda", "source": src,
        "replaces": replaces,
        "launches": sum(n["constraint_eval"] for n in launches.values()),
        "launches_per_path": {p: n["constraint_eval"]
                              for p, n in launches.items()},
        "max_abs_err": max_err["constraint_eval"],
        "ms": sum(v["ms"] for v in quot_numbers.values()),
        "plain_ms": sum(v["plain_ms"] for v in quot_numbers.values()),
        "bound_ms": sum(max(v["t_bytes"], v["t_ops"])
                        for v in quot_numbers.values()),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "ms_per_chip": {k: v["ms"] for k, v in quot_numbers.items()},
    })
    log(f"constraint_eval: {kernels[-1]['ms']:.4f} ms for the 15 chips of "
        f"(j)'s machine, plain {kernels[-1]['plain_ms']:.4f} ms, bound "
        f"{kernels[-1]['bound_ms']:.4f} ms ({kernels[-1]['bound_by']}; "
        f"bytes {t_bytes:.4f}, operations {t_ops:.4f})")

    # NTT butterflies/s at 2^19 x 128, as bench.py counts them
    n, cols = 1 << 19, 128
    x = rand_field((n, cols))
    t_ntt = cuda_ms(lambda: radix_ntt.dif(x), 20) / 1e3
    t_copy = cuda_ms(lambda: x + 1, 20) / 1e3
    nbytes = n * cols * 4
    # the array read once and written once over the transform's time, as a
    # fraction of the stream copy's rate: whatever the kernel's passes
    log(f"NTT 2^19 x 128: {n // 2 * 19 * cols / t_ntt:.6g} butterflies/s, "
        f"{t_ntt * 1e3:.4f} ms; stream copy {2 * nbytes / t_copy / 1e9:.1f} "
        f"GB/s; array in and out once at {2 * nbytes / t_ntt / 1e9:.1f} GB/s, "
        f"{t_copy / t_ntt:.4f} of the stream copy")

    # commits (b) and (c) wall-clock, warm
    for shape in [(19, 128), (19, 51)]:
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            commit_forward(traces[shape], device="cuda")
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        log(f"commit 2^{shape[0]} x {shape[1]} wall-clock: {best * 1e3:.3f} "
            f"ms (best of 3)")

    # where the time goes: one warm run under torch.profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_run(what, fn):
        before = dict(_build.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            # a device record is kept only if it falls inside the
            # profiler's window as the host's clock reads it: late in a
            # long run, (j)'s profile lost the kernels of its last stages
            # (a skew of the two clocks), so the window stays open after
            # the synchronize
            time.sleep(2.0)
        counted = {k: _build.LAUNCHES[k] - n for k, n in before.items()}
        by_name, n_ops = {}, 0
        # a record_function range (the prover's stages) also shows on the
        # device's timeline, spanning the kernels inside it: its name is
        # that of a host event, which no kernel's is
        host_names = {e.name for e in prof.events()
                      if e.device_type == DeviceType.CPU}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.name not in host_names:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
                n_ops += 1
        def ours_of(name):
            """Which of our kernels a device kernel's name is (the field
            kernels are templates: `field_inv_kernel<unsigned int>(`)."""
            return [k for k in SOURCES if f"{k}_kernel(" in name
                    or f"{k}_kernel<" in name]

        ours = {k: sum(t for name, t in by_name.items()
                       if k in ours_of(name)) for k in SOURCES}
        # the device's kernel runs of each of ours (an NTT call runs one
        # per pass), beside the launches the wrappers and replays counted
        kernel_runs = {k: 0 for k in SOURCES}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.name not in host_names:
                for k in ours_of(e.name):
                    kernel_runs[k] += 1
        busy = sum(by_name.values())
        if busy <= 0:
            raise RuntimeError(f"{what}: the profile shows no device time")
        # the host's launch calls: kernel and graph launches through the
        # CUDA API, as the profiler's CPU side records them
        calls = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and (
                    "LaunchKernel" in e.name or "GraphLaunch" in e.name):
                calls[e.name] = calls.get(e.name, 0) + 1
        log(f"{what} profile (under the profiler {wall_us / 1e3:.3f} ms "
            f"wall): {n_ops} device operations, device busy "
            f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}; host "
            f"launch calls {calls}; our kernels' runs on the device "
            f"{kernel_runs} for the launches counted {counted}; by kernel "
            f"(ms): "
            + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in ours.items())
            + f", other PyTorch kernels "
              f"{(busy - sum(ours.values())) / 1e3:.3f}")
        for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"  {t / 1e3:9.3f} ms  {name[:110]}")
        # by stage: each range's span on the device's timeline and the
        # device time of the kernels that start inside it
        kernels = [(e.time_range.start, e.device_time_total)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name not in host_names]
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.name in host_names:
                t0, t1 = e.time_range.start, e.time_range.end
                inside = sum(t for s, t in kernels if t0 <= s < t1)
                log(f"  stage {e.name}: span {(t1 - t0) / 1e3:.3f} ms on the "
                    f"device's timeline, device busy {inside / 1e3:.3f} ms")
        return {"wall_ms": wall_us / 1e3, "device_ops": n_ops,
                "busy_ms": busy / 1e3, "idle": 1 - busy / wall_us,
                "launch_calls": calls, "kernel_runs": kernel_runs,
                "launches": counted}

    for shape in [(19, 128), (19, 51)]:
        profile_run(f"commit 2^{shape[0]} x {shape[1]}",
                    lambda: commit_forward(traces[shape], device="cuda"))

    # path (d): commit_batches of both rounds and open_multi_batches, warm
    pcs, mats, points = (pcs_state[k] for k in ("pcs", "mats", "points"))

    def commit_d():
        pcs.commit_batches(mats[:2])
        pcs.commit_batches(mats[2:])

    def open_d():
        challenger = DuplexChallenger()
        for root, _ in pcs_state["rounds"]:
            challenger.observe_digest(root)
        pcs.open_multi_batches(
            [(data, pts) for (_, data), pts
             in zip(pcs_state["rounds"], points)], challenger)

    log(f"pcs (d) commit_batches, both rounds, wall-clock: "
        f"{min(wall_ms(commit_d, 3)):.3f} ms (best of 3)")
    # the opening is bound by the host, whose clock spreads with its load:
    # the median of 7 runs is read beside the best of the first 3, and the
    # profile's device-busy time beside both
    opens = wall_ms(open_d, 7)
    log(f"pcs (d) open_multi_batches wall-clock: {min(opens[:3]):.3f} ms "
        f"(best of 3), median of {len(opens)} {sorted(opens)[len(opens) // 2]:.3f}"
        f" ms, all " + " ".join(f"{t:.3f}" for t in opens))
    profile_run("pcs (d) commit_batches", commit_d)
    profile_run("pcs (d) open_multi_batches", open_d)

    # paths (f) and (h): the machine prover at full width, warm.  The host
    # clock spreads: the median of 5 proofs beside the best; then one proof
    # with the device's memory peak, one with the stage collection (each
    # stage waits for the card at its end) and one under the profiler
    def staged_prove(what, prove):
        """One prove with the stage collection on: host ms by stage."""
        utils.start_stage_collection()
        t0 = time.perf_counter()
        prove()
        t_staged = (time.perf_counter() - t0) * 1e3
        stages = utils.stop_stage_collection()
        log(f"{what} prove by stage (host wall-clock, the card synchronised "
            f"at each stage's end; {t_staged:.3f} ms in all): "
            + ", ".join(f"{k} {v['s'] * 1e3:.3f} ms"
                        for k, v in stages.items())
            + f"; outside the stages "
              f"{t_staged - sum(v['s'] for v in stages.values()) * 1e3:.3f}"
              f" ms")

    def time_machine(what, state, verify_before=None, prove=None, runs=5,
                     profiled=True):
        """The median of `runs` proves beside the best, one prove's memory
        peak, one by stage and, if `profiled`, one profiled (prove: the
        prove to time, by default Machine.prove), then 3 verifies unless
        verify_before is None.  Returns the numbers."""
        machine, cfg = state["machine"], state["cfg"]
        prove = prove or (lambda: machine.prove(cfg))
        proves = wall_ms(prove, runs)
        median = sorted(proves)[len(proves) // 2]
        log(f"{what} prove wall-clock: best {min(proves):.3f} ms, median "
            f"of {len(proves)} {median:.3f} ms, "
            f"all " + " ".join(f"{t:.3f}" for t in proves))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        prove()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() / 2**30,
                torch.cuda.max_memory_reserved() / 2**30)
        log(f"{what} prove device memory: peak {peak[0]:.3f} GiB allocated "
            f"({base / 2**30:.3f} GiB held before it), {peak[1]:.3f} GiB "
            f"reserved")
        staged_prove(what, prove)
        out = profile_run(f"{what} prove", prove) if profiled else {}
        out.update(median_ms=median, best_ms=min(proves),
                   peak_allocated_gib=peak[0], peak_reserved_gib=peak[1])
        if verify_before is not None:
            verifies = wall_ms(lambda: machine.verify(cfg, state["proof"]),
                               3)
            log(f"{what} verify wall-clock (host): best "
                f"{min(verifies):.3f} ms, all "
                + " ".join(f"{t:.3f}" for t in verifies) + verify_before)
        return out

    time_machine("machine (f)", machine_state,
                 " (PR 5, before the host Keccak was numpy: 4144.306, "
                 "4254.986, 4436.389 ms)")
    # the ALU loop at 2^20 cycles: (h), the Python step loop's lists, one
    # staged prove as the baseline; then (k), the C++ core's arrays, timed
    # in full
    h, k = basic_state.pop("h"), basic_state["k"]
    log(f"basic ALU loop 2^20 cycles interpretation on the host: (h) run "
        f"{h['interpret_s']:.3f} s, (k) run_native(build_lists=False) "
        f"{k['interpret_s']:.3f} s")
    staged_prove("basic (h) ALU loop 2^20 cycles by run",
                 lambda: h["machine"].prove(h["cfg"]))
    del h
    # 3 timed proves, not 5, and no profile (the profiler's events of an
    # eager prove's 286,535 launches took 147 s to parse): (j) and the 2^16
    # paths below keep the script near its length
    timed_k = time_machine("basic (k) ALU loop 2^20 cycles by arrays", k, "",
                           runs=3, profiled=False)

    # path (j): (k)'s machine and op arrays through the staged prover,
    # without the debug checks (benchmarks/big_trace.py's configuration)
    machine, cfg = k["machine"], default_config(debug_checks=False)
    what = "basic (j) ALU loop 2^20 cycles by arrays, staged"
    t0 = time.perf_counter()
    want = serialize_proof(machine.prove(cfg))
    log(f"{what}: the eager prover's proof of it in "
        f"{time.perf_counter() - t0:.1f} s, {len(want)} bytes")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    n_calls, launches["j warmup"] = run_recorded(
        f"{what} warmup_jit", *BASIC_KERNELS,
        lambda: jit_prover.warmup_jit(machine, cfg), sample=True)
    # the warm-up's eager first runs: their counted launches and kernel
    # runs (its graphs' one replay each counted apart, and the selector
    # tables' build), which a warm prove's replays must repeat for the
    # field kernels
    j_eager = {name: n - _build.GRAPH_LAUNCHES[name]
               - table_setup["launches"][name]
               for name, n in launches["j warmup"].items()}
    j_eager_runs = {k: n - table_setup["runs"][k]
                    for k, n in device_runs.items()}
    log(f"{what}: warmup_jit (kernel calls recorded) in "
        f"{time.perf_counter() - t0:.1f} s: {n_calls} stage calls, "
        f"{jit_prover.stats['captures']} graphs captured; memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB allocated "
        f"({base / 2**30:.3f} GiB held before it), "
        f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB reserved")
    captures = jit_prover.stats["captures"]
    proof, launches["j"] = run_recorded(
        what, *BASIC_KERNELS, lambda: jit_prover.prove_jit(machine, cfg))
    if jit_prover.stats["captures"] != captures:
        raise RuntimeError(f"{what}: a warm prove_jit captured "
                           f"{jit_prover.stats['captures'] - captures} graphs")
    if serialize_proof(proof) != want:
        raise RuntimeError(f"{what}: the bytes differ from the eager "
                           f"prover's proof in this run")
    roots = [words_hex(proof.commitments.preprocessed),
             words_hex(proof.commitments.main_trace)]
    if roots != H_ROOTS:
        raise RuntimeError(f"{what}: preprocessed and main roots {roots}, "
                           f"the JAX package's {H_ROOTS}")
    machine.verify(cfg, proof)
    log(f"{what}: no graph captured, bytes == the eager prover's, roots == "
        f"JAX package's, verified on the host")
    check_tampers(what, machine, cfg, proof)
    timed_j = time_machine(
        what, dict(machine=machine, cfg=cfg),
        prove=lambda: jit_prover.prove_jit(machine, cfg))
    # the graphs hold what the eager prover launches: the profiled staged
    # prove ran as many of each of our NTT and hash kernels on the device
    # as (k)'s recorded eager prove of the same machine ran (an NTT call one
    # run a pass); its graph replays counted as many launches as (k)'s
    # wrappers did; a Keccak launch is one kernel run on the device.  The
    # field kernels run in the debug checks too, which (k) runs and (j)
    # does not: theirs are held to (j)'s own eager first runs, as (jm)'s
    def part(d, names):
        return {name: d[name] for name in names}

    hashes = [name for name in SOURCES if name not in FIELD]
    if (part(timed_j["kernel_runs"], hashes) != part(k["device_runs"], hashes)
            or part(timed_j["launches"], hashes)
            != part(k["launches"], hashes)
            or part(timed_j["kernel_runs"], FIELD)
            != part(j_eager_runs, FIELD)
            or part(timed_j["launches"], FIELD) != part(j_eager, FIELD)
            or timed_j["kernel_runs"]["keccak256"]
            != timed_j["launches"]["keccak256"]
            or not all(timed_j["kernel_runs"][n] for n in BASIC_KERNELS[0])):
        raise RuntimeError(
            f"{what}: kernel runs {timed_j['kernel_runs']} on the device for "
            f"launches {timed_j['launches']}; the eager prove's "
            f"{k['device_runs']} and {k['launches']}; the field kernels' in "
            f"its own eager first runs {part(j_eager_runs, FIELD)} and "
            f"{part(j_eager, FIELD)}")
    log(f"{what}: our NTT and hash kernels' runs on the device in a warm "
        f"prove equal the eager prove's {part(k['device_runs'], hashes)}, "
        f"and its counted launches the eager prove's "
        f"{part(k['launches'], hashes)}; the field kernels' runs and "
        f"launches its own eager first runs' {part(j_eager_runs, FIELD)} "
        f"and {part(j_eager, FIELD)}")
    log("(j) beside (k), this call: " + "; ".join(
        f"{key} {timed_j[key]} against {timed_k[key]}"
        for key in ("median_ms", "best_ms", "peak_allocated_gib",
                    "peak_reserved_gib"))
        + "; (j) alone: " + "; ".join(
            f"{key} {timed_j[key]}" for key in ("busy_ms", "idle",
                                                "device_ops",
                                                "launch_calls")))
    del proof
    jit_prover.release_graphs()
    torch.cuda.empty_cache()

    # paths (k16), (j16) and, on the mesh below, (jm16): the ALU loop at
    # 2^16 cycles through each prover, every proof's bytes held to the JAX
    # package's pin (ALU_LOOP_SHA256[16], made once by its numpy prover),
    # launches counted and kernel calls recorded as (k), (j) and (jm)
    machine16 = alu_loop_machine(16)
    cfg16 = default_config(debug_checks=False)

    def pinned_16(label, what, prove, kernels):
        """Run prove() as path `label`, its launches counted and its kernel
        calls recorded; its proof's SHA-256 must be the 2^16 pin.  Returns
        (the proof, seconds)."""
        captures = jit_prover.stats["captures"]
        t0 = time.perf_counter()
        proof, launches[label] = run_recorded(what, *kernels, prove,
                                              sample=True)
        seconds = time.perf_counter() - t0
        digest = hashlib.sha256(serialize_proof(proof)).hexdigest()
        if digest != ALU_LOOP_SHA256[16]:
            raise RuntimeError(f"{what}: sha256 is {digest}, the JAX "
                               f"package's is {ALU_LOOP_SHA256[16]}")
        log(f"{what}: {seconds:.1f} s (launches recorded), "
            f"{jit_prover.stats['captures'] - captures} graphs captured, "
            f"sha256 == JAX package's pin {digest}")
        return proof, seconds

    def warm_then_pinned(label, what, kernels, mesh=None):
        """warmup_jit (recorded as "<label> warmup"), then one prove_jit
        (as `label`) to the 2^16 pin, which must capture nothing; the
        graphs are released after.  Returns the seconds of both."""
        t0 = time.perf_counter()
        _calls, launches[f"{label} warmup"] = run_recorded(
            f"{what} warmup_jit", *kernels,
            lambda: jit_prover.warmup_jit(machine16, cfg16, mesh=mesh),
            sample=True)
        t_warm = time.perf_counter() - t0
        captures = jit_prover.stats["captures"]
        _proof, t_prove = pinned_16(
            label, what, lambda: jit_prover.prove_jit(machine16, cfg16,
                                                      mesh=mesh), kernels)
        if jit_prover.stats["captures"] != captures:
            raise RuntimeError(f"{what}: a warm prove_jit captured graphs")
        jit_prover.release_graphs()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{what}: warmup_jit {t_warm:.1f} s, then prove_jit "
            f"{t_prove:.1f} s")
        return t_warm + t_prove

    proof, t_k16 = pinned_16(
        "k16", "basic (k16) ALU loop 2^16 cycles by arrays, eager",
        lambda: machine16.prove(default_config()), BASIC_KERNELS)
    machine16.verify(default_config(), proof)
    del proof
    log(f"path (k16) took {t_k16:.1f} s")
    t_j16 = warm_then_pinned(
        "j16", "basic (j16) ALU loop 2^16 cycles by arrays, staged",
        BASIC_KERNELS)
    log(f"path (j16) took {t_j16:.1f} s")

    # paths (jm) and (g'm): the distributed staged prover on a one-rank
    # NCCL process group (the machine has one card), every collective run
    # on one rank; its graphs capture them with the kernels
    import datetime
    import tempfile

    import torch.distributed as tdist
    from valida_tpu_torch.parallel import dist_ntt, mesh as pmesh

    want_sha = hashlib.sha256(want).hexdigest()
    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300),
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = pmesh.make_mesh(1)
            what = ("basic (jm) ALU loop 2^20 cycles by arrays, staged, "
                    "one-rank NCCL mesh")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            captures = jit_prover.stats["captures"]
            t0 = time.perf_counter()
            n_calls, launches["jm warmup"] = run_recorded(
                f"{what} warmup_jit", *MESH_KERNELS["jm"],
                lambda: jit_prover.warmup_jit(machine, cfg, mesh=mesh),
                sample=True)
            t_warm = time.perf_counter() - t0
            # the warm-up's eager first runs: their counted launches and
            # kernel runs (its graphs' one replay each and the selector
            # tables' build counted apart)
            eager = {k: n - _build.GRAPH_LAUNCHES[k]
                     - table_setup["launches"][k]
                     for k, n in launches["jm warmup"].items()}
            eager_runs = {k: n - table_setup["runs"][k]
                          for k, n in device_runs.items()}
            log(f"{what}: warmup_jit (kernel calls recorded) in {t_warm:.1f}"
                f" s: {n_calls} stage calls, "
                f"{jit_prover.stats['captures'] - captures} graphs captured;"
                f" memory peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                f"allocated ({base / 2**30:.3f} GiB held before it), "
                f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB "
                f"reserved; eager first runs: launches {eager}, kernel runs "
                f"{eager_runs}; the selector tables' build apart: launches "
                f"{ {k: n for k, n in table_setup['launches'].items() if n} }")
            captures = jit_prover.stats["captures"]
            coll = dict(dist_ntt.COLLECTIVES)
            proof, launches["jm"] = run_recorded(
                what, *MESH_KERNELS["jm"],
                lambda: jit_prover.prove_jit(machine, cfg, mesh=mesh))
            coll = {k: dist_ntt.COLLECTIVES[k] - n for k, n in coll.items()}
            if len(jit_prover.STAGE_LOG) != n_calls:
                raise RuntimeError(f"{what}: warmup_jit called {n_calls} "
                                   f"stages, the warm prove_jit "
                                   f"{len(jit_prover.STAGE_LOG)}")
            if jit_prover.stats["captures"] != captures or coll["eager"]:
                raise RuntimeError(
                    f"{what}: a warm prove captured "
                    f"{jit_prover.stats['captures'] - captures} graphs and "
                    f"issued {coll['eager']} eager collectives")
            blob = serialize_proof(proof)
            if hashlib.sha256(blob).hexdigest() != want_sha:
                raise RuntimeError(f"{what}: sha256 differs from (j)'s "
                                   f"{want_sha}")
            roots = [words_hex(proof.commitments.preprocessed),
                     words_hex(proof.commitments.main_trace)]
            if roots != H_ROOTS:
                raise RuntimeError(f"{what}: preprocessed and main roots "
                                   f"{roots}, the JAX package's {H_ROOTS}")
            machine.verify(cfg, proof)
            log(f"{what}: no graph captured, {n_calls} stage calls as in "
                f"warmup_jit, sha256 == (j)'s {want_sha}, "
                f"roots == JAX package's, verified on the host; collectives "
                f"a warm prove: {coll['eager']} eager, {coll['replayed']} "
                f"inside its graphs")
            check_tampers(what, machine, cfg, proof)
            del proof, blob
            timed_jm = time_machine(
                what, dict(machine=machine, cfg=cfg),
                prove=lambda: jit_prover.prove_jit(machine, cfg, mesh=mesh))
            if (timed_jm["launches"] != eager
                    or timed_jm["kernel_runs"] != eager_runs
                    or not all(timed_jm["kernel_runs"][k]
                               for k in MESH_KERNELS["jm"][0])):
                raise RuntimeError(
                    f"{what}: a warm prove's kernel runs "
                    f"{timed_jm['kernel_runs']} and launches "
                    f"{timed_jm['launches']}, the eager first run's "
                    f"{eager_runs} and {eager}")
            log(f"{what}: our kernels' runs on the device in a warm prove "
                f"equal its eager first run's {eager_runs}, and its counted "
                f"launches {eager}")
            log("(jm) beside (j), this call: " + "; ".join(
                f"{key} {timed_jm[key]} against {timed_j[key]}"
                for key in ("median_ms", "best_ms", "busy_ms", "idle",
                            "device_ops", "launch_calls",
                            "peak_allocated_gib", "peak_reserved_gib"))
                + f"; warm-up {t_warm:.1f} s; collectives a warm prove "
                  f"{coll['eager']} eager, {coll['replayed']} in graphs")
            jit_prover.release_graphs()
            torch.cuda.empty_cache()

            # (g'm): (g') through prove_jit(mesh=): Poseidon2 trees
            log_pairs, hasher, _needed, _forbidden = MACHINE_PATHS["g'"]
            g_machine = examples.random_ragged_machine(1 << log_pairs,
                                                       seed=7)
            g_cfg = default_config(hasher=hasher)
            proof = prove_jit_twice(
                "g'm", f"machine (g'm) random_ragged_machine(2^{log_pairs}, "
                f"seed=7) {hasher}, one-rank NCCL mesh", g_machine, g_cfg,
                *MESH_KERNELS["g'm"], MACHINE_GOLDEN["g'"], mesh=mesh)
            g_machine.verify(g_cfg, proof)
            del proof
            jit_prover.release_graphs()
            gc.collect()
            torch.cuda.empty_cache()

            # (jm16): the 2^16 pin through prove_jit(mesh=)
            t_jm16 = warm_then_pinned(
                "jm16", "basic (jm16) ALU loop 2^16 cycles by arrays, "
                "staged, one-rank NCCL mesh", MESH_KERNELS["jm"], mesh=mesh)
            log(f"path (jm16) took {t_jm16:.1f} s")
        finally:
            # a graph that holds a collective must go before its group
            jit_prover.release_graphs()
            gc.collect()
            torch.cuda.synchronize()
            tdist.destroy_process_group()
    torch.cuda.empty_cache()
    log("distributed (jm), (g'm), (jm16): more than one rank is held only "
        "by the CPU tests on gloo (tests/test_torch_dist_prover.py, 2, 4 and "
        "8 ranks); a timing across cards waits for a machine with four")

    # (dryrun): the multi-card entry point on one NCCL rank, a process of
    # its own, started where this process holds little device memory: its
    # proof is checked against an eager prove, the 2^16 pin and the
    # verifier, and it exits 1 on any mismatch
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "valida_tpu_torch.parallel.dryrun", "1",
           "--prove", "16"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    t_dryrun = time.perf_counter() - t0
    said = [line for line in proc.stdout.splitlines()
            if line.startswith("prove")]
    for line in said:
        log(f"(dryrun) {line}")
    checked = ("== eager single-device prove == JAX package pin, verified")
    if proc.returncode != 0 or not any(checked in line for line in said):
        raise RuntimeError(f"(dryrun) {' '.join(cmd[1:])}: exit "
                           f"{proc.returncode}, stdout {proc.stdout[-2000:]}"
                           f", stderr {proc.stderr[-2000:]}")
    log(f"path (dryrun) `{' '.join(cmd[2:])}`: exit 0, the proof == eager "
        f"single-device prove == JAX package pin, verified; the process "
        f"took {t_dryrun:.1f} s")

    # the launches of every path, (j) included
    for entry in kernels:
        entry["launches_per_path"] = {p: n[entry["name"]]
                                      for p, n in launches.items()}
        entry["launches"] = sum(entry["launches_per_path"].values())

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s to the results "
        f"on {smi.stdout.strip().splitlines()[0]}")
    # 6. results
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
