#!/usr/bin/env python3
"""Experiments on the kernels redesigned for the H100, on one CUDA GPU.

    python3 experiments/kernel_experiments.py [--poseidon2-source FILE]
        [--ntt-only] [--parent DIR]

Variants of valida_tpu_torch/csrc/poseidon2.cu and ntt.cu are made by text
substitution, built beside each other with nvcc into build/experiments/,
and timed in turns within this one process, so their times compare.  Nothing
here is used by the port, and no test holds the substitutions to the
sources: a variant whose text is no longer found is reported and left out.
It prints:
1. the card's name, power limit and clocks;
2. integer instruction rates per clock per SM (int_rates.cu beside this
   script),
   with each loop's SASS opcode counts;
3. poseidon2 at 2^20 x 128 and 2^19 x 16 words: the kernel as it is, with
   its loads replaced by words made from the thread index (arithmetic
   only), with its permutation removed (loads only), with its round loops
   unrolled, without the stated minimum of blocks, and with 256 threads a
   block (P2_VARIANTS);
   the SM clock and power while the kernel loops; SASS opcode counts.
   --poseidon2-source runs the same on another version of the kernel,
   e.g. `git show REV:valida_tpu_torch/csrc/poseidon2.cu > build/p2.cu`;
4. ntt_dif_whole at 2^20 x 128, two passes (t_max 11) and three (t_max 8):
   as it is, without butterflies (memory only), without global loads and
   stores (compute only), each pass alone, with blocks numbered row sets
   first, and with 32 KB tiles;
5. ntt_dif_ragged at 2^20 x 51 and 2^20 x 10 (RAGGED_VARIANTS): as it is
   (51 columns as 13+13+13+12), with full groups and a narrow last one
   (16+16+16+3), with 68 KB tiles (3 x 17), with four blocks an SM, with
   loads through registers instead of cp.async, without the copies' L2
   prefetch hint and with a wider one, each pass alone, memory only and
   compute only; each in two passes (t_max 11) and in three (t_max 8,
   tiles of whole rows); then the kernel as built for the port at widths
   10 to 200 and t_max 11, 9, 8 and 7, beside radix_ntt._ragged_t_max's
   choice;
6. with --parent DIR (a copy of another tree of the repo, e.g. `git archive
   REV | tar -x -C build/parent`): radix_ntt.dif at 2^20 x 51, 2^20 x 10
   and 2^20 x 128 on that tree and on this one in turns (parent, this,
   this, parent), each in a process of its own, with a digest of each
   output so the two trees are seen to agree.
--ntt-only leaves out parts 2 and 3.  Exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

P = 2013265921
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(ROOT, "build", "experiments")

LOAD = re.compile(r"(const )?uint32_t w = base \+ i < n_words \? "
                  r"row\[base \+ i\] : 0u;")
P2_VARIANTS = {
    "as it is": [],
    "arithmetic only": [(LOAD, "uint32_t w = (uint32_t)msg * 2654435761u + "
                               "(uint32_t)(base + i);")],
    "loads only": [("    permute(s);\n  }\n  uint32_t* o",
                    "  }\n  uint32_t* o")],
    "rounds unrolled": [
        ("#pragma unroll 1\n  for (int r = 0; r < INTERNAL;",
         "#pragma unroll\n  for (int r = 0; r < INTERNAL;"),
        ("#pragma unroll 1\n  for (int r = 0; r < 2 * HALF_EXTERNAL;",
         "#pragma unroll\n  for (int r = 0; r < 2 * HALF_EXTERNAL;")],
    "internal rounds unrolled": [
        ("#pragma unroll 1\n  for (int r = 0; r < INTERNAL;",
         "#pragma unroll\n  for (int r = 0; r < INTERNAL;")],
    "no minimum of blocks": [("__launch_bounds__(THREADS, 1)",
                              "__launch_bounds__(THREADS)")],
    "256 threads": [("constexpr int THREADS = 128;",
                     "constexpr int THREADS = 256;")],
}
NTT_VARIANTS = {
    "as it is": [],
    "memory only": [("int l = 0;", "int l = T;"),
                    ("if (T & 1) {", "if (false) {")],
    "compute only": [
        ("    cp_async16(buf + unit_at(i, q, q_log),",
         "    if (src == nullptr) cp_async16(buf + unit_at(i, q, q_log),"),
        ("    *reinterpret_cast<uint4*>(dst + base",
         "    if (buf[unit_at(i, q, q_log)].x == 0x92345678u)\n"
         "    *reinterpret_cast<uint4*>(dst + base")],
    "first pass alone": [
        ("    ntt_dif_whole_kernel<<<(unsigned)tiles",
         "    if (p == 0) ntt_dif_whole_kernel<<<(unsigned)tiles")],
    "second pass alone": [
        ("    ntt_dif_whole_kernel<<<(unsigned)tiles",
         "    if (p == 1) ntt_dif_whole_kernel<<<(unsigned)tiles")],
    "row sets numbered first": [
        ("const unsigned row_set = blockIdx.x / groups;",
         "const unsigned row_set = blockIdx.x % (1u << (log_n - T));"),
        ("const unsigned cg = blockIdx.x % groups;",
         "const unsigned cg = blockIdx.x >> (log_n - T);")],
    "32 KB tiles": [
        ("constexpr int TILE_LOG = 14;", "constexpr int TILE_LOG = 13;"),
        ("W_BLOCKS_PER_SM = 3;", "W_BLOCKS_PER_SM = 6;"),
        ("constexpr int W_THREADS = 256;", "constexpr int W_THREADS = 128;")],
}
RAGGED_VARIANTS = {
    "as it is": [],
    "full groups, narrow last": [
        ("  const int k = (rest_n + c_max - 1) / c_max;\n"
         "  return (rest_n + k - 1) / k;",
         "  return rest_n < c_max ? rest_n : c_max;")],
    "68 KB tiles": [("constexpr int R_TILE_WORDS = 1 << 14;",
                     "constexpr int R_TILE_WORDS = 17 << 10;")],
    "4 blocks an SM": [("R_BLOCKS_PER_SM = 3;", "R_BLOCKS_PER_SM = 4;")],
    "memory only": [("int l = 0;", "int l = T;"),
                    ("if (T & 1) {", "if (false) {")],
    "loads through registers": [
        ("    for (int i = r; i < n_rows; i += R)\n"
         "      cp_async4(buf + i * w + c, src + offset + i * row_step);",
         "#pragma unroll 4\n"
         "    for (int i = r; i < n_rows; i += R)\n"
         "      buf[i * w + c] = src[offset + i * row_step];")],
    "no L2 prefetch hint": [("cp.async.ca.shared.global.L2::128B",
                             "cp.async.ca.shared.global")],
    "L2 prefetch 256 B": [("cp.async.ca.shared.global.L2::128B",
                           "cp.async.ca.shared.global.L2::256B")],
    "first pass alone": [
        ("    ntt_dif_ragged_kernel<<<(unsigned)tiles",
         "    if (p == 0) ntt_dif_ragged_kernel<<<(unsigned)tiles")],
    "second pass alone": [
        ("    ntt_dif_ragged_kernel<<<(unsigned)tiles",
         "    if (p == 1) ntt_dif_ragged_kernel<<<(unsigned)tiles")],
    "compute only": [
        ("      cp_async4(buf + i * w + c,",
         "      if (src == nullptr) cp_async4(buf + i * w + c,"),
        ("      dst[offset + i * row_step] = buf[i * w + c];",
         "      if (buf[i * w + c] == 0x92345678u)\n"
         "      dst[offset + i * row_step] = buf[i * w + c];")],
}

# radix_ntt.dif timed in a process of its own on one tree; prints one JSON
# line {"log_n x cols": [ms, digest of the output]}
TREE_TIMING = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
from valida_tpu_torch.poly import radix_ntt
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
res = {}
for log_n, cols in [(20, 51), (20, 10), (20, 128)]:
    x = torch.randint(0, 2013265921, (1 << log_n, cols), dtype=torch.int32,
                      device="cuda", generator=gen)
    y = radix_ntt.dif(x)
    for _ in range(20):
        radix_ntt.dif(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        radix_ntt.dif(x)
    end.record()
    torch.cuda.synchronize()
    res[f"{log_n} x {cols}"] = [
        start.elapsed_time(end) / 20,
        hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]]
print(json.dumps(res))
"""


def log(*args):
    print(*args, flush=True)


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def substitute(source, pairs, what):
    for old, new in pairs:
        if isinstance(old, str):
            if old not in source:
                return None
            source = source.replace(old, new)
        else:
            source, n = old.subn(new, source)
            if n == 0:
                return None
    return source


def sass_counts(lib_path):
    """{function: Counter of opcodes} from cuobjdump -sass."""
    from valida_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return out


def build(group, sources):
    """{name: source text} -> {name: path of its shared library}, one nvcc
    each, all started together; a variant that fails to build is reported
    and left out.  `group` keeps the file names of two calls apart (a
    library loaded once stays loaded under its path)."""
    from valida_tpu_torch import _build

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = os.path.join(OUT, f"{group}{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"{group}{i}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            log(f"  {name}: build failed\n{text[-2000:]}")
            continue
        used = [ln.split(":", 1)[1].strip() for ln in text.splitlines()
                if "Used" in ln]
        log(f"  built {name}: {'; '.join(used)}")
        libs[name] = so
    return libs


def rates_and_poseidon2(args, cuda_ms, rand_field, stream, sms):
    """Parts 2 and 3: integer instruction rates and the poseidon2 variants."""
    import torch

    from valida_tpu_torch.crypto import poseidon2 as p2

    dev = torch.device("cuda")
    # 2. integer instruction rates
    log("integer instruction rates:")
    micro = build("rates", {"int_rates": open(
        os.path.join(HERE, "int_rates.cu")).read()})
    lib = ctypes.CDLL(micro["int_rates"])
    lib.micro_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    names = ["mullo", "mulhi", "madwide", "mulwide", "addmin", "add", "lop",
             "shfadd", "mulp", "mulp_sh", "mulp_w", "mulp_mad"]
    counts = sass_counts(micro["int_rates"])
    blocks, threads = 2 * sms, 1024
    sink = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    cyc = torch.zeros(blocks, dtype=torch.int64, device=dev)
    for i, name in enumerate(names[:lib.micro_count()]):
        def run():
            err = lib.micro_launch(i, sink.data_ptr(), cyc.data_ptr(), blocks,
                                   threads, stream)
            if err:
                raise RuntimeError(f"micro_launch: CUDA error {err}")
        cuda_ms(run, 3)
        cycles = float(cyc.double().mean())
        steps = lib.micro_iter() * threads * 2  # chain steps an SM
        ops = [c for fn, c in counts.items() if f"k_{name}P" in fn]
        top = ", ".join(f"{k}:{v}" for k, v in
                        (ops[0].most_common(6) if ops else []))
        log(f"  {name}: {steps / cycles:.2f} chain steps per clock per SM "
            f"({cycles:.0f} cycles); kernel's SASS: {top}")

    # 3. poseidon2
    source = open(args.poseidon2_source).read()
    log(f"poseidon2 variants of {args.poseidon2_source}:")
    texts = {}
    for name, pairs in P2_VARIANTS.items():
        text = substitute(source, pairs, name)
        if text is None:
            log(f"  {name}: does not apply to this source")
        else:
            texts[name] = text
    libs = {}
    consts = np.ascontiguousarray(p2._constants_monty())
    for name, so in build("poseidon2_", texts).items():
        h = ctypes.CDLL(so)
        h.poseidon2_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
        if h.poseidon2_set_constants(consts.ctypes.data, int(consts.size)):
            raise RuntimeError("poseidon2_set_constants failed")
        libs[name] = (h, so)
    for rows, n_words in [(1 << 20, 128), (1 << 19, 16)]:
        w = rand_field((rows, n_words))
        want = p2.hash_words_plain(w) if rows * n_words <= 1 << 23 \
            else p2.hash_words(w)
        out = torch.empty(rows, 8, dtype=torch.int32, device=dev)
        for turn in range(2):
            for name, (h, _) in libs.items():
                def run():
                    err = h.poseidon2_launch(w.data_ptr(), out.data_ptr(),
                                             rows, n_words, stream)
                    if err:
                        raise RuntimeError(f"poseidon2_launch: error {err}")
                ms = cuda_ms(run)
                log(f"  poseidon2 {name}, 2^{rows.bit_length() - 1} x "
                    f"{n_words}, turn {turn}: {ms:.4f} ms, digests "
                    f"{'equal' if out.equal(want) else 'differ from'} the "
                    f"reference")
    h = libs["as it is"][0]
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(smi("clocks.sm,power.draw"))
            time.sleep(0.25)

    th = threading.Thread(target=sample)
    th.start()
    t0 = time.time()
    while time.time() - t0 < 4:
        for _ in range(20):
            h.poseidon2_launch(w.data_ptr(), out.data_ptr(), rows, n_words,
                               stream)
        torch.cuda.synchronize()
    stop.set()
    th.join()
    log("  clocks.sm, power.draw while poseidon2 loops:", samples)
    for name, (_, so) in libs.items():
        for fn, c in sass_counts(so).items():
            log(f"  SASS of {name}: {sum(c.values())} instructions: "
                + ", ".join(f"{k}:{v}" for k, v in c.most_common(12)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_experiments: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from valida_tpu_torch import _build
    from valida_tpu_torch.convert import table
    from valida_tpu_torch.poly import ntt, radix_ntt

    ap = argparse.ArgumentParser()
    ap.add_argument("--poseidon2-source",
                    default=str(_build.CSRC / "poseidon2.cu"))
    ap.add_argument("--ntt-only", action="store_true")
    ap.add_argument("--parent")
    args = ap.parse_args()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(smi("name,power.limit"))
    log("clocks.max.sm, clocks.sm idle:", smi("clocks.max.sm,clocks.sm"))

    def cuda_ms(fn, iters=10):
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

    def rand_field(shape):
        return torch.randint(0, P, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    if not args.ntt_only:
        rates_and_poseidon2(args, cuda_ms, rand_field, stream, sms)

    # 4. ntt_dif_whole
    log("ntt_dif_whole variants:")
    source = open(_build.CSRC / "ntt.cu").read()
    texts = {}
    for name, pairs in NTT_VARIANTS.items():
        text = substitute(source, pairs, name)
        if text is None:
            log(f"  {name}: does not apply to this source")
        else:
            texts[name] = text
    log_n, cols = 20, 128
    x = rand_field((1 << log_n, cols))
    pw = table(ntt._root_powers, log_n, False, device=dev)
    out = torch.empty_like(x)
    want = {t: radix_ntt.dif_passes_plain(x, log_n, False, t)
            for t in (11, 8)}
    libs = {}
    for name, so in build("ntt_", texts).items():
        h = ctypes.CDLL(so)
        h.ntt_dif_whole_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        libs[name] = h
    for turn in range(2):
        for name, h in libs.items():
            for t_max in (11, 8):
                def run():
                    err = h.ntt_dif_whole_launch(
                        x.data_ptr(), out.data_ptr(), pw.data_ptr(), log_n,
                        cols, t_max, stream)
                    if err:
                        raise RuntimeError(f"ntt_dif_whole_launch: {err}")
                ms = cuda_ms(run, 20)
                levels = "+".join(map(str, radix_ntt._pass_levels(log_n,
                                                                  t_max)))
                log(f"  ntt_dif_whole {name}, 2^{log_n} x {cols}, passes "
                    f"{levels}, turn {turn}: {ms:.4f} ms, output "
                    f"{'equals' if out.equal(want[t_max]) else 'differs from'}"
                    f" the plain version's")
    del x, out

    # 5. ntt_dif_ragged
    log("ntt_dif_ragged variants:")
    texts = {}
    for name, pairs in RAGGED_VARIANTS.items():
        text = substitute(source, pairs, name)
        if text is None:
            log(f"  {name}: does not apply to this source")
        else:
            texts[name] = text
    libs = {}
    for name, so in build("ragged_", texts).items():
        h = ctypes.CDLL(so)
        h.ntt_dif_ragged_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        libs[name] = h
    log_n = 20
    cases = []
    for cols in (51, 10):
        x = rand_field((1 << log_n, cols))
        cases.append((x, torch.empty_like(x),
                      radix_ntt.dif_passes_plain(x, log_n, False)))
    # t_max 8: passes of 7+7+6 levels, whose tiles hold whole rows
    for turn in range(2):
        for name, h in libs.items():
            for (x, out, want), t_max in itertools.product(cases, (11, 8)):
                cols = x.shape[1]

                def run():
                    err = h.ntt_dif_ragged_launch(
                        x.data_ptr(), out.data_ptr(), pw.data_ptr(), log_n,
                        cols, t_max, stream)
                    if err:
                        raise RuntimeError(f"ntt_dif_ragged_launch: {err}")
                ms = cuda_ms(run, 20)
                levels = "+".join(map(str, radix_ntt._pass_levels(log_n,
                                                                  t_max)))
                log(f"  ntt_dif_ragged {name}, 2^{log_n} x {cols}, passes "
                    f"{levels}, turn {turn}: {ms:.4f} ms, output "
                    f"{'equals' if out.equal(want) else 'differs from'}"
                    f" the plain version's")
    del cases
    log("ntt_dif_ragged by shape and t_max (ms; levels of the passes, "
        "column groups of the first; * marks radix_ntt._ragged_t_max):")
    shapes = [(20, c) for c in (10, 32, 51, 64, 79, 100, 200)]
    shapes += [(n, c) for n in (16, 17, 19) for c in (10, 51, 79)]
    for log_n, cols in shapes:
        x = rand_field((1 << log_n, cols))
        res = []
        for t_max in (11, 9, 8, 7):
            levels = radix_ntt._pass_levels(log_n, t_max)
            ms = cuda_ms(lambda: radix_ntt.dif_ragged(x, log_n, False, t_max),
                         20)
            groups = "+".join(str(w) for _, w in
                              radix_ntt._column_groups(cols, levels[0]))
            mark = "*" if levels == radix_ntt._pass_levels(
                log_n, radix_ntt._ragged_t_max(log_n, cols)) else ""
            res.append(f"t_max {t_max} {ms:.4f}{mark} "
                       f"({'+'.join(map(str, levels))}; {groups})")
        log(f"  2^{log_n} x {cols}: " + ", ".join(res))
        del x

    # 6. the parent tree against this one, in turns
    if args.parent:
        log(f"radix_ntt.dif, {args.parent} (parent) against this tree, in "
            f"turns, a process each (ms, output digest):")
        trees = [("parent", args.parent), ("this", ROOT), ("this", ROOT),
                 ("parent", args.parent)]
        for name, tree in trees:
            proc = subprocess.run([sys.executable, "-c", TREE_TIMING],
                                  cwd=tree, capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"{name} tree failed:\n{proc.stderr}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            log(f"  {name}: " + ", ".join(
                f"{k} {ms:.4f} ms ({digest})"
                for k, (ms, digest) in res.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
