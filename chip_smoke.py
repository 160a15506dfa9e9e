#!/usr/bin/env python3
"""Drive valida_tpu_torch's trace commit on one CUDA GPU and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py

Builds the kernels from valida_tpu_torch/csrc with nvcc on first use, then:
1. prints the card's name and power limit;
2. builds every kernel (one nvcc per source, in parallel) and times it;
3. compares each kernel with its plain version on the card, word for word:
   ntt_dif_whole, ntt_step, ntt_tail and keccak256 at the listed shapes;
4. runs three commits through `commit_forward`, each with the launch
   counters set to 0 just before it and read just after, requires every
   kernel of that path to have launched, records every kernel call of the
   commit and holds its output against the plain version on the same
   inputs, and checks each root against the one the JAX package's numpy
   path computed:
   (a) `__graft_entry__.entry()`'s seed-0 [2^12, 32] trace,
   (b) the full-size commit, 2^19 x 128 (bench.py's shape),
   (c) 2^19 x 51, an odd width;
5. times each kernel at the main path's shapes with CUDA events, beside its
   bound and its plain version, and times the commit and the NTT;
6. prints one JSON line of kernels, then the device line last.
Any mismatch, build failure or launch error raises: the exit code is then
non-zero and the last line is not printed.  With no GPU it exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

P = 2013265921
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# 32-bit integer add, logic, shift and multiply results per clock per SM on
# compute capability 9.0 (64 INT32 units per SM: NVIDIA H100 architecture
# whitepaper; CUDA C++ Programming Guide, arithmetic instruction throughput).
# The peak is this times the SM count times the card's maximum SM clock.
INT32_OPS_PER_CLOCK_PER_SM = 64
BUTTERFLY_OPS = 10         # 32-bit ops of one radix-2 butterfly (Montgomery
                           # multiply, add, sub, reductions)
# 32-bit instructions of one Keccak-f round on 64-bit lanes kept as 32-bit
# halves, with 3-input logic (LOP3) fused: theta 80 (column parities 20,
# five 1-bit rotations 10, lane updates 50), rho 48 (24 two-word funnel
# shifts), chi 50 (one LOP3 per half), iota 2.
KECCAK_F_OPS = 24 * 180

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
    "a": ((12, 32), ("ntt_step", "ntt_tail", "keccak256")),
    "b": ((19, 128), ("ntt_dif_whole", "keccak256")),
    "c": ((19, 51), ("ntt_step", "ntt_tail", "keccak256")),
}

SOURCES = {
    "ntt_dif_whole": ("valida_tpu_torch/csrc/ntt.cu",
                      "valida_tpu/poly/mxu_ntt.py:463"),
    "ntt_step": ("valida_tpu_torch/csrc/ntt.cu",
                 "valida_tpu/poly/mxu_ntt.py:353"),
    "ntt_tail": ("valida_tpu_torch/csrc/ntt.cu",
                 "valida_tpu/poly/mxu_ntt.py:397"),
    "keccak256": ("valida_tpu_torch/csrc/keccak.cu",
                  "valida_tpu/crypto/keccak.py:212"),
}


def log(*args):
    print(*args, flush=True)


def trace(log_n, cols):
    rng = np.random.default_rng(0)
    t = rng.integers(0, P, size=(1 << log_n, cols), dtype=np.uint32)
    want = TRACE_SUMS[(log_n, cols)]
    got = int(t.sum(dtype=np.uint64))
    if got != want:
        raise RuntimeError(f"default_rng(0) trace {log_n}x{cols} differs "
                           f"from the one the golden root was made from")
    return t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from valida_tpu_torch import _build
    from valida_tpu_torch.commit.lde_commit import commit_forward
    from valida_tpu_torch.convert import table, to_numpy
    from valida_tpu_torch.crypto import keccak
    from valida_tpu_torch.poly import radix_ntt

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

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
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

    # 3. every kernel against its plain version, on the card
    max_err = dict.fromkeys(SOURCES, 0)

    def check(name, got, want, what):
        e = err(got, want)
        max_err[name] = max(max_err[name], e)
        if e != 0:
            raise RuntimeError(f"{name} differs from its plain version at "
                               f"{what}: max |diff| = {e}")

    for log_n, cols in [(14, 128), (15, 256), (20, 128)]:
        for inv in (False, True):
            x = rand_field((1 << log_n, cols))
            if log_n == 14:  # largest digits and sums: p - 1, 0x77FFFFFF
                x[::2] = P - 1
                x[1::3] = 0x77FFFFFF
            check("ntt_dif_whole", radix_ntt.dif_whole(x, log_n, inv),
                  radix_ntt.dif_whole_plain(x, log_n, inv),
                  f"({log_n}, {cols}, inverse={inv})")
    log("ntt_dif_whole == plain at (14,128) (15,256) (20,128), fwd+inv")

    for log_n, cols in [(8, 51), (12, 32), (15, 79), (20, 51)]:
        for inv in (False, True):
            x = rand_field((1 << log_n, cols))
            a = x
            for blocks, log_len, radix_log, last in radix_ntt._steps(log_n):
                if last:
                    x3 = a.reshape(blocks, 128, cols)
                    d = table(radix_ntt._tail_dft, inv, device=dev)
                    got = radix_ntt.tail(x3, d)
                    check("ntt_tail", got, radix_ntt.tail_plain(x3, d),
                          f"({log_n}, {cols}, inverse={inv})")
                else:
                    m4 = 1 << (log_len - 7)
                    x3 = a.reshape(blocks, 128, m4 * cols)
                    d = table(radix_ntt._step_dft, log_len, inv, radix_log,
                              device=dev)
                    tw = table(radix_ntt._step_twiddles, log_len, inv,
                               radix_log, device=dev)
                    got = radix_ntt.step(x3, d, tw, cols)
                    check("ntt_step", got,
                          radix_ntt.step_plain(x3, d, tw, cols),
                          f"({log_n}, {cols}, inverse={inv}, log_len "
                          f"{log_len})")
                a = got.reshape(1 << log_n, cols)
            want = radix_ntt.dif_plain(x, inv)
            if err(radix_ntt.dif(x, inv), want) or err(a, want):
                raise RuntimeError(f"dif differs at ({log_n}, {cols})")
    log("ntt_step, ntt_tail == plain through dif at (8,51) (12,32) (15,79) "
        "(20,51), fwd+inv")

    for n_words in [1, 8, 16, 32, 33, 34, 35, 51, 68, 128]:
        for batch in [1, 3, 2047, 1 << 16]:
            w = rand_words((batch, n_words))
            check("keccak256", keccak.keccak256_words(w),
                  keccak.keccak256_words_plain(w), f"({batch}, {n_words})")
    log("keccak256 == plain at n_words {1..128} x batch {1,3,2047,2^16}")

    # 4. the main path: three commits, the launch counters around each.
    # Every kernel call is recorded (its input, and its output as the kernel
    # left it) and then held against the plain version on the same input.
    # the C entries' arguments after (input, output), to the plain version
    plain_of = {
        "ntt_step": lambda x, d, tw, blocks, cols, rest_n:
            radix_ntt.step_plain(x, d, tw, rest_n),
        "ntt_tail": lambda x, d, blocks, cols: radix_ntt.tail_plain(x, d),
        "ntt_dif_whole": lambda x, scratch, mats, tws, log_n, rest_n:
            radix_ntt.dif_whole_plain(x, log_n, mats.equal(table(
                radix_ntt._whole_tables, log_n, True, device=dev)[0])),
        "keccak256": lambda w, batch, n_words:
            keccak.keccak256_words_plain(w),
    }
    calls = []
    launch = _build.launch

    def recording_launch(lib_name, fn, x, y, *rest):
        x_in = x.clone()
        launch(lib_name, fn, x, y, *rest)
        calls.append((fn.removesuffix("_launch"), x_in, y.clone(), rest))

    launches, traces = {}, {}
    for path, (shape, needed) in PATHS.items():
        t = traces[shape] = torch.from_numpy(
            trace(*shape).view(np.int32)).to(dev)
        calls.clear()
        torch.cuda.synchronize()
        _build.reset_launches()
        _build.launch = recording_launch
        root = commit_forward(t, device="cuda")
        torch.cuda.synchronize()
        _build.launch = launch
        launches[path] = dict(_build.LAUNCHES)
        log(f"commit ({path}) 2^{shape[0]} x {shape[1]} launches: "
            f"{launches[path]}")
        missing = [k for k in needed if launches[path][k] == 0]
        if missing:
            raise RuntimeError(f"commit ({path}) launched none of {missing}")
        got = b"".join(int(w).to_bytes(4, "little")
                       for w in to_numpy(root)).hex()
        if got != GOLDEN[shape]:
            raise RuntimeError(f"commit ({path}) root is {got}, the JAX "
                               f"package's is {GOLDEN[shape]}")
        log(f"commit ({path}) 2^{shape[0]} x {shape[1]}: root {got} == "
            f"JAX package's")
        seen = {}
        for name, x_in, y, rest in calls:
            check(name, y, plain_of[name](x_in, *rest),
                  f"commit ({path}) input {tuple(x_in.shape)}")
            seen.setdefault(name, []).append(tuple(x_in.shape))
        if {k: len(v) for k, v in seen.items()} != {
                k: n for k, n in launches[path].items() if n}:
            raise RuntimeError(f"commit ({path}): recorded calls do not "
                               f"match the launch counters")
        log(f"commit ({path}): all {len(calls)} kernel calls == plain, at "
            + "; ".join(f"{k} {sorted(set(v))}"
                        for k, v in sorted(seen.items())))
        calls.clear()

    # 5. timings at the main path's shapes
    kernels = []

    def report(name, fn, plain_fn, nbytes, ops, iters, plain_iters):
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(plain_fn, plain_iters)
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
    k_steps = len(radix_ntt._radix_schedule(20))
    table_bytes = k_steps * 128 * 128 * 4 + 4 * sum(
        (1 << (ll - 7)) * 128
        for _, ll, _, last in radix_ntt._steps(20) if not last)
    report("ntt_dif_whole", lambda: radix_ntt.dif_whole(x, 20, False),
           lambda: radix_ntt.dif_whole_plain(x, 20, False),
           2 * n * cols * 4 + table_bytes, n // 2 * 20 * cols * BUTTERFLY_OPS,
           10, 2)

    # ntt_step / ntt_tail: the forward DIF of commit (c), 2^20 x 51
    cols = 51
    steps = radix_ntt._steps(20)
    blocks, log_len, radix_log, _ = steps[0]
    m4 = 1 << (log_len - 7)
    x3 = rand_field((blocks, 128, m4 * cols))
    d = table(radix_ntt._step_dft, log_len, False, radix_log, device=dev)
    tw = table(radix_ntt._step_twiddles, log_len, False, radix_log, device=dev)
    report("ntt_step", lambda: radix_ntt.step(x3, d, tw, cols),
           lambda: radix_ntt.step_plain(x3, d, tw, cols),
           2 * n * cols * 4 + 128 * 128 * 4 + m4 * 128 * 4,
           n // 2 * radix_log * cols * BUTTERFLY_OPS, 10, 2)
    blocks = steps[-1][0]
    x3 = rand_field((blocks, 128, cols))
    d = table(radix_ntt._tail_dft, False, device=dev)
    report("ntt_tail", lambda: radix_ntt.tail(x3, d),
           lambda: radix_ntt.tail_plain(x3, d),
           2 * n * cols * 4 + 128 * 128 * 4,
           n // 2 * 7 * cols * BUTTERFLY_OPS, 10, 2)

    # keccak256: the leaf level of commit (b), 2^20 rows of 128 words
    rows, n_words = 1 << 20, 128
    w = rand_words((rows, n_words))
    n_blocks = n_words // 34 + 1
    report("keccak256", lambda: keccak.keccak256_words(w),
           lambda: keccak.keccak256_words_plain(w),
           rows * (n_words + 8) * 4, rows * n_blocks * KECCAK_F_OPS, 10, 1)
    log(f"keccak leaf rows/s at 2^20 x 128 words: "
        f"{rows / (kernels[-1]['ms'] / 1e3):.6g}")

    # NTT butterflies/s at 2^19 x 128, as bench.py counts them
    n, cols = 1 << 19, 128
    x = rand_field((n, cols))
    t_ntt = cuda_ms(lambda: radix_ntt.dif(x), 20) / 1e3
    t_copy = cuda_ms(lambda: x + 1, 20) / 1e3
    nbytes = n * cols * 4
    passes = (19 + 6) // 7
    frac = (passes * 2 * nbytes / t_ntt) / (2 * nbytes / t_copy)
    log(f"NTT 2^19 x 128: {n // 2 * 19 * cols / t_ntt:.6g} butterflies/s, "
        f"{t_ntt * 1e3:.4f} ms; stream copy {2 * nbytes / t_copy / 1e9:.1f} "
        f"GB/s; fraction of stream roofline {frac:.4f}")

    # commit (b) wall-clock, warm
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        commit_forward(traces[(19, 128)], device="cuda")
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    log(f"commit 2^19 x 128 wall-clock: {best * 1e3:.3f} ms (best of 3)")

    # where commit (b)'s time goes: one warm commit under torch.profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        commit_forward(traces[(19, 128)], device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    ours = {k: sum(t for name, t in by_name.items() if f"{k}_kernel(" in name)
            for k in SOURCES}
    busy = sum(by_name.values())
    log(f"commit 2^19 x 128 profile (under the profiler {wall_us / 1e3:.3f} "
        f"ms wall): device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / wall_us:.4f}; by kernel (ms): "
        + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in ours.items())
        + f", other PyTorch kernels {(busy - sum(ours.values())) / 1e3:.3f}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {t / 1e3:9.3f} ms  {name[:110]}")

    # 6. results
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
