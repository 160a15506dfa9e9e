"""Start ranks, the multi-device dry run of the sharded prover steps,
and a distributed prove.

    python -m valida_tpu_torch.parallel.dryrun N [--device cpu]
        [--prove LOG_CYCLES]
    torchrun --nproc-per-node N -m valida_tpu_torch.parallel.dryrun N ...

Counterpart of the sharded half of `__graft_entry__.dryrun_multichip`:
`sharded_prove_fn` over a (dp, N/dp) mesh (dp = 2 where N is even and
above 1) on its shapes (dp traces of 64 rows x 8 columns, K = 2, seed 0).
With --prove, every rank proves the ALU loop of 2^LOG_CYCLES cycles
(`machine.examples.alu_loop_program`, run by the C++ core) by
`prove_jit(mesh=make_mesh(N))` after `warmup_jit`, and the ranks' proofs
must agree.  The first form spawns N ranks itself (`run_ranks`); under
torchrun each process is one rank.  On "cuda" the kernels are built first
(`tooling/prebaked.install`), one NCCL rank per card.
"""

from __future__ import annotations

import argparse
import datetime
import gc
import hashlib
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..convert import to_numpy
from ..device import resolve
from ..field import babybear as bb
from .mesh import make_mesh, sharded_prove_fn


def _init_group(rank: int, world_size: int, device: torch.device,
                init_method: str, timeout_s: float, card: int) -> None:
    """Join the process group as `rank`: NCCL on card `card` for "cuda",
    gloo for "cpu"."""
    if device.type == "cuda":
        torch.cuda.set_device(card)
        dist.init_process_group(
            "nccl", init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=torch.device("cuda", card))
    else:
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank, fn, world_size, device, workdir, timeout_s, args):
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    _init_group(rank, world_size, dev, f"file://{workdir}/rendezvous",
                timeout_s, card=rank)
    try:
        out = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, device, *args, timeout_s: float = 300):
    """Run fn(*args) in world_size new processes, rank r of a process group
    in each (NCCL on "cuda", rank r on card r; gloo on "cpu", one torch
    thread each), and return every rank's result in rank order.  Rendezvous
    is a file in a new temporary directory.  The group's collectives time
    out after timeout_s, and the ranks are stopped and TimeoutError raised
    if they have not all ended by then.  fn must be importable by name."""
    dev = resolve(device)
    with tempfile.TemporaryDirectory() as workdir:
        ctx = mp.spawn(_rank_main, nprocs=world_size, join=False,
                       args=(fn, world_size, str(dev), workdir, timeout_s,
                             args))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                       f"still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        out = []
        for r in range(world_size):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def dryrun_multichip(n_devices: int, device="cuda"):
    """One rank's part of the dry run, in a process group of n_devices
    ranks: the global (roots [dp, 8], phi_last [dp, 5]) as np.uint32."""
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, dp=dp, device=device)
    rng = np.random.default_rng(0)
    b, n, c, k = dp, 64, 8, 2
    traces = rng.integers(0, bb.P, size=(b, n, c), dtype=np.uint32)
    q = rng.integers(0, bb.P, size=(b, n, k, 5), dtype=np.uint32)
    counts = rng.integers(0, 2, size=(b, n, k), dtype=np.uint32)
    roots, phi_last = sharded_prove_fn(mesh)(traces, q, counts)
    if tuple(roots.shape) != (b, 8) or tuple(phi_last.shape) != (b, 5):
        raise RuntimeError(f"dry run: roots {tuple(roots.shape)}, phi_last "
                           f"{tuple(phi_last.shape)}")
    return to_numpy(roots), to_numpy(phi_last)


def prove_multichip(n_devices: int, log_cycles: int, device="cuda"):
    """One rank's part of a distributed prove, in a process group of
    n_devices ranks: the ALU loop of 2^log_cycles cycles by prove_jit on a
    (1, n_devices) mesh after warmup_jit, without the debug checks ->
    (the proof's SHA-256, the warm prove's seconds)."""
    from ..core.config import default_config
    from ..core.program import ProgramROM
    from ..machine import examples, jit_prover
    from ..machine.basic import BasicMachine
    from ..tooling.serde import serialize_proof

    mesh = make_mesh(n_devices, device=device)
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM(
        examples.alu_loop_program((1 << log_cycles) // 14)))
    m.cpu().fp = 0x1000000
    m.run_native(build_lists=False)
    cfg = default_config(debug_checks=False, device=device)
    dev = resolve(device)
    try:
        jit_prover.warmup_jit(m, cfg, mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = jit_prover.prove_jit(m, cfg, mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return hashlib.sha256(serialize_proof(proof)).hexdigest(), seconds
    finally:
        # a captured collective must go before its process group
        jit_prover.release_graphs()
        gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before a collective or the run fails")
    ap.add_argument("--prove", type=int, metavar="LOG_CYCLES",
                    help="prove the ALU loop of 2^LOG_CYCLES cycles on the "
                         "mesh instead of the dry run")
    args = ap.parse_args(argv)
    if args.prove is None:
        fn, fn_args = dryrun_multichip, (args.n_devices, args.device)
    else:
        fn, fn_args = prove_multichip, (args.n_devices, args.prove,
                                        args.device)
    dev = resolve(args.device)
    if dev.type == "cuda":
        from ..tooling.prebaked import install

        install()
    if "LOCAL_RANK" in os.environ:  # torchrun: this process is one rank
        rank = int(os.environ["RANK"])
        _init_group(rank, int(os.environ["WORLD_SIZE"]), dev, "env://",
                    args.timeout, card=int(os.environ["LOCAL_RANK"]))
        try:
            results = [fn(*fn_args)]
            if args.prove is not None:  # every rank's digest, on each
                digests = [None] * dist.get_world_size()
                dist.all_gather_object(digests, results[0][0])
                results = [(d, results[0][1]) for d in digests]
        finally:
            dist.destroy_process_group()
    else:
        rank = 0
        results = run_ranks(fn, args.n_devices, dev, *fn_args,
                            timeout_s=args.timeout)
    if args.prove is not None:
        if len({d for d, _s in results}) != 1:
            print("prove: the ranks' proofs differ", file=sys.stderr)
            return 1
        if rank == 0:
            print(f"prove on {args.n_devices} {args.device} ranks: the ALU "
                  f"loop of 2^{args.prove} cycles, sha256 {results[0][0]}, "
                  f"a warm prove {max(s for _d, s in results):.3f} s")
        return 0
    roots, phi = results[0]
    if any(not (np.array_equal(r, roots) and np.array_equal(p, phi))
           for r, p in results):
        print("dry run: the ranks disagree", file=sys.stderr)
        return 1
    if rank == 0:
        print(f"dry run on {args.n_devices} {args.device} ranks: roots "
              f"{roots.tolist()}, phi_last {phi.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
