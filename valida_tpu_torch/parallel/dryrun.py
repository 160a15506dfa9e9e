"""Start ranks, and the multi-device dry run of the sharded prover steps.

    python -m valida_tpu_torch.parallel.dryrun N [--device cpu]
    torchrun --nproc-per-node N -m valida_tpu_torch.parallel.dryrun N

Counterpart of the sharded half of `__graft_entry__.dryrun_multichip`:
`sharded_prove_fn` over a (dp, N/dp) mesh (dp = 2 where N is even and
above 1) on its shapes (dp traces of 64 rows x 8 columns, K = 2, seed 0).
The first form spawns N ranks itself (`run_ranks`); under torchrun each
process is one rank.  On "cuda" the kernels are built first
(`tooling/prebaked.install`), one NCCL rank per card.
"""

from __future__ import annotations

import argparse
import datetime
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before a collective or the run fails")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    if dev.type == "cuda":
        from ..tooling.prebaked import install

        install()
    if "LOCAL_RANK" in os.environ:  # torchrun: this process is one rank
        rank = int(os.environ["RANK"])
        _init_group(rank, int(os.environ["WORLD_SIZE"]), dev, "env://",
                    args.timeout, card=int(os.environ["LOCAL_RANK"]))
        try:
            results = [dryrun_multichip(args.n_devices, args.device)]
        finally:
            dist.destroy_process_group()
    else:
        rank = 0
        results = run_ranks(dryrun_multichip, args.n_devices, dev,
                            args.n_devices, args.device,
                            timeout_s=args.timeout)
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
