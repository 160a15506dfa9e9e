"""Build the native host library with g++: the interpreter core
(interpreter.cpp), the challenger's Poseidon permutation (poseidon.cpp),
the memory chip's sort and range-limb counts (memsort.cpp), the routing
of the memory log to the cpu's three channels (memroute.cpp) and the
proof's CBOR writer (cbor.cpp).

    python -m valida_tpu_torch.native.build

Counterpart of valida_tpu/native/build.py.  The library goes to
build/valida_tpu_torch/ beside the package, named by a hash of every
source and the flags, so a changed source is rebuilt and a stale library
never loads.  It is written to a temporary file and renamed into place, so
processes that build at the same moment never load a partial file.  Nothing is built when the package is imported: the first call of
`run_native`, of the host permutation or of `cbor_dumps` builds.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "interpreter.cpp"
POSEIDON_SRC = SRC.parent / "poseidon.cpp"
MEMSORT_SRC = SRC.parent / "memsort.cpp"
MEMROUTE_SRC = SRC.parent / "memroute.cpp"
CBOR_SRC = SRC.parent / "cbor.cpp"
BUILD_DIR = SRC.parents[2] / "build" / "valida_tpu_torch"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def sources() -> tuple[Path, Path, Path, Path, Path]:
    """The library's sources (the module's paths as they are at the call,
    so that a path replaced by a test is the one built and hashed)."""
    return SRC, POSEIDON_SRC, MEMSORT_SRC, MEMROUTE_SRC, CBOR_SRC


def target() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources():
        digest.update(hashlib.sha256(src.read_bytes()).digest())
    return BUILD_DIR / f"libvalida_vm-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is missing; raises with
    the compiler's output if g++ fails."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    srcs = [str(src) for src in sources()]
    proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), *srcs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {' '.join(srcs)}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
