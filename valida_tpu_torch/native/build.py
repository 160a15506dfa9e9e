"""Build the native interpreter's shared library with g++.

    python -m valida_tpu_torch.native.build

Counterpart of valida_tpu/native/build.py.  The library goes to
build/valida_tpu_torch/ beside the package, named by a hash of
interpreter.cpp and the flags, so a changed source is rebuilt and a stale
one never loads.  It is written to a temporary file and renamed into
place, so processes that build at the same moment never load a partial
file.  Nothing is built when the package is imported: `run_native`'s first
call builds.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "interpreter.cpp"
BUILD_DIR = SRC.parents[2] / "build" / "valida_tpu_torch"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libvalida_vm-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is missing; raises with
    the compiler's output if g++ fails."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
