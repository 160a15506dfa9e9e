"""Build the CUDA sources in csrc/ with nvcc and load them through ctypes.

Each csrc/<name>.cu has a plain C interface: every pointer and the stream
are `void*`, every size an `int` (csrc/field.cu takes its sizes and
strides, csrc/constraint.cu its parameters, as a host array of int64
behind a pointer), and each entry returns
`cudaGetLastError()` as an int, or a negative code for arguments it
refuses (`REFUSALS`).  The shared library goes to
build/valida_tpu_torch/ beside the package, named by a hash of its source,
the csrc headers and the flags, so a changed source is rebuilt and a stale
one never loads.
Nothing is built or loaded when the module is imported: the first launch
builds, or `build_all()` builds every source at once, one nvcc each, all
started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "valida_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# source -> {C entry: argtypes}
SIGNATURES = {
    "ntt": {
        "ntt_dif_whole_launch": [_P, _P, _P, _I, _I, _I, _P],
        "ntt_dif_ragged_launch": [_P, _P, _P, _I, _I, _I, _P],
    },
    "keccak": {
        "keccak256_launch": [_P, _P, _I, _I, _P],
    },
    "poseidon2": {
        "poseidon2_launch": [_P, _P, _I, _I, _P],
        "poseidon2_set_constants": [_P, _I],  # host words, count: no stream
    },
    # the field kernels (K1-K4): operands, output, host layout, stream
    "field": {
        "field_elementwise_launch": [_I, _P, _P, _I, _I, _P, _P, _P],
        "field_ext_mul_launch": [_P, _P, _P, _P, _P],
        "field_inv_launch": [_P, _P, _P, _P],
        "field_ext_inv_launch": [_P, _P, _P, _P],
    },
    # a chip's quotient (air/quotient.py): program, main, prep, perm,
    # selectors, zinv, challenges, alpha, cumulative sum, output, host
    # params, stream
    "constraint": {
        "constraint_eval_launch": [_P] * 12,
    },
}

# launches of each kernel, counted by its wrapper where it launches
# (`count_launch`).  A launch being captured into a CUDA graph runs only at
# the graph's replays: it goes to CAPTURED, and each replay
# (machine/jit_prover.py) adds the launches its graph holds here and in
# GRAPH_LAUNCHES.
LAUNCHES = {"ntt_dif_whole": 0, "ntt_dif_ragged": 0, "keccak256": 0,
            "poseidon2": 0, "field_elementwise": 0, "field_ext_mul": 0,
            "field_inv": 0, "field_ext_inv": 0, "constraint_eval": 0}
CAPTURED = dict.fromkeys(LAUNCHES, 0)
GRAPH_LAUNCHES = dict.fromkeys(LAUNCHES, 0)

# what an entry refuses, by its negative return code
# (csrc/constraint.cuh `Refusal`)
REFUSALS = {-1: "a parameter out of range",
            -2: "the program and its staged rows do not fit a block's "
                "shared memory at 32 rows"}

_LIBS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        GRAPH_LAUNCHES[k] = 0


@functools.cache
def _cuda() -> bool:
    return torch.cuda.is_available()


def count_launch(name: str) -> None:
    """Count one launch of kernel `name` (see LAUNCHES)."""
    if _cuda() and torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every missing library, one nvcc process per source, all in
    parallel.  Returns {name: compiler output} for what was built; raises
    with the compiler's output if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def lib(name: str) -> ctypes.CDLL:
    handle = _LIBS.get(name)
    if handle is None:
        build_all([name])
        handle = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = handle
    return handle


def launch(name: str, fn: str, *args) -> None:
    """Call C entry `fn` of csrc/<name>.cu on the current stream: tensors
    pass as device pointers, None as a null pointer, ints as ints."""
    conv = []
    for a in args:
        if isinstance(a, torch.Tensor):
            conv.append(a.data_ptr())
        else:
            conv.append(a)
    stream = torch.cuda.current_stream().cuda_stream
    raise_for(fn, getattr(lib(name), fn)(*conv, stream))


def raise_for(fn: str, err: int) -> None:
    """Raise for entry `fn`'s return code: ValueError for a refusal,
    RuntimeError for a CUDA error."""
    if err < 0:
        raise ValueError(f"{fn}: {REFUSALS.get(err, f'refused ({err})')}")
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err}")


def check_input(t: torch.Tensor, what: str, shape=None) -> None:
    """Raise unless `t` is a contiguous int32 CUDA tensor (of `shape`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
