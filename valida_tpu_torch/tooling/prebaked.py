"""Pay a cold machine's one-time build costs before a run.

    python -m valida_tpu_torch.tooling.prebaked

Counterpart of the role of valida_tpu/tooling/prebaked.py, which ships XLA
caches for the multi-device dry run.  The port compiles no graphs ahead of
time; its one-time costs are the builds of the CUDA kernels (nvcc, one
library per csrc/*.cu source, `_build.build_all`) and of the C++
interpreter core (g++, `native/build.py`).  Both go to
build/valida_tpu_torch/ under names made from a hash of the source and the
flags, so a stale artefact is never loaded: a changed source builds anew.
Nothing prebuilt is kept in the repository.
"""

from __future__ import annotations

from pathlib import Path

from .. import _build
from ..native import build as native_build


def install(dry: bool = False) -> list[tuple[Path, Path]]:
    """Build every kernel library (one nvcc per source, all started
    together) and the C++ core that are missing, and return (source, built
    library) of each.  With dry=True, build nothing and return the list."""
    items = ([(_build.CSRC / f"{name}.cu", _build._target(name))
              for name in _build.SIGNATURES]
             + [(native_build.SRC, native_build.target())])
    if not dry:
        _build.build_all()
        native_build.build()
    return items


if __name__ == "__main__":
    for src, lib in install():
        print(f"{src.name}: {lib}")
