"""The kernel entry points of the frozen copy: none.

The reference holds the port's tensors on the CPU only, where every
function runs its plain PyTorch version; the CUDA branches of the copied
modules are never reached, and reaching one is an error."""

from __future__ import annotations


def count_launch(name: str) -> None:
    raise RuntimeError(f"the reference launched the kernel {name}: it runs "
                       f"the plain versions only, on CPU tensors")


def launch(name: str, fn: str, *args) -> None:
    count_launch(name)


def check_input(t, what: str, shape=None) -> None:
    count_launch(what)
