"""valida_tpu_torch.tooling.prebaked: the list of what `install` builds
(every kernel source and the C++ interpreter core), without building."""

from valida_tpu_torch import _build
from valida_tpu_torch.native import build as native_build
from valida_tpu_torch.tooling import prebaked


def test_install_dry_lists_every_kernel_source_and_the_core():
    items = prebaked.install(dry=True)
    sources = {src for src, _lib in items}
    assert sources == set(_build.CSRC.glob("*.cu")) | {native_build.SRC}
    for src, lib in items:
        assert lib.parent == _build.BUILD_DIR
        assert lib.name.startswith(f"lib{src.stem}-"
                                   if src.suffix == ".cu" else "libvalida_vm-")


def test_install_dry_builds_nothing(monkeypatch):
    def refuse(*_args, **_kwargs):
        raise AssertionError("dry install built something")

    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(native_build, "build", refuse)
    assert len(prebaked.install(dry=True)) == len(_build.SIGNATURES) + 1


def test_the_listed_core_builds_with_gpp():
    """The C++ core's entry names the library that g++ builds here."""
    core = prebaked.install(dry=True)[-1][1]
    assert native_build.build() == core and core.exists()
