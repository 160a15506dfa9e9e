"""The port's trace commit (valida_tpu_torch.commit) against the JAX
package's numpy path: the root of `__graft_entry__.entry()`'s commit, the
mixed-height PCS commit, the import rule and the no-fallback rule."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from valida_tpu.commit.fri import FriConfig
from valida_tpu.commit.pcs import TwoAdicFriPcs
from valida_tpu.crypto import keccak
from valida_tpu.crypto import merkle as rmerkle
from valida_tpu.field import babybear as bb
from valida_tpu.poly import ntt as nttm
from valida_tpu_torch.commit.fri import FriConfig as PortFriConfig
from valida_tpu_torch.commit.lde_commit import commit_forward, commit_matrices
from valida_tpu_torch.commit.pcs import TwoAdicFriPcs as PortPcs
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.crypto import merkle

REPO = Path(__file__).resolve().parent.parent


def reference_trace(log_n: int, cols: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, bb.P, size=(1 << log_n, cols), dtype=np.uint32)


def reference_commit_root(log_n: int, cols: int, seed: int = 0) -> bytes:
    """32-byte root of entry()'s commit_forward on a seeded [2^log_n, cols]
    trace, computed by the JAX package's numpy path."""
    m = bb.to_monty(reference_trace(log_n, cols, seed))
    rows = bb.from_monty(nttm.coset_lde(m, 1, bb.GENERATOR, out_bitrev=True))
    d = keccak.keccak256_words(rows)
    while d.shape[0] > 1:
        d = keccak.keccak256_words(np.concatenate([d[0::2], d[1::2]], axis=1))
    return b"".join(int(w).to_bytes(4, "little") for w in d[0])


def _hex(words) -> str:
    return b"".join(int(w).to_bytes(4, "little") for w in words).hex()


def test_commit_forward_matches_entry_root():
    """entry()'s seed-0 [2^12, 32] input: the port's root equals the
    reference's and the constant pinned in chip_smoke.py."""
    got = _hex(to_numpy(commit_forward(reference_trace(12, 32), device="cpu")))
    assert got == reference_commit_root(12, 32).hex()
    assert got == chip_smoke.GOLDEN[(12, 32)]


def test_pinned_trace_sum():
    t = reference_trace(12, 32)
    assert int(t.sum(dtype=np.uint64)) == chip_smoke.TRACE_SUMS[(12, 32)]


@pytest.mark.parametrize("log_blowup,shift", [(1, bb.GENERATOR), (2, 7)])
def test_commit_matrices_matches_pcs_commit(log_blowup, shift):
    rng = np.random.default_rng(log_blowup)
    mats = [rng.integers(0, bb.P, size=s, dtype=np.uint32)
            for s in [(32, 3), (8, 5), (32, 1), (2, 2)]]
    pcs = TwoAdicFriPcs(FriConfig(log_blowup=log_blowup), coset_shift=shift)
    want, _ = pcs.commit_batches(mats)
    got = commit_matrices(mats, log_blowup, shift, device="cpu")
    np.testing.assert_array_equal(to_numpy(got), want)
    # one commit: the PCS's, with a domain shift per matrix and either hasher
    shifts = [1, 5, bb.GENERATOR, 1]
    for hasher in ("keccak", "poseidon2"):
        pcs = TwoAdicFriPcs(FriConfig(log_blowup=log_blowup, hasher=hasher),
                            coset_shift=shift)
        want, _ = pcs.commit_batches(mats, shifts)
        got = commit_matrices(mats, log_blowup, shift, device="cpu",
                              hasher=hasher, domain_shifts=shifts)
        np.testing.assert_array_equal(to_numpy(got), want)
        port = PortPcs(PortFriConfig(log_blowup=log_blowup, hasher=hasher),
                       coset_shift=shift, device="cpu")
        np.testing.assert_array_equal(port.commit_batches(mats, shifts)[0],
                                      want)


def test_merkle_levels_match_reference_tree():
    rng = np.random.default_rng(4)
    mats = [rng.integers(0, bb.P, size=s, dtype=np.uint32)
            for s in [(16, 3), (4, 5), (16, 1), (8, 2), (1, 4)]]
    for hasher in ("keccak", "poseidon2"):
        tree = rmerkle.MerkleTree(mats, hasher=hasher)
        root, levels = merkle.merkle_levels(
            [from_reference(m) for m in mats], hasher)
        np.testing.assert_array_equal(to_numpy(root), tree.root())
        assert sorted(levels) == sorted(tree.levels)
        for k, d in levels.items():
            np.testing.assert_array_equal(to_numpy(d),
                                          np.asarray(tree.levels[k]))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "valida_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"valida_tpu_torch/field/ext.py", "valida_tpu_torch/poly/domain.py",
            "valida_tpu_torch/crypto/poseidon2.py",
            "valida_tpu_torch/crypto/p3_rng.py",
            "valida_tpu_torch/crypto/poseidon.py",
            "valida_tpu_torch/crypto/challenger.py",
            "valida_tpu_torch/commit/fri.py",
            "valida_tpu_torch/commit/pcs.py",
            "valida_tpu_torch/native/__init__.py",
            "valida_tpu_torch/native/build.py",
            "valida_tpu_torch/chips/native_field.py",
            "valida_tpu_torch/machine/compositions.py",
            "valida_tpu_torch/tooling/assembler.py",
            "valida_tpu_torch/tooling/elf.py",
            "valida_tpu_torch/tooling/repl.py",
            "valida_tpu_torch/tooling/cli.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "valida_tpu"), (f, mod)


def test_no_gpu_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = reference_trace(7, 2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        commit_forward(trace)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        commit_matrices([trace])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PortPcs(PortFriConfig(hasher="poseidon2"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PortPcs()
    assert chip_smoke.main() == 1
