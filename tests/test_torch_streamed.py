"""The port's streamed commit (valida_tpu_torch.commit.streamed) against the
JAX package's numpy monolithic tree: `MerkleTree([from_monty(coset_lde(x,
b, GENERATOR, out_bitrev=True))], hasher)`, root and every level, word for
word.  The JAX package's own test holds its streamed commit to that tree;
its `lde_commit_streamed` is not called here (it jit-compiles every
helper)."""

import numpy as np
import pytest
import torch

import chip_smoke
from valida_tpu.crypto.merkle import MerkleTree
from valida_tpu.field import babybear as bb
from valida_tpu.poly import ntt as nttm
from valida_tpu_torch.commit.streamed import lde_commit_streamed
from valida_tpu_torch.convert import to_numpy


def reference_tree(evals_monty: np.ndarray, log_blowup: int, hasher):
    lde = bb.from_monty(nttm.coset_lde(evals_monty, log_blowup,
                                       bb.GENERATOR, out_bitrev=True))
    return MerkleTree([np.asarray(lde)], hasher)


def sweep_input(log_n: int, cols: int) -> np.ndarray:
    """benchmarks/sweep.py's LDE input (Montgomery u32 [2^log_n, cols]):
    x = i·747796405 + 2891336453 mod 2^32, x ^= x >> 16, mod p."""
    i = np.arange((1 << log_n) * cols, dtype=np.uint32).reshape(-1, cols)
    x = i * np.uint32(747796405) + np.uint32(2891336453)
    x ^= x >> np.uint32(16)
    return bb.to_monty(x % np.uint32(bb.P))


def reference_streamed_root(log_n: int, cols: int, hasher: str) -> str:
    """Hex of the root that chip_smoke.py pins for the sweep input at
    blowup 1 (STREAMED_GOLDEN)."""
    return chip_smoke.words_hex(
        reference_tree(sweep_input(log_n, cols), 1, hasher).root())


# tests/test_pcs.py::test_streamed_commit_matches_monolithic's six cases at
# 32 x 8, and one at 2^10 x 64
CASES = [(5, 8, 1, "keccak", None, None), (5, 8, 1, "poseidon2", None, None),
         (5, 8, 2, "keccak", None, None), (5, 8, 1, "keccak", 4, None),
         (5, 8, 1, "keccak", None, 8), (5, 8, 2, "keccak", 4, 4),
         (10, 64, 1, "poseidon2", 16, 256)]


@pytest.mark.parametrize("log_n,cols,log_blowup,hasher,col_tile,row_tile",
                         CASES)
def test_streamed_matches_monolithic_tree(log_n, cols, log_blowup, hasher,
                                          col_tile, row_tile):
    rng = np.random.default_rng(11)
    x = bb.to_monty(rng.integers(0, bb.P, size=(1 << log_n, cols),
                                 dtype=np.uint32))
    want = reference_tree(x, log_blowup, hasher)
    root, levels = lde_commit_streamed(x, log_blowup, bb.GENERATOR, hasher,
                                       col_tile=col_tile, row_tile=row_tile,
                                       device="cpu")
    np.testing.assert_array_equal(root, want.root())
    assert sorted(levels) == sorted(want.levels)
    for k, lvl in want.levels.items():
        np.testing.assert_array_equal(to_numpy(levels[k]), np.asarray(lvl))


def test_streamed_sweep_input_matches_chip_smoke_generator():
    """chip_smoke's (s) makes the sweep's input on the card: the same words
    as the numpy generator here, so its pins hold for both."""
    got = chip_smoke.sweep_input(6, 64, "cpu")
    assert np.array_equal(to_numpy(got), sweep_input(6, 64))


def test_streamed_pins_match_reference_at_small_size():
    """The pin's recipe at 2^6 x 64 against the port's streamed root; the
    pinned 2^16 x 64 constants are made by the same function."""
    x = sweep_input(6, 64)
    for hasher in ("keccak", "poseidon2"):
        root, _ = lde_commit_streamed(x, 1, bb.GENERATOR, hasher,
                                      device="cpu")
        assert chip_smoke.words_hex(root) == reference_streamed_root(
            6, 64, hasher)


def test_streamed_rejects_bad_row_tile():
    x = np.zeros((32, 4), dtype=np.uint32)
    with pytest.raises(ValueError, match="row_tile"):
        lde_commit_streamed(x, 1, bb.GENERATOR, row_tile=6, device="cpu")


def test_streamed_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        lde_commit_streamed(np.zeros((32, 4), dtype=np.uint32), 1,
                            bb.GENERATOR)
