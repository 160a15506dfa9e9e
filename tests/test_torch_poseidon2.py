"""The port's Poseidon2 hasher and its Merkle trees and openings
(valida_tpu_torch.crypto.poseidon2, .merkle) against the JAX package's
plain numpy versions, to which its own tests hold the TPU kernel: exact
equality."""

import numpy as np
import pytest
import torch

from valida_tpu.crypto import merkle as rmerkle
from valida_tpu.crypto import poseidon2 as rp2
from valida_tpu.field import babybear as rbb
from valida_tpu_torch import _build
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.crypto import merkle
from valida_tpu_torch.crypto import poseidon2 as p2

P = rbb.P
EDGES = np.array([0, P - 1, P, 2 * P - 1, 2 * P, 0xFFFFFFFF], dtype=np.uint32)


def test_constants_match_reference():
    np.testing.assert_array_equal(p2.EXTERNAL_CONSTANTS, rp2.EXTERNAL_CONSTANTS)
    np.testing.assert_array_equal(p2.INTERNAL_CONSTANTS, rp2.INTERNAL_CONSTANTS)
    np.testing.assert_array_equal(p2.INTERNAL_DIAG, rp2.INTERNAL_DIAG)
    assert (p2.WIDTH, p2.RATE, p2.EXTERNAL_ROUNDS, p2.INTERNAL_ROUNDS) == (
        rp2.WIDTH, rp2.RATE, rp2.EXTERNAL_ROUNDS, rp2.INTERNAL_ROUNDS)


def test_kernel_constants_are_the_montgomery_forms_in_order():
    flat = p2._constants_monty()
    want = np.concatenate([rp2._EXT_C_M.reshape(-1), rp2._INT_C_M,
                           rp2._DIAG_M])
    np.testing.assert_array_equal(flat, want)
    assert flat.dtype == np.uint32 and flat.size == 8 * 16 + 13 + 16


@pytest.mark.parametrize("shape", [(16,), (5, 16), (2, 3, 16)])
def test_permute(shape):
    rng = np.random.default_rng(len(shape))
    s = rng.integers(0, P, size=shape, dtype=np.uint32)
    s.reshape(-1, 16)[0, :4] = [0, 1, P - 1, rbb.R1]
    np.testing.assert_array_equal(to_numpy(p2.permute(from_reference(s))),
                                  rp2.permute(s))


def test_external_linear():
    s = np.random.default_rng(3).integers(0, P, size=(9, 16), dtype=np.uint32)
    s[0] = P - 1
    np.testing.assert_array_equal(
        to_numpy(p2._external_linear(from_reference(s))),
        rp2._external_linear(s))


@pytest.mark.parametrize("batch", [1, 3, 257])
@pytest.mark.parametrize("n_words", [1, 7, 8, 9, 10, 16, 51, 128])
def test_hash_words_plain(n_words, batch):
    rng = np.random.default_rng(1000 * n_words + batch)
    w = rng.integers(0, 1 << 32, size=(batch, n_words), dtype=np.uint32)
    flat = w.reshape(-1)
    k = min(flat.size, EDGES.size)
    flat[:k] = EDGES[:k]  # words at and above p, up to 2^32 - 1
    flat[-k:] = EDGES[:k]
    want = rp2.hash_words(w)
    t = from_reference(w)
    np.testing.assert_array_equal(to_numpy(p2.hash_words_plain(t)), want)
    # a CPU tensor takes the plain version
    np.testing.assert_array_equal(to_numpy(p2.hash_words(t)), want)
    assert want.max() < P


def test_hash_words_of_multiples_of_p_is_hash_of_zeros():
    w = np.array([[0, P, 2 * P], [0, 0, 0]], dtype=np.uint32)
    d = to_numpy(p2.hash_words(from_reference(w)))
    np.testing.assert_array_equal(d[0], d[1])


@pytest.mark.parametrize("n_words", [1, 8, 10, 16, 19])
def test_hash_words_host(n_words):
    w = np.random.default_rng(n_words).integers(0, 1 << 32, size=n_words,
                                                dtype=np.uint32)
    got = p2.hash_words_host(w)
    np.testing.assert_array_equal(got, rp2.hash_words_host(w))
    assert got.dtype == np.uint32 and got.shape == (8,)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On a CUDA tensor `hash_words` goes to the kernel's launch; only the
    input's device decides."""
    launched = []
    monkeypatch.setattr(_build, "check_input", lambda t, what: None)
    monkeypatch.setattr(p2, "_upload_constants", lambda device: None)
    monkeypatch.setattr(_build, "launch",
                        lambda *args: launched.append(args[:2]))
    monkeypatch.setattr(p2, "hash_words_plain",
                        lambda w: pytest.fail("plain version on the card"))
    before = _build.LAUNCHES["poseidon2"]
    w = torch.zeros(4, 10, dtype=torch.int32, device="meta")
    out = p2.hash_words(w)
    assert launched == [("poseidon2", "poseidon2_launch")]
    assert _build.LAUNCHES["poseidon2"] == before + 1
    assert tuple(out.shape) == (4, 8)
    _build.LAUNCHES["poseidon2"] = before


def test_build_registers_the_kernel():
    assert "poseidon2_launch" in _build.SIGNATURES["poseidon2"]
    assert "poseidon2" in _build.LAUNCHES
    src = (_build.CSRC / "poseidon2.cu").read_text()
    assert "__global__" in src and 'extern "C" int poseidon2_launch' in src


# ---------------------------------------------------------------------------
# Merkle trees, openings and their verification under both hashers
# ---------------------------------------------------------------------------

SHAPES = [(16, 3), (4, 5), (16, 1), (8, 2), (1, 4)]


def _mats(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, P, size=s, dtype=np.uint32) for s in shapes]


@pytest.mark.parametrize("hasher", ["keccak", "poseidon2"])
def test_merkle_tree_levels_and_root(hasher):
    mats = _mats(4)
    want = rmerkle.MerkleTree(mats, hasher=hasher)
    got = merkle.MerkleTree([from_reference(m) for m in mats], hasher=hasher)
    np.testing.assert_array_equal(got.root(), want.root())
    assert got.root().dtype == np.uint32
    assert got.log_max == want.log_max
    assert sorted(got.levels) == sorted(want.levels)
    for k, d in got.levels.items():
        np.testing.assert_array_equal(to_numpy(d), np.asarray(want.levels[k]))


@pytest.mark.parametrize("hasher", ["keccak", "poseidon2"])
def test_open_and_open_many_match_reference(hasher):
    mats = _mats(5)
    want = rmerkle.MerkleTree(mats, hasher=hasher)
    got = merkle.MerkleTree([from_reference(m) for m in mats], hasher=hasher)
    indices = [0, 15, 6, 6, 9]
    many = got.open_many(indices)
    assert got.open_many([]) == []
    for i, (rows, path) in zip(indices, many):
        w_rows, w_path = want.open(i)
        for opened in ((rows, path), got.open(i)):
            assert len(opened[0]) == len(w_rows)
            for a, b in zip(opened[0], w_rows):
                np.testing.assert_array_equal(a, b)
            assert len(opened[1]) == len(w_path) == want.log_max
            for a, b in zip(opened[1], w_path):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hasher", ["keccak", "poseidon2"])
def test_verify_openings_accepts_and_rejects(hasher):
    mats = _mats(6)
    dims = [m.shape for m in mats]
    tree = merkle.MerkleTree([from_reference(m) for m in mats], hasher=hasher)
    ref_tree = rmerkle.MerkleTree(mats, hasher=hasher)
    indices = [3, 12, 7]
    opened = tree.open_many(indices)
    rows_by_mat = [np.stack([rows[mi] for rows, _ in opened])
                   for mi in range(len(mats))]
    paths = np.stack([np.stack(path) for _, path in opened])
    root = tree.root()
    assert merkle.verify_openings(root, dims, indices, rows_by_mat, paths,
                                  hasher=hasher)
    # the reference's verifier accepts the port's openings, and the port's
    # the reference's
    assert rmerkle.verify_openings(root, dims, indices, rows_by_mat, paths,
                                   hasher=hasher)
    for i, (rows, path) in zip(indices, opened):
        assert merkle.verify_opening(root, dims, i, rows, path, hasher=hasher)
        r_rows, r_path = ref_tree.open(i)
        assert merkle.verify_opening(ref_tree.root(), dims, i, r_rows, r_path,
                                     hasher=hasher)
    # a changed sibling, a changed row, a wrong index and a wrong root
    bad_paths = paths.copy()
    bad_paths[1, 2, 0] ^= 1
    assert not merkle.verify_openings(root, dims, indices, rows_by_mat,
                                      bad_paths, hasher=hasher)
    bad_rows = [r.copy() for r in rows_by_mat]
    bad_rows[3][0, 1] = (bad_rows[3][0, 1] + 1) % P
    assert not merkle.verify_openings(root, dims, indices, bad_rows, paths,
                                      hasher=hasher)
    assert not merkle.verify_openings(root, dims, [3, 12, 6], rows_by_mat,
                                      paths, hasher=hasher)
    bad_root = root.copy()
    bad_root[7] ^= 1
    assert not merkle.verify_openings(bad_root, dims, indices, rows_by_mat,
                                      paths, hasher=hasher)
    rows, path = opened[0]
    bad_path = [p.copy() for p in path]
    bad_path[0][3] ^= 1
    assert not merkle.verify_opening(root, dims, indices[0], rows, bad_path,
                                     hasher=hasher)
    # the other hasher does not verify this tree
    other = "keccak" if hasher == "poseidon2" else "poseidon2"
    assert not merkle.verify_openings(root, dims, indices, rows_by_mat, paths,
                                      hasher=other)


def test_hasher_registry():
    assert merkle.get_hasher("keccak") is merkle.KECCAK
    h = merkle.get_hasher("poseidon2")
    assert h.name == "poseidon2" and merkle.get_hasher(h) is h
    assert h.hash_words is p2.hash_words
    with pytest.raises(KeyError):
        merkle.get_hasher("sha3")
    with pytest.raises(ValueError, match="power of two"):
        merkle.MerkleTree([torch.zeros(3, 2, dtype=torch.int32)])
