"""The port's Keccak-256 (valida_tpu_torch.crypto.keccak) against
valida_tpu.crypto.keccak: known answers, the batched numpy path, the host
mirror, the permutation, and the reference's Pallas kernel body."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from valida_tpu.crypto import keccak as ref
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.crypto import keccak


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                                dtype=np.uint32)


def _digest_bytes(words):
    return b"".join(int(w).to_bytes(4, "little") for w in words)


@pytest.mark.parametrize("words,want_hex", [
    ([], "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
    ([0], "e8e77626586f73b955364c7b4bbf0bb7f7685ebd40e852b164633a4acbd3244c"),
])
def test_known_answers(words, want_hex):
    want = bytes.fromhex(want_hex)
    assert _digest_bytes(keccak.keccak256_words_host(words)) == want
    msg = from_reference(np.asarray([words], dtype=np.uint32).reshape(1, -1))
    assert _digest_bytes(to_numpy(keccak.keccak256_words(msg))[0]) == want


@pytest.mark.parametrize("n_words", [1, 8, 33, 34, 35, 70, 128])
def test_plain_matches_reference(n_words):
    msgs = _words(n_words, (5, n_words))
    want = np.asarray(ref.keccak256_words(msgs))
    got = to_numpy(keccak.keccak256_words(from_reference(msgs)))
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(keccak.keccak256_words_host(msgs[i]),
                                      ref.keccak256_words_host(msgs[i]))


def test_pad_plan_matches_reference():
    for n_words in (0, 1, 33, 34, 35, 67, 68, 128):
        n_blocks, pad = keccak._pad_words(n_words)
        r_blocks, r_pad = ref._pad_words(n_words)
        assert n_blocks == r_blocks
        np.testing.assert_array_equal(pad, r_pad)


def test_permutation_matches_reference():
    """int64 lanes against the reference's (lo, hi) u32 halves."""
    lo = _words(1, (16, 25))
    hi = _words(2, (16, 25))
    want_lo, want_hi = ref.keccak_f(lo.copy(), hi.copy())
    lanes = torch.from_numpy(
        (lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32)))
        .view(np.int64))
    out = torch.stack(keccak.keccak_f(list(lanes.unbind(1))), dim=1)
    got = out.numpy().view(np.uint64)
    np.testing.assert_array_equal((got & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                                  want_lo)
    np.testing.assert_array_equal((got >> np.uint64(32)).astype(np.uint32),
                                  want_hi)


def _eager_pallas_call(kernel, grid, in_specs, out_specs, out_shape, **_):
    """Stand-in for pallas_call that runs the kernel body eagerly on numpy
    blocks, grid step by grid step.  Interpret mode would compile the
    ~7k-op unrolled body with XLA first, which takes well over ten minutes
    on a CPU; the body, padding, transposition and block plumbing that run
    here are the kernel's own."""
    def block(arr, spec, idx):
        starts = spec.index_map(*idx)
        return arr[tuple(slice(s * b, (s + 1) * b)
                         for s, b in zip(starts, spec.block_shape))]

    def call(*args):
        ins = [np.asarray(a) for a in args]
        out = np.zeros(out_shape.shape, dtype=out_shape.dtype)
        for idx in np.ndindex(*grid):
            kernel(*[block(a, s, idx) for a, s in zip(ins, in_specs)],
                   block(out, out_specs, idx))
        return jnp.asarray(out)

    return call


def test_plain_matches_keccak_pallas_body(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(ref, "_PB", 8)
    monkeypatch.setattr(pl, "pallas_call", _eager_pallas_call)
    msgs = _words(9, (11, 35))  # two blocks; batch padded to 16
    want = np.asarray(ref._keccak_pallas(jnp.asarray(msgs)))
    np.testing.assert_array_equal(want, ref.keccak256_words(msgs))
    got = to_numpy(keccak.keccak256_words(from_reference(msgs)))
    np.testing.assert_array_equal(got, want)
