"""The port's NTT (valida_tpu_torch.poly.ntt, .radix_ntt) against
valida_tpu.poly.ntt / mxu_ntt: transforms on the numpy path, the step
tables, the plain versions of the step and tail kernels against the
reference's Pallas kernels in interpret mode, and the pass-structured plain
version of the whole-transform kernel (its passes, row sets and twiddle
indices are the kernel's) against the numpy stage loop.  Exact equality
throughout."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp

from valida_tpu.field import babybear as rbb
from valida_tpu.poly import mxu_ntt
from valida_tpu.poly import ntt as rntt
from valida_tpu_torch.convert import from_reference, table, to_numpy
from valida_tpu_torch.poly import ntt, radix_ntt

P = rbb.P


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint32)


def _worst(shape):
    """Largest digits and sums: p - 1 and 0x77FFFFFF between random rows."""
    x = _field(5, shape)
    x[::2] = P - 1
    x[1::3] = 0x77FFFFFF
    return x


@pytest.mark.parametrize("log_n", range(1, 15))
@pytest.mark.parametrize("fn", ["dif", "dit"])
def test_dif_dit_match_reference(fn, log_n):
    x = _field(log_n, (1 << log_n, 3))
    for inverse in (False, True):
        want = getattr(rntt, fn)(x, inverse=inverse)
        got = to_numpy(getattr(ntt, fn)(from_reference(x), inverse))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n", range(1, 15))
def test_intt_matches_reference(log_n):
    x = rbb.to_monty(_field(100 + log_n, (1 << log_n, 3)))
    np.testing.assert_array_equal(to_numpy(ntt.intt(from_reference(x))),
                                  rntt.intt(x))


@pytest.mark.parametrize("log_n", range(1, 15))
def test_coset_lde_matches_reference(log_n):
    x = rbb.to_monty(_field(200 + log_n, (1 << log_n, 3)))
    for bitrev in (False, True):
        want = rntt.coset_lde(x, 1, rbb.GENERATOR, out_bitrev=bitrev)
        got = ntt.coset_lde(from_reference(x), 1, rbb.GENERATOR,
                            out_bitrev=bitrev)
        np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("shape", [(1 << 10, 1), (1 << 10, 51), (1 << 9, 2, 3),
                                   (1 << 7, 79)])
def test_odd_widths_all_transforms(shape):
    x = rbb.to_monty(_field(7, shape))
    t = from_reference(x)
    np.testing.assert_array_equal(to_numpy(ntt.ntt(t)), rntt.ntt(x))
    np.testing.assert_array_equal(to_numpy(ntt.coset_intt(t, 7)),
                                  rntt.coset_intt(x, 7))
    np.testing.assert_array_equal(
        to_numpy(ntt.coset_eval_from_coeffs(t, 31)),
        rntt.coset_eval_from_coeffs(x, 31))
    np.testing.assert_array_equal(to_numpy(ntt.coset_lde(t, 2, 31)),
                                  rntt.coset_lde(x, 2, 31))


@pytest.mark.parametrize("log_n,cols", [(7, 4), (8, 51), (9, 3), (12, 32),
                                        (15, 79)])
def test_radix_dif_matches_reference(log_n, cols):
    x = _field(log_n * cols, (1 << log_n, cols))
    for inverse in (False, True):
        want = rntt.dif(x, inverse=inverse)
        got = radix_ntt.dif(from_reference(x), inverse)
        np.testing.assert_array_equal(to_numpy(got), want)


def test_tables_match_reference():
    for log_n in (7, 9, 14, 19):
        assert radix_ntt._radix_schedule(log_n) == mxu_ntt._radix_schedule(log_n)
        for inverse in (False, True):
            pairs = [(ntt._root_powers, rntt._root_powers, (log_n, inverse))]
            for _, log_len, radix_log, last in radix_ntt._steps(log_n):
                if not last:
                    args = (log_len, inverse, radix_log)
                    pairs += [(radix_ntt._step_dft, mxu_ntt._step_dft, args),
                              (radix_ntt._step_twiddles,
                               mxu_ntt._step_twiddles, args)]
            pairs.append((radix_ntt._tail_dft, mxu_ntt._tail_dft, (inverse,)))
            for mine, theirs, args in pairs:
                got = table(mine, *args, device="cpu")
                assert got.equal(from_reference(theirs(*args))), (mine, args)
        assert table(ntt.bitrev_indices, log_n, device="cpu").equal(
            from_reference(rntt.bitrev_indices(log_n).astype(np.uint32)))
        assert table(ntt.shift_powers, 31, log_n, device="cpu").equal(
            from_reference(rntt.shift_powers(31, log_n)))


def test_mega_supported_matches_reference():
    for log_n in (13, 14, 19):
        for rest_n in (51, 64, 120, 128, 256, 2048, 4096):
            assert (radix_ntt._mega_supported(log_n, rest_n)
                    == mxu_ntt._mega_supported(log_n, rest_n))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("VALIDA_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VALIDA_TPU_MXU_I8", "1")


@pytest.mark.parametrize("log_len,radix_log,rest_n", [(8, 1, 4), (9, 2, 3)])
def test_step_plain_matches_step_pallas(interpret, log_len, radix_log, rest_n):
    n = 1 << log_len
    m4 = n // 128
    x = _worst((n, rest_n))
    tm = mxu_ntt._step_tile(m4, rest_n)
    want = np.asarray(mxu_ntt._step_pallas(jnp.asarray(x), 1, log_len, False,
                                           rest_n, radix_log, tm))
    d = table(radix_ntt._step_dft, log_len, False, radix_log, device="cpu")
    tw = table(radix_ntt._step_twiddles, log_len, False, radix_log,
               device="cpu")
    got = radix_ntt.step(from_reference(x).reshape(1, 128, m4 * rest_n), d, tw,
                         rest_n)
    np.testing.assert_array_equal(to_numpy(got).reshape(n, rest_n),
                                  want.reshape(n, rest_n))


@pytest.mark.parametrize("blocks,rest_n,inverse", [(2, 4, False), (4, 3, True)])
def test_tail_plain_matches_tail_pallas(interpret, blocks, rest_n, inverse):
    x = _worst((blocks * 128, rest_n))
    want = np.asarray(mxu_ntt._tail_pallas(jnp.asarray(x), blocks, inverse,
                                           rest_n))
    d = table(radix_ntt._tail_dft, inverse, device="cpu")
    got = radix_ntt.tail(from_reference(x).reshape(blocks, 128, rest_n), d)
    np.testing.assert_array_equal(to_numpy(got).reshape(x.shape),
                                  want.reshape(x.shape))


@pytest.mark.parametrize("inverse", [False, True])
def test_whole_plain_matches_numpy_path(inverse):
    """The reference cannot run its whole-transform kernel in interpret
    mode, so the plain version is held against the numpy stage loop."""
    x = _worst((1 << 14, 128))
    got = radix_ntt.dif_whole(from_reference(x), 14, inverse)
    np.testing.assert_array_equal(to_numpy(got), rntt.dif(x, inverse=inverse))


@functools.lru_cache(maxsize=None)
def _whole_case(log_n, cols, inverse):
    """(input tensor, the numpy stage loop's transform of it)"""
    x = _field(1000 * log_n + cols + inverse, (1 << log_n, cols))
    return from_reference(x), rntt.dif(x, inverse=inverse)


@pytest.mark.parametrize("t_max", [5, 6, 7, 8, 10, 11])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n,cols", [(14, 128), (15, 128), (16, 128),
                                        (14, 256)])
def test_whole_plain_passes_match_numpy_path(log_n, cols, inverse, t_max):
    """Every split into passes gives the numpy path's words: t_max 5 and 6
    make three passes (four at log_n 16 and t_max 5), 7 two or three, 8
    and above two; [5,5,4], [8,7] and [6,5,5] are uneven."""
    x, want = _whole_case(log_n, cols, inverse)
    got = radix_ntt.dif_whole(x, log_n, inverse, t_max)
    np.testing.assert_array_equal(to_numpy(got), want)


@functools.lru_cache(maxsize=None)
def _extreme_case(kind, inverse):
    """(input tensor, the numpy stage loop's transform of it) at 2^14 x 128
    for words that break an unproved lazy reduction."""
    shape = (1 << 14, 128)
    x = {"zeros": lambda: np.zeros(shape, np.uint32),
         "p-1": lambda: np.full(shape, P - 1, np.uint32),
         "worst": lambda: _worst(shape)}[kind]()
    return from_reference(x), rntt.dif(x, inverse=inverse)


@pytest.mark.parametrize("t_max", [5, 7, 11])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["zeros", "p-1", "worst"])
def test_whole_plain_passes_extreme_words(kind, inverse, t_max):
    """Arrays of all 0, all p - 1, and p - 1 and 0x77FFFFFF between random
    rows go through every pass structure word for word, as the kernel's
    check on the card runs them."""
    x, want = _extreme_case(kind, inverse)
    got = radix_ntt.dif_whole(x, 14, inverse, t_max)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("log_n,t_max,want", [
    (14, 11, [7, 7]), (15, 11, [8, 7]), (19, 11, [10, 9]), (20, 11, [10, 10]),
    (21, 11, [11, 10]), (22, 11, [11, 11]), (23, 11, [8, 8, 7]),
    (14, 5, [5, 5, 4]), (16, 6, [6, 5, 5]), (20, 8, [7, 7, 6]), (9, 11, [9])])
def test_pass_levels(log_n, t_max, want):
    got = radix_ntt._pass_levels(log_n, t_max)
    assert got == want
    assert sum(got) == log_n and max(got) <= t_max


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n,t_max", [(14, 11), (15, 11), (16, 6), (12, 5)])
def test_pass_twiddles_are_the_root_powers(log_n, t_max, inverse):
    """The table the kernel reads is the reference's _root_powers, and the
    pass's index formula picks w^((j mod h) << s) for the global row j of
    tile row i in the row set `low`: j = i * S + low (+ hi << (log_n - s0),
    which j mod h drops), h = n >> (s + 1), s = s0 + lv."""
    pw = table(ntt._root_powers, log_n, inverse, device="cpu")
    assert pw.equal(from_reference(rntt._root_powers(log_n, inverse)))
    w = rbb.two_adic_generator(log_n)
    if inverse:
        w = rbb.h_inv(w)
    rng = np.random.default_rng(log_n)
    s0 = 0
    for t in radix_ntt._pass_levels(log_n, t_max):
        stride = 1 << (log_n - s0 - t)
        for lv in range(t):
            idx = radix_ntt._pass_twiddle_index(log_n, s0, t, lv, "cpu")
            hl = 1 << (t - 1 - lv)
            assert tuple(idx.shape) == (hl, stride)
            assert int(idx.max()) < 1 << (log_n - 1)
            s = s0 + lv
            h = (1 << log_n) >> (s + 1)
            for _ in range(8):
                i = int(rng.integers(0, 1 << t))
                low = int(rng.integers(0, stride))
                j = i * stride + low
                e = int(idx[i % hl, low])
                assert e == (j % h) << s
                assert int(pw[e]) == pow(w, e, P) * (1 << 32) % P
        s0 += t
