"""The port's NTT (valida_tpu_torch.poly.ntt, .radix_ntt) against
valida_tpu.poly.ntt / mxu_ntt: transforms on the numpy path, the step
tables, and the plain versions of the step, tail and whole-transform
kernels against the reference's Pallas kernels in interpret mode.
Exact equality throughout."""

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
            if log_n >= 14:  # the whole transform's tables, in step order
                mats, tws = table(radix_ntt._whole_tables, log_n, inverse,
                                  device="cpu")
                steps = radix_ntt._steps(log_n)
                want_mats = [mxu_ntt._tail_dft(inverse) if last else
                             mxu_ntt._step_dft(ll, inverse, r)
                             for _, ll, r, last in steps]
                want_tws = [np.asarray(mxu_ntt._step_twiddles(ll, inverse, r))
                            .reshape(-1) for _, ll, r, last in steps
                            if not last]
                assert mats.equal(from_reference(np.stack(want_mats)))
                assert tws.equal(from_reference(np.concatenate(want_tws)))
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
