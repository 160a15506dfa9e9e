"""The port's NTT (valida_tpu_torch.poly.ntt, .radix_ntt) against
valida_tpu.poly.ntt / mxu_ntt: transforms on the numpy path, the tables,
the pass-structured plain version of both kernels (its passes, row sets and
twiddle indices are the kernels') against the numpy stage loop and, for
ragged widths, against the reference's step and tail Pallas kernels in
interpret mode; the ragged kernel's column groups and the routing between
the two kernels.  Exact equality throughout."""

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
        for inverse in (False, True):
            got = table(ntt._root_powers, log_n, inverse, device="cpu")
            assert got.equal(from_reference(rntt._root_powers(log_n,
                                                              inverse)))
        assert table(ntt.bitrev_indices, log_n, device="cpu").equal(
            from_reference(rntt.bitrev_indices(log_n).astype(np.uint32)))
        assert table(ntt.shift_powers, 31, log_n, device="cpu").equal(
            from_reference(rntt.shift_powers(31, log_n)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("VALIDA_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VALIDA_TPU_MXU_I8", "1")


@pytest.mark.parametrize("log_n,cols,inverse", [(8, 51, False), (9, 3, True)])
def test_ragged_matches_step_and_tail_pallas(interpret, monkeypatch, log_n,
                                             cols, inverse):
    """radix_ntt.dif on a CPU tensor (the ragged kernel's plain version)
    against the reference's mxu_ntt.dif, which runs the two TPU kernels
    ntt_dif_ragged replaces, _step_pallas and _tail_pallas, in interpret
    mode."""
    ran = []
    for name in ("_step_pallas", "_tail_pallas"):
        def counted(*args, _fn=getattr(mxu_ntt, name), _name=name):
            ran.append(_name)
            return _fn(*args)
        monkeypatch.setattr(mxu_ntt, name, counted)
    x = _worst((1 << log_n, cols))
    want = np.asarray(mxu_ntt.dif(jnp.asarray(x), inverse))
    assert set(ran) == {"_step_pallas", "_tail_pallas"}
    got = radix_ntt.dif(from_reference(x), inverse)
    np.testing.assert_array_equal(to_numpy(got), want)


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


@pytest.mark.parametrize("t_max", [5, 11])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n,cols", [(11, 1), (12, 10), (13, 32), (14, 51)])
def test_ragged_plain_passes_match_numpy_path(log_n, cols, inverse, t_max):
    """The ragged kernel's plain version at the widths it serves, in one
    pass or two (t_max 11) and in three (t_max 5), against the numpy stage
    loop."""
    x, want = _whole_case(log_n, cols, inverse)
    got = radix_ntt.dif_ragged(x, log_n, inverse, t_max)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("t_max", [5, 11])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("fill", [0, P - 1])
def test_ragged_plain_passes_constant_words(fill, inverse, t_max):
    """Arrays of all 0 and all p - 1 at 2^13 x 51 go through the ragged
    passes word for word, as the kernel's check on the card runs them."""
    x = np.full((1 << 13, 51), fill, np.uint32)
    got = radix_ntt.dif_ragged(from_reference(x), 13, inverse, t_max)
    np.testing.assert_array_equal(to_numpy(got), rntt.dif(x, inverse=inverse))


@pytest.mark.parametrize("rest_n", [1, 3, 10, 32, 51, 79, 127, 200])
def test_column_groups_cover_every_column_once(rest_n):
    """At every pass size the groups cover columns 0 .. rest_n - 1 once, in
    order; all but the last share one width and the last is no wider; a
    tile fits the kernel's shared memory and a group has a thread a
    column."""
    for t in range(1, radix_ntt.T_MAX + 1):
        groups = radix_ntt._column_groups(rest_n, t)
        cols = [c0 + k for c0, w in groups for k in range(w)]
        assert cols == list(range(rest_n))
        width = groups[0][1]
        assert all(w == width for _, w in groups[:-1])
        assert 1 <= groups[-1][1] <= width
        assert width << t <= radix_ntt.TILE_WORDS
        assert width <= radix_ntt.RAGGED_THREADS
        c_max = min(radix_ntt.TILE_WORDS >> t, radix_ntt.RAGGED_THREADS)
        assert len(groups) == -(-rest_n // c_max)
    if rest_n == 51:  # 2^20 rows: two passes of 10 levels
        assert radix_ntt._column_groups(51, 10) == [(0, 13), (13, 13),
                                                    (26, 13), (39, 12)]


def test_routing_by_width():
    """Widths that are a multiple of 128 run the whole-width kernel, every
    other width the ragged one; dif on a CPU tensor is the plain passes."""
    for rest_n in (128, 256, 384, 2048, 4096):
        assert radix_ntt._pass_kernel(rest_n) is radix_ntt.dif_whole
    for rest_n in (1, 3, 10, 32, 51, 64, 79, 127, 129, 200, 4095):
        assert radix_ntt._pass_kernel(rest_n) is radix_ntt.dif_ragged
    x = from_reference(_field(3, (1 << 7, 2, 5)))
    assert radix_ntt.dif(x).equal(
        radix_ntt.dif_passes_plain(x.reshape(128, 10), 7, False)
        .reshape(x.shape))


@pytest.mark.parametrize("log_n,cols,want", [
    (20, 10, [10, 10]), (20, 32, [10, 10]), (20, 51, [7, 7, 6]),
    (20, 64, [10, 10]), (20, 79, [7, 7, 6]), (20, 200, [10, 10]),
    (19, 51, [7, 6, 6]), (17, 51, [9, 8]), (16, 79, [8, 8]), (12, 32, [6, 6]),
    (20, 1001, [10, 10])])
def test_ragged_pass_split(log_n, cols, want):
    """The ragged kernel's default split: whole-row tiles for one pass more
    where rows are no multiple of 8 words and the array outgrows the L2;
    never two passes more (1001 columns would need five)."""
    t_max = radix_ntt._ragged_t_max(log_n, cols)
    assert radix_ntt._pass_levels(log_n, t_max) == want
    if len(want) > len(radix_ntt._pass_levels(log_n, radix_ntt.T_MAX)):
        assert radix_ntt._column_groups(cols, want[0]) == [(0, cols)]
