"""The port's degree-5 extension (valida_tpu_torch.field.ext), its domain
helpers and `eval_at_ext_point` against the JAX package on numpy arrays:
exact equality."""

import numpy as np
import pytest

from valida_tpu.field import babybear as rbb
from valida_tpu.field import ext as rext
from valida_tpu.poly import domain as rdomain
from valida_tpu.poly import ntt as rntt
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.field import ext as extf
from valida_tpu_torch.poly import domain
from valida_tpu_torch.poly import ntt as nttm

P = rbb.P


def _ext_array(seed, shape=(37,)):
    """Montgomery ext array with some zero, one and p - 1 entries."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=shape + (5,), dtype=np.uint32)
    flat = a.reshape(-1, 5)
    flat[0] = 0
    flat[1] = [rbb.R1, 0, 0, 0, 0]
    flat[2] = P - 1
    flat[3, 1:] = 0
    return a


def _scalar(seed):
    rng = np.random.default_rng(seed)
    return tuple(int(v) for v in rng.integers(0, P, size=5))


@pytest.mark.parametrize("op", ["ext_add", "ext_sub", "ext_mul"])
def test_binary(op):
    a, b = _ext_array(1), _ext_array(2)
    got = getattr(extf, op)(from_reference(a), from_reference(b))
    np.testing.assert_array_equal(to_numpy(got), getattr(rext, op)(a, b))


def test_ext_mul_broadcasts_one_scalar():
    a, b = _ext_array(3, (6, 4)), _ext_array(4, (4,))[3]
    want = rext.ext_mul(a, np.broadcast_to(b, a.shape))
    got = extf.ext_mul(from_reference(a), from_reference(b))
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("op", ["ext_neg", "frobenius", "ext_inv",
                                "ext_one_like"])
def test_unary(op):
    a = _ext_array(5)
    got = getattr(extf, op)(from_reference(a))
    np.testing.assert_array_equal(to_numpy(got), getattr(rext, op)(a))


def test_ext_inv_times_self_is_one():
    a = _ext_array(6)
    t = from_reference(a)
    prod = to_numpy(extf.ext_mul(t, extf.ext_inv(t)))
    one = np.zeros_like(a)
    one[..., 0] = rbb.R1
    one[0] = 0  # the zero element has no inverse: 0 -> 0
    np.testing.assert_array_equal(prod, one)


@pytest.mark.parametrize("scalar_axis", [False, True])
def test_ext_scale_and_mul_base(scalar_axis):
    a = _ext_array(7)
    s = np.random.default_rng(8).integers(0, P, size=a.shape[:-1],
                                          dtype=np.uint32)
    np.testing.assert_array_equal(
        to_numpy(extf.ext_mul_base(from_reference(a), from_reference(s))),
        rext.ext_mul_base(a, s))
    s_in = s[..., None] if scalar_axis else s
    np.testing.assert_array_equal(
        to_numpy(extf.ext_scale(from_reference(a), from_reference(s_in))),
        rext.ext_scale(a, s_in))


@pytest.mark.parametrize("e", [0, 1, 5, 1000003])
def test_ext_exp(e):
    a = _ext_array(9, (9,))
    np.testing.assert_array_equal(
        to_numpy(extf.ext_exp(from_reference(a), e)), rext.ext_exp(a, e))


def test_ext_from_base_and_const():
    s = np.random.default_rng(10).integers(0, P, size=(3, 4), dtype=np.uint32)
    np.testing.assert_array_equal(
        to_numpy(extf.ext_from_base(from_reference(s))), rext.ext_from_base(s))
    z = _scalar(11)
    np.testing.assert_array_equal(
        to_numpy(extf.ext_const(z, "cpu")),
        rbb.to_monty(np.array(z, dtype=np.uint32)))


def test_host_tuples_match_reference_and_device():
    a, b = _scalar(12), _scalar(13)
    for op in ("e_add", "e_sub", "e_mul"):
        assert getattr(extf, op)(a, b) == getattr(rext, op)(a, b)
    assert extf.e_neg(a) == rext.e_neg(a)
    assert extf.e_scale(a, 12345) == rext.e_scale(a, 12345)
    assert extf.e_from_base(P + 3) == rext.e_from_base(P + 3)
    assert extf.e_exp(a, 77) == rext.e_exp(a, 77)
    assert extf.e_inv(a) == rext.e_inv(a)
    assert extf.e_powers(a, 9) == rext.e_powers(a, 9)
    assert (extf.E_ZERO, extf.E_ONE, extf.D, extf.W) == (
        rext.E_ZERO, rext.E_ONE, rext.D, rext.W)
    # the device product of two constants is the host product
    prod = extf.ext_mul(extf.ext_const(a, "cpu"), extf.ext_const(b, "cpu"))
    np.testing.assert_array_equal(
        to_numpy(prod), rbb.to_monty(np.array(extf.e_mul(a, b), np.uint32)))


@pytest.mark.parametrize("seed", [14, 15, 16])
def test_e_inv_times_self_is_one(seed):
    a = _scalar(seed)
    assert extf.e_mul(a, extf.e_inv(a)) == extf.E_ONE


@pytest.mark.parametrize("log_n,shift", [(0, 1), (3, 1), (5, 31), (8, 7)])
def test_coset_points(log_n, shift):
    want = rdomain.coset_points(log_n, shift)
    np.testing.assert_array_equal(domain.coset_points(log_n, shift), want)
    np.testing.assert_array_equal(
        to_numpy(domain.coset_points_device(log_n, shift, "cpu")), want)


@pytest.mark.parametrize("log_n,log_blowup,shift", [(3, 1, 31), (4, 2, 7)])
def test_zerofier_on_coset(log_n, log_blowup, shift):
    got = domain.ZerofierOnCoset(log_n, log_blowup, shift)
    want = rdomain.ZerofierOnCoset(log_n, log_blowup, shift)
    np.testing.assert_array_equal(got.zerofier_evals(), want.zerofier_evals())
    np.testing.assert_array_equal(got.zerofier_inv_evals(),
                                  want.zerofier_inv_evals())
    for i in (0, (1 << log_n) - 1):
        np.testing.assert_array_equal(got.lagrange_basis_unnormalized(i),
                                      want.lagrange_basis_unnormalized(i))


@pytest.mark.parametrize("n,cols", [(1, 3), (8, 1), (64, 5), (100, 7)])
def test_eval_at_ext_point_and_mod_sum(n, cols):
    rng = np.random.default_rng(n)
    coeffs = rng.integers(0, P, size=(n, cols), dtype=np.uint32)
    coeffs[0] = P - 1
    zp = rng.integers(0, P, size=(n, 5), dtype=np.uint32)
    want = rntt.eval_at_ext_point(coeffs, zp)
    got = nttm.eval_at_ext_point(from_reference(coeffs), from_reference(zp))
    np.testing.assert_array_equal(to_numpy(got), want)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            to_numpy(nttm._mod_sum(from_reference(coeffs), axis)),
            rntt._mod_sum(coeffs, axis))


def test_ext_scalar_matches_reference():
    """`ExtScalar`, the host scalar's type: a 5-tuple of canonical ints."""
    assert extf.ExtScalar is rext.ExtScalar is tuple
    a, b = _scalar(11), _scalar(12)
    for got in (extf.e_mul(a, b), extf.e_inv(a), extf.e_add(a, b)):
        assert isinstance(got, extf.ExtScalar) and len(got) == 5
        assert all(0 <= x < P for x in got)
