"""The port's BabyBear field ops (valida_tpu_torch.field.babybear) against
valida_tpu.field.babybear on numpy arrays: exact equality, edge values
0, 1 and p - 1 included."""

import numpy as np
import pytest

from valida_tpu.field import babybear as ref
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.field import babybear as bb

P = ref.P


def _operands(seed, n=4096):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=n, dtype=np.uint32)
    b = rng.integers(0, P, size=n, dtype=np.uint32)
    edges = np.array([0, 1, P - 1, P - 2, 2, ref.R1, 0x77FFFFFF],
                     dtype=np.uint32)
    a = np.concatenate([a, np.repeat(edges, len(edges))])
    b = np.concatenate([b, np.tile(edges, len(edges))])
    return a, b


def test_constants_match_reference():
    assert (bb.P, bb.TWO_ADICITY, bb.GENERATOR, bb.MONTY_MU, bb.R1, bb.R2) == (
        ref.P, ref.TWO_ADICITY, ref.GENERATOR, ref.MONTY_MU, ref.R1, ref.R2)
    assert bb.TWO_ADIC_GENERATORS == ref.TWO_ADIC_GENERATORS
    for k in range(ref.TWO_ADICITY + 1):
        assert bb.two_adic_generator(k) == ref.two_adic_generator(k)
    for x in [0, 1, 2, 31, P - 1, 123456789]:
        assert bb.to_monty_int(x) == ref.to_monty_int(x)
        assert bb.h_mul(x, 77) == ref.h_mul(x, 77)
        if x:
            assert bb.h_inv(x) == ref.h_inv(x)


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_ops(op):
    a, b = _operands(1)
    want = getattr(ref, op)(a, b)
    got = to_numpy(getattr(bb, op)(from_reference(a), from_reference(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["neg", "to_monty", "from_monty"])
def test_unary_ops(op):
    a, _ = _operands(2)
    want = getattr(ref, op)(a)
    got = to_numpy(getattr(bb, op)(from_reference(a)))
    np.testing.assert_array_equal(got, want)


def test_outputs_are_int32():
    a = from_reference(_operands(3)[0])
    for out in (bb.mul(a, a), bb.add(a, a), bb.sub(a, a), bb.neg(a),
                bb.to_monty(a), bb.from_monty(a)):
        assert out.dtype == a.dtype


WRAPPED = np.array([0, 1, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2 * P + 1,
                    0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)


@pytest.mark.parametrize("value", [int(v) for v in WRAPPED])
def test_from_wrapped_u32_edges(value):
    x = np.array([value], dtype=np.uint32)
    got = to_numpy(bb.from_wrapped_u32(from_reference(x)))
    np.testing.assert_array_equal(got, ref.from_wrapped_u32(x))
    assert int(got[0]) == (value % P << 32) % P


def test_from_wrapped_u32_random():
    x = np.random.default_rng(5).integers(0, 1 << 32, size=4096,
                                          dtype=np.uint32)
    np.testing.assert_array_equal(
        to_numpy(bb.from_wrapped_u32(from_reference(x))),
        ref.from_wrapped_u32(x))


def test_double():
    a, _ = _operands(6)
    np.testing.assert_array_equal(to_numpy(bb.double(from_reference(a))),
                                  ref.double(a))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 255, P - 2, P - 1])
def test_exp(e):
    a, _ = _operands(7, n=64)
    np.testing.assert_array_equal(to_numpy(bb.exp(from_reference(a), e)),
                                  ref.exp(a, e))


def test_inv_maps_zero_to_zero_and_inverts():
    a, _ = _operands(8, n=256)
    got = bb.inv(from_reference(a))
    np.testing.assert_array_equal(to_numpy(got), ref.inv(a))
    prod = to_numpy(bb.mul(got, from_reference(a)))
    np.testing.assert_array_equal(prod, np.where(a == 0, 0, ref.R1))


@pytest.mark.parametrize("shape", [(1,), (2,), (3,), (5, 7), (64,), (100,),
                                   (257,), (4, 3, 5)])
def test_inv_batch(shape):
    rng = np.random.default_rng(int(np.prod(shape)))
    a = rng.integers(0, P, size=shape, dtype=np.uint32)
    a.reshape(-1)[::3] = 0  # zeros, the first element among them
    want = ref.inv_batch(a)
    got = to_numpy(bb.inv_batch(from_reference(a)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.inv(a))


def test_host_helpers_match_reference():
    for x, y in [(0, 0), (1, P - 1), (P - 1, P - 1), (123456789, 987654321)]:
        assert bb.h_add(x, y) == ref.h_add(x, y)
        assert bb.h_sub(x, y) == ref.h_sub(x, y)
        assert bb.h_exp(x, y) == ref.h_exp(x, y)
        assert bb.monty_scalar(x) == ref.monty_scalar(x)
        assert bb.from_monty_int(x) == ref.from_monty_int(x)
    assert (bb.ONE, bb.ZERO) == (ref.ONE, ref.ZERO)
