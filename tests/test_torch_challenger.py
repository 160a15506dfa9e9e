"""The port's Fiat-Shamir layer (valida_tpu_torch.crypto.p3_rng, .poseidon,
.challenger) against the JAX package's: same constants for every
parameter set, same permutations, same transcript."""

import numpy as np
import pytest

from valida_tpu.crypto import challenger as rchallenger
from valida_tpu.crypto import p3_rng as rp3
from valida_tpu.crypto import poseidon as rposeidon
from valida_tpu.field import babybear as rbb
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.crypto import challenger, p3_rng, poseidon

P = rbb.P
PARAM_SETS = ["p3rng", "p3rng:canonical-ff-jm", "sha256"]


@pytest.fixture
def param_set(request):
    """Switch both packages to one parameter set, and back afterwards."""
    before = (poseidon.PARAM_SET, rposeidon.PARAM_SET)
    poseidon.set_param_set(request.param)
    rposeidon.set_param_set(request.param)
    yield request.param
    poseidon.set_param_set(before[0])
    rposeidon.set_param_set(before[1])


def test_defaults_match_reference():
    assert poseidon.PARAM_SET == rposeidon.PARAM_SET
    assert (poseidon.WIDTH, poseidon.ALPHA, poseidon.HALF_FULL_ROUNDS,
            poseidon.PARTIAL_ROUNDS, poseidon.NUM_ROUNDS, poseidon.SEED) == (
        rposeidon.WIDTH, rposeidon.ALPHA, rposeidon.HALF_FULL_ROUNDS,
        rposeidon.PARTIAL_ROUNDS, rposeidon.NUM_ROUNDS, rposeidon.SEED)
    assert p3_rng.P3RNG_VARIANTS == rp3.P3RNG_VARIANTS
    assert p3_rng.P3RNG_DEFAULT_VARIANT == rp3.P3RNG_DEFAULT_VARIANT


@pytest.mark.parametrize("variant", rp3.P3RNG_VARIANTS)
def test_p3rng_streams(variant):
    assert p3_rng.p3rng_params(480, variant) == rp3.p3rng_params(480, variant)


def test_p3rng_chain_pieces():
    """The pieces of the chain, each against the reference's."""
    a, b = p3_rng.SipHasher(1, 2, 2, 4), rp3.SipHasher(1, 2, 2, 4)
    for h in (a, b):
        h.write(bytes(range(15)))
        h.write_u8(7)
        h.write(b"abc")
    assert a.finish() == b.finish()
    ra, rb = p3_rng.Pcg64.new(42, 54), rp3.Pcg64.new(42, 54)
    assert [ra.next_u64() for _ in range(6)] == [rb.next_u64()
                                                 for _ in range(6)]
    assert p3_rng.seeder_pcg64().next_u32() == rp3.seeder_pcg64().next_u32()
    assert p3_rng.coset_mds_matrix(8, "jm") == rp3.coset_mds_matrix(8, "jm")
    with pytest.raises(ValueError):
        p3_rng.Pcg64.from_seed(b"short")


@pytest.mark.parametrize("param_set", PARAM_SETS, indirect=True)
def test_constants(param_set):
    rc, mds = poseidon._build_params(param_set)
    want_rc, want_mds = rposeidon._build_params(param_set)
    np.testing.assert_array_equal(rc, want_rc)
    np.testing.assert_array_equal(mds, want_mds)
    np.testing.assert_array_equal(poseidon.ROUND_CONSTANTS,
                                  rposeidon.ROUND_CONSTANTS)
    np.testing.assert_array_equal(poseidon.MDS, rposeidon.MDS)
    assert poseidon.PARAM_SET == param_set


def test_unknown_param_set_raises():
    with pytest.raises(ValueError):
        poseidon._build_params("md5")


@pytest.mark.parametrize("param_set", PARAM_SETS, indirect=True)
def test_permute_host(param_set):
    rng = np.random.default_rng(1)
    for state in ([0] * 16, [P - 1] * 16,
                  [int(v) for v in rng.integers(0, P, size=16)]):
        got = poseidon.permute_host(state)
        np.testing.assert_array_equal(got, rposeidon.permute_host(state))
        assert got.dtype == np.uint64


@pytest.mark.parametrize("param_set", PARAM_SETS, indirect=True)
def test_permute_device(param_set):
    rng = np.random.default_rng(2)
    canon = rng.integers(0, P, size=(7, 16), dtype=np.uint32)
    canon[0] = 0
    canon[1] = P - 1
    s = rbb.to_monty(canon)
    got = to_numpy(poseidon.permute_device(from_reference(s)))
    np.testing.assert_array_equal(got, rposeidon.permute_device(s))
    # and the batched Montgomery form agrees with the host form
    np.testing.assert_array_equal(rbb.from_monty(got)[2],
                                  poseidon.permute_host(canon[2]))


def _script(c, ops):
    """Run a list of (method, args) on a challenger; collect the results."""
    return [getattr(c, name)(*args) for name, args in ops]


@pytest.mark.parametrize("param_set", PARAM_SETS, indirect=True)
def test_scripted_transcript(param_set):
    rng = np.random.default_rng(3)
    digest = rng.integers(0, 1 << 32, size=8, dtype=np.uint32)
    ops = [
        ("sample", ()),
        ("observe", (5,)),
        ("observe", (P + 7,)),
        ("observe_digest", (digest,)),
        ("sample_ext", ()),
        ("observe_ext", ((1, 2, 3, 4, P - 1),)),
        ("sample_bits", (10,)),
        ("observe_wrapped_u32", (0xFFFFFFFF,)),
    ]
    ops += [("observe", (int(v),)) for v in rng.integers(0, P, size=37)]
    ops += [("sample", ())] * 18  # drains the output buffer, duplexes again
    ops += [("grind", (5,)), ("sample_bits", (20,)),
            ("check_witness", (3, 12345)), ("sample_ext", ())]
    got_c, want_c = challenger.DuplexChallenger(), rchallenger.DuplexChallenger()
    assert _script(got_c, ops) == _script(want_c, ops)
    assert got_c.state == want_c.state
    assert got_c.input_buffer == want_c.input_buffer
    assert got_c.output_buffer == want_c.output_buffer


def test_clone_is_independent():
    c = challenger.DuplexChallenger()
    c.observe(9)
    d = c.clone()
    d.observe(10)
    assert c.input_buffer == [9] and d.input_buffer == [9, 10]
    assert c.sample() != d.sample()


def test_grind_witness_passes_check():
    c = challenger.DuplexChallenger()
    c.observe_ext((3, 1, 4, 1, 5))
    verifier = c.clone()
    w = c.grind(6)
    assert verifier.check_witness(6, w)
    assert c.state == verifier.state
