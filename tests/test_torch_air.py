"""The port's AIR layer (valida_tpu_torch.air: builders, LogUp permutation
traces, quotient, debug checker, bus diagnostic) against the JAX package's
numpy path, chip by chip: exact word equality."""

import numpy as np
import pytest

from valida_tpu import backend
from valida_tpu.air import builder as rbuilder
from valida_tpu.air import bus_debug as rbus_debug
from valida_tpu.air import check as rcheck
from valida_tpu.air import lookup as rlookup
from valida_tpu.air import quotient as rquotient
from valida_tpu.commit.fri import FriConfig as RefFriConfig
from valida_tpu.commit.pcs import TwoAdicFriPcs as RefPcs
from valida_tpu.field import babybear as rbb
from valida_tpu.machine import examples as rexamples
from valida_tpu_torch.air import builder, bus_debug, check, lookup, quotient
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.machine import examples

P = rbb.P
# fixed permutation challenges and alpha (canonical ext tuples)
CHALLENGES = [(1234567, 7654321, 1111111, 2222222, 3333333),
              (987654321, 12345, 67890, 13579, 24680),
              (P - 1, 5, P - 7, 11, 2013)]
ALPHA = (192837465, 564738291, 1029384756, 5, P - 2)

MACHINES = {
    "mini": (lambda: rexamples.random_mini_machine(40, seed=5),
             lambda: examples.random_mini_machine(40, seed=5)),
    "ragged": (lambda: rexamples.random_ragged_machine(64, seed=7),
               lambda: examples.random_ragged_machine(64, seed=7)),
}
CHIPS = [(name, ci) for name, n in (("mini", 2), ("ragged", 4))
         for ci in range(n)]


def _machines(name):
    ref, port = MACHINES[name]
    return ref(), port()


def _ref_trace(ref_m, ci):
    return np.asarray(ref_m.chips()[ci].generate_trace(ref_m),
                      dtype=np.uint32)


@pytest.mark.parametrize("name", list(MACHINES))
def test_same_traces_from_the_same_seed(name):
    ref_m, m = _machines(name)
    assert [c.name for c in m.chips()] == [c.name for c in ref_m.chips()]
    for rc, c in zip(ref_m.chips(), m.chips()):
        np.testing.assert_array_equal(c.generate_trace(m),
                                      rc.generate_trace(ref_m))
        assert c.width() == rc.width()
        assert c.preprocessed_width() == rc.preprocessed_width()
    assert m.range.counts == ref_m.range.counts


@pytest.mark.parametrize("name,ci", CHIPS)
def test_log_quotient_degree(name, ci):
    ref_m, m = _machines(name)
    assert (quotient.get_log_quotient_degree(m, m.chips()[ci])
            == rquotient.get_log_quotient_degree(ref_m, ref_m.chips()[ci]))


def _perm(name, ci):
    """(ref perm trace numpy, port perm trace tensor, machines)."""
    ref_m, m = _machines(name)
    trace = _ref_trace(ref_m, ci)
    with backend.use_backend("numpy"):
        want = np.asarray(rlookup.generate_permutation_trace(
            ref_m, ref_m.chips()[ci], trace, CHALLENGES))
    got = lookup.generate_permutation_trace(
        m, m.chips()[ci], from_reference(trace), CHALLENGES)
    return want, got, ref_m, m


@pytest.mark.parametrize("ci", range(4))
def test_permutation_trace(ci):
    want, got, _ref_m, _m = _perm("ragged", ci)
    np.testing.assert_array_equal(to_numpy(got), want)
    assert lookup.cumulative_sum(got) == rlookup.cumulative_sum(want)
    np.testing.assert_array_equal(to_numpy(lookup.flatten_perm_trace(got)),
                                  rlookup.flatten_perm_trace(want))


def test_permutation_trace_of_a_corrupted_trace():
    """A trace that breaks the chip's constraints still has the reference's
    permutation trace (the LogUp columns read the trace as it is)."""
    ref_m, m = _machines("mini")
    trace = _ref_trace(ref_m, 0).copy()
    trace[1:7, 0] = (trace[1:7, 0] + 3) % 16
    with backend.use_backend("numpy"):
        want = np.asarray(rlookup.generate_permutation_trace(
            ref_m, ref_m.chips()[0], trace, CHALLENGES))
    got = lookup.generate_permutation_trace(
        m, m.chips()[0], from_reference(trace), CHALLENGES)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_rlc_alphas():
    ref_m, m = _machines("ragged")
    for rc, c in zip(ref_m.chips(), m.chips()):
        assert (lookup.rlc_alphas(c, m, CHALLENGES)
                == rlookup.rlc_alphas(rc, ref_m, CHALLENGES))


def test_bus_cumulative_sums_balance():
    """The cumulative sums of a balanced machine add up to 0 in both
    packages; check_cumulative_sums accepts them."""
    sums = [_perm("ragged", ci)[1] for ci in range(4)]
    cs = [lookup.cumulative_sum(s) for s in sums]
    check.check_cumulative_sums(cs)
    rcheck.check_cumulative_sums(cs)


@pytest.mark.parametrize("name,ci", CHIPS)
def test_quotient_on_reference_ldes(name, ci):
    """quotient_values and decompose_and_flatten of the port on the JAX
    package's own LDEs (committed by its numpy PCS)."""
    want_perm, _got, ref_m, m = _perm(name, ci)
    rchip, chip = ref_m.chips()[ci], m.chips()[ci]
    pcs = RefPcs(RefFriConfig(), coset_shift=rbb.GENERATOR)
    trace = _ref_trace(ref_m, ci)
    log_degree = trace.shape[0].bit_length() - 1
    qd = rquotient.get_log_quotient_degree(ref_m, rchip)
    cs = rlookup.cumulative_sum(want_perm)
    prep = rchip.preprocessed_trace()
    with backend.use_backend("numpy"):
        mats = [trace, np.asarray(rlookup.flatten_perm_trace(want_perm))]
        if prep is not None:
            mats.append(np.asarray(prep, dtype=np.uint32))
        ldes = [np.asarray(lde) for lde in
                pcs.get_ldes(pcs.commit_batches(mats)[1])]
        prep_lde = ldes[2] if prep is not None else None
        want_q = np.asarray(rquotient.quotient_values(
            ref_m, rchip, log_degree, qd, prep_lde, ldes[0], ldes[1], cs,
            CHALLENGES, ALPHA, pcs.coset_shift(), pcs.log_blowup))
        want_chunks = np.asarray(rquotient.decompose_and_flatten(
            want_q, pcs.coset_shift(), qd))
    got_q = quotient.quotient_values(
        m, chip, log_degree, qd,
        None if prep_lde is None else from_reference(prep_lde),
        from_reference(ldes[0]), from_reference(ldes[1]), cs, CHALLENGES,
        ALPHA, pcs.coset_shift(), pcs.log_blowup)
    np.testing.assert_array_equal(to_numpy(got_q), want_q)
    got_chunks = quotient.decompose_and_flatten(got_q, pcs.coset_shift(), qd)
    np.testing.assert_array_equal(to_numpy(got_chunks), want_chunks)


@pytest.mark.parametrize("ci", range(4))
def test_check_constraints_accepts_honest_trace(ci):
    _want, got, _ref_m, m = _perm("ragged", ci)
    chip = m.chips()[ci]
    trace = from_reference(np.asarray(chip.generate_trace(m)))
    check.check_constraints(m, chip, trace, got, CHALLENGES,
                            lookup.cumulative_sum(got))


@pytest.mark.parametrize("col,chip_name", [(2, "sender"), (1, "range")])
def test_check_constraints_rejects_corrupted_trace(col, chip_name):
    """One changed trace word: both packages raise AssertionError naming
    the chip, the same constraint and the same rows."""
    ref_m, m = _machines("mini")
    ci = [c.name for c in m.chips()].index(chip_name)
    trace = _ref_trace(ref_m, ci).copy()
    trace[3, col] = (trace[3, col] + 1) % P
    trace[5, col] = (trace[5, col] + 2) % P
    messages = []
    with backend.use_backend("numpy"):
        pt = np.asarray(rlookup.generate_permutation_trace(
            ref_m, ref_m.chips()[ci], trace, CHALLENGES))
        with pytest.raises(AssertionError, match=chip_name) as e:
            rcheck.check_constraints(ref_m, ref_m.chips()[ci], trace, pt,
                                     CHALLENGES, rlookup.cumulative_sum(pt))
        messages.append(str(e.value))
    t = from_reference(trace)
    got = lookup.generate_permutation_trace(m, m.chips()[ci], t, CHALLENGES)
    with pytest.raises(AssertionError, match=chip_name) as e:
        check.check_constraints(m, m.chips()[ci], t, got, CHALLENGES,
                                lookup.cumulative_sum(got))
    messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_check_constraints_rejects_wrong_cumulative_sum():
    ref_m, m = _machines("mini")
    _want, got, _ref_m, m = _perm("mini", 0)
    chip = m.chips()[0]
    trace = from_reference(np.asarray(chip.generate_trace(m)))
    cs = list(lookup.cumulative_sum(got))
    cs[1] = (cs[1] + 1) % P
    with pytest.raises(AssertionError, match="sender"):
        check.check_constraints(m, chip, trace, got, CHALLENGES, tuple(cs))


def _vvals(seed, q=16):
    rng = np.random.default_rng(seed)
    base = [rng.integers(0, P, size=q, dtype=np.uint32) for _ in range(3)]
    ext = rng.integers(0, P, size=(q, 5), dtype=np.uint32)
    return base, ext


def test_vector_builder_fold():
    """The fold of base, constant and extension constraints in one
    builder equals the reference's: the alpha power of each constraint
    follows its index."""
    base, ext = _vvals(11)
    alpha = from_reference(np.array([rbb.monty_scalar(c) for c in ALPHA],
                                    dtype=np.uint32))
    r_alpha = np.array([rbb.monty_scalar(c) for c in ALPHA], dtype=np.uint32)

    def build(b, VVal, wrap):
        x, y, z = (VVal(wrap(v), False) for v in base)
        e = VVal(wrap(ext), True)
        b.assert_zero(x * y - z)
        b.assert_zero(e * x + 3)
        b.when(x).assert_eq(y, 7)
        b.assert_zero(5)
        b.assert_bool(z)
        b.assert_one(e - y)
        b.assert_zero(-(x - 1) * 2)

    def sel(VVal, wrap):
        one = wrap(np.full(16, rbb.monty_scalar(1), dtype=np.uint32))
        return dict(is_first_row=VVal(one, False), is_last_row=VVal(one, False),
                    is_transition=VVal(one, False))

    common = dict(main_local=[], main_next=[], prep_local=[], prep_next=[],
                  perm_local=[], perm_next=[], perm_challenges=[])
    with backend.use_backend("numpy"):
        rb = rbuilder.VectorBuilder(None, alpha=rbuilder.VVal(r_alpha, True),
                                    **common, **sel(rbuilder.VVal, np.asarray))
        build(rb, rbuilder.VVal, np.asarray)
        want = np.asarray(rb.fold().arr)
    b = builder.VectorBuilder(None, alpha=builder.VVal(alpha, True),
                              **common, **sel(builder.VVal, from_reference))
    build(b, builder.VVal, from_reference)
    np.testing.assert_array_equal(to_numpy(b.fold().arr), want)


def test_scalar_and_symbolic_builders():
    """ScalarBuilder's Horner accumulation and SymbolicBuilder's degree on
    the same expression as the reference's."""
    vals = [(3, 1, 4, 1, 5), (9, 2, 6, 5, 3), (P - 1, 0, 0, 0, 7)]

    def run(mod):
        b = mod.ScalarBuilder(
            None, main_local=[mod.SVal(v) for v in vals], main_next=[],
            prep_local=[], prep_next=[], perm_local=[], perm_next=[],
            perm_challenges=[], is_first_row=mod.SVal(vals[0]),
            is_last_row=mod.SVal(vals[1]), is_transition=mod.SVal(vals[2]),
            alpha=mod.SVal(ALPHA))
        x, y, z = b.main_local
        b.assert_zero(x * y - z)
        b.when_first_row().assert_eq(x, 9)
        b.when_transition().assert_zero(y * (y - 1))
        b.assert_one(3 - z)
        return b.accumulator.e

    assert run(builder) == run(rbuilder)
    x = builder.SymExpr(1)
    assert (x * x * 3 + x - 1).deg == (rbuilder.SymExpr(1) * rbuilder.SymExpr(1)
                                       * 3).deg == 2


def test_bus_debug_report():
    """The bus diagnostic gives the reference's report, balanced and after
    a lost receive."""
    ref_m, m = rexamples.random_ragged_machine(8, seed=7), \
        examples.random_ragged_machine(8, seed=7)
    assert bus_debug.report_imbalances(m) == rbus_debug.report_imbalances(ref_m)
    assert "balanced" in bus_debug.report_imbalances(m)
    for mm in (ref_m, m):
        mm.range.counts[mm.onerow.value] -= 1
    got = bus_debug.report_imbalances(m)
    assert got == rbus_debug.report_imbalances(ref_m)
    assert "IMBALANCED" in got
