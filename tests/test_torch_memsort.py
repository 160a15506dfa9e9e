"""The memory chip's sort and range-limb counts in C++
(valida_tpu_torch/native/memsort.cpp, `native.mem_sort`) against its numpy
version (`MemoryChip._sorted_rows`, `_sort_deltas`, `_limb_counts`) on
seeded op logs: the rows word for word, the padded height, the range
chip's 256 bins, and the same AssertionError for a sort delta of 2^30.
Each log is held by two chips: one with the native core's op arrays
(`ops_arrays`, the C++ path) and one with the dict log (the numpy path).
Without the native library the op arrays raise, and never fall back to
numpy."""

import types

import numpy as np
import pytest

from valida_tpu_torch import native
from valida_tpu_torch.chips.memory import MemoryChip
from valida_tpu_torch.chips.range import RangeCheckerChip
from valida_tpu_torch.native import build as native_build

BASE = 1 << 28  # the highest cell an op touches
RANGE_MESSAGE = "sort delta outside the 2\\^30 range argument"


def random_log(seed: int, n_ops: int, n_static: int = 0, span: int = 64,
               per_clk: int = 3):
    """(static {addr: value}, clk, is_write, addr, value): `n_ops` ops in
    execution order on cells BASE - 4 * span .. BASE, about `per_clk` ops
    a clk, each clk's reads before its writes (an instruction reads, then
    writes; so a read and a write of one cell at one clk, and several
    reads of one cell at one clk, both occur), and `n_static` static
    cells, half of them at cells the ops touch, half just above them."""
    rng = np.random.default_rng(seed)
    cells = BASE - 4 * rng.integers(0, span + 1, size=max(n_ops, 1))
    addr = cells[rng.integers(0, len(cells), size=n_ops)]
    # half of the ops hit the cell of the op before them
    same = rng.random(n_ops) < 0.5
    addr = np.where(same & (np.arange(n_ops) > 0), np.roll(addr, 1), addr)
    clk = np.sort(rng.integers(0, n_ops // per_clk + 1, size=n_ops))
    is_write = (rng.random(n_ops) < 0.4).astype(np.uint8)
    order = np.lexsort((is_write, clk))
    touched = np.unique(addr)
    k = min(n_static // 2, len(touched))
    static_addr = np.concatenate([
        rng.choice(touched, size=k, replace=False),
        BASE + 4 + 4 * np.arange(n_static - k)])
    rng.shuffle(static_addr)
    static = {int(a): int(v) for a, v in zip(
        static_addr, rng.integers(0, 1 << 32, size=n_static))}
    return (static, clk[order].astype(np.uint32), is_write[order],
            addr[order].astype(np.uint32),
            rng.integers(0, 1 << 32, size=n_ops).astype(np.uint32))


def chips(log):
    """(the C++ path's chip, the numpy path's chip) holding `log`."""
    static, clk, is_write, addr, value = log
    arrays, lists = MemoryChip(), MemoryChip()
    for chip in (arrays, lists):
        chip.static_data = dict(static)
    arrays.ops_arrays = (clk, is_write, addr, value)
    for c, w, a, v in zip(clk.tolist(), is_write.tolist(), addr.tolist(),
                          value.tolist()):
        lists.operations.setdefault(c, []).append(("w" if w else "r", a, v))
    return arrays, lists


def registered(chip):
    """(the range chip's counts, the mem chip's trace inputs) after
    register_range_checks."""
    rc = RangeCheckerChip()
    chip.register_range_checks(types.SimpleNamespace(range=lambda: rc))
    return rc.count, chip.device_trace_inputs(None)


CASES = {
    # name: random_log's arguments
    "no ops": dict(n_ops=0),
    "no ops, statics": dict(n_ops=0, n_static=5),
    "one op": dict(n_ops=1),
    "2^10 - 1 ops: one dummy": dict(n_ops=(1 << 10) - 1),
    "2^10 ops": dict(n_ops=1 << 10),
    "2^10 + 1 ops": dict(n_ops=(1 << 10) + 1),
    "2^12 ops, statics at touched cells": dict(n_ops=1 << 12, n_static=40),
    "2^12 + 1 ops, one cell": dict(n_ops=(1 << 12) + 1, span=0),
    "many ops a clk": dict(n_ops=3000, span=4, per_clk=12),
    # address spans of 1, 2 and 3 radix digits
    "span 2^16": dict(n_ops=5000, span=1 << 14, n_static=7),
    "span 2^26": dict(n_ops=5000, span=1 << 24, n_static=7),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("seed", [2**31 + 7, 3_200_000_101])
def test_native_rows_and_counts_equal_the_numpy_version(name, seed):
    """The C++ routine's rows equal `_sorted_rows` word for word (the same
    padded height), and its counts equal the numpy counts bin for bin,
    directly and through register_range_checks on both paths."""
    arrays, lists = chips(random_log(seed, **CASES[name]))
    rows, counts = native.mem_sort(arrays.static_data, *arrays.ops_arrays)
    plain = lists._sorted_rows()
    assert rows.dtype == np.uint32 and rows.shape == (4, plain.shape[0])
    assert plain.shape[0] & (plain.shape[0] - 1) == 0
    np.testing.assert_array_equal(rows, plain.T)
    diff = lists._sort_deltas(plain[:, 0], plain[:, 1], plain[:, 2])
    np.testing.assert_array_equal(counts, lists._limb_counts(diff))
    assert counts.sum() == 4 * plain.shape[0]

    got_count, got_inputs = registered(arrays)
    want_count, want_inputs = registered(lists)
    assert got_count == want_count
    assert got_inputs[1] == want_inputs[1] == (plain.shape[0],) * 2
    for g, w in zip(got_inputs[0], want_inputs[0], strict=True):
        assert g.dtype == w.dtype == np.uint32 and g.flags.c_contiguous
        np.testing.assert_array_equal(g, w)


def _with_gap(log, gap: int, same_cell: bool):
    """The log with two more reads: one of its last op's cell at the next
    clk, then one `gap` bytes above its highest cell at that clk, or of
    the same cell `gap` clk later (a phase-weighted delta of 2 * gap)."""
    static, clk, is_write, addr, value = log
    c, a = int(clk[-1]) + 1, int(addr[-1])
    last = (c + gap, a) if same_cell else (c, int(addr.max()) + gap)
    return (static, np.append(clk, [c, last[0]]).astype(np.uint32),
            np.append(is_write, [0, 0]).astype(np.uint8),
            np.append(addr, [a, last[1]]).astype(np.uint32),
            np.append(value, [value[-1], 0]).astype(np.uint32))


# (gap, same cell, raises): the delta reaches 2^30 (or stays just below
# it, its top limb 63) by the address or by the phase-weighted clk
GAPS = {
    "address 2^30": (1 << 30, False, True),
    "address 2^30 - 1": ((1 << 30) - 1, False, False),
    "clk 2^29": (1 << 29, True, True),
    "clk 2^29 - 1": ((1 << 29) - 1, True, False),
}


@pytest.mark.parametrize("name", list(GAPS))
def test_delta_of_2_to_the_30_raises_on_both_paths(name):
    """A sort delta of 2^30 raises the numpy version's AssertionError on
    both paths, from register_range_checks; just below it both count the
    same limbs."""
    gap, same_cell, raises = GAPS[name]
    arrays, lists = chips(_with_gap(random_log(11, 200, span=8), gap,
                                    same_cell))
    if raises:
        for chip in (arrays, lists):
            with pytest.raises(AssertionError, match=RANGE_MESSAGE):
                registered(chip)
    else:
        got, want = registered(arrays), registered(lists)
        assert got[0] == want[0] and 4 * 63 in got[0]


def test_write_before_read_at_one_clk_raises_on_both_paths():
    """Ops at one cell out of phase order (a write, then a read, at one
    clk: a delta of -1) raise on both paths."""
    static, clk, is_write, addr, value = random_log(5, 100, span=8)
    clk = np.append(clk, [clk[-1] + 1] * 2).astype(np.uint32)
    is_write = np.append(is_write, [1, 0]).astype(np.uint8)
    addr = np.append(addr, [addr[-1]] * 2).astype(np.uint32)
    value = np.append(value, [1, 1]).astype(np.uint32)
    for chip in chips((static, clk, is_write, addr, value)):
        with pytest.raises(AssertionError, match=RANGE_MESSAGE):
            registered(chip)


@pytest.mark.parametrize("missing", ["SRC", "POSEIDON_SRC", "MEMSORT_SRC",
                                     "MEMROUTE_SRC", "CBOR_SRC"])
def test_array_log_has_no_fallback(monkeypatch, tmp_path, missing):
    """With a source of the native library missing (so none can be built
    or loaded), register_range_checks on the native core's op arrays
    raises NativeRunError and never runs the numpy version."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native_build, missing, tmp_path / "missing.cpp")

    def no_plain(self):
        raise AssertionError("the op arrays fell back to numpy")

    monkeypatch.setattr(MemoryChip, "_sorted_rows", no_plain)
    arrays, _lists = chips(random_log(3, 50))
    with pytest.raises(native.NativeRunError, match="unavailable"):
        registered(arrays)
    assert arrays._rows_cache is None
