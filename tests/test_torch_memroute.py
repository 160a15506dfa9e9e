"""The memory log's routing to the CPU chip's three memory channels in
C++ (valida_tpu_torch/native/memroute.cpp, `native.mem_channels`)
against its numpy version (`CpuChip._channels_plain`), and the byte
chip's four slots (`chips.byte.byte_slots`, which ranks only the ops at
byte-op clks) against the ranking of the whole log, on seeded op logs,
array for array: values, lengths and dtypes.  Then both chips' trace
inputs from the native core's op arrays against those from the dict log
of the same run, and cpu's channels against the numpy version, on
programs with LOADU8, LOADS8 and STOREU8 and on the benchmark's two
guests at their CPU-test sizes.  Without the native library the routing
raises, from either log, and never falls back to numpy."""

import sys
from pathlib import Path

import numpy as np
import pytest

from valida_tpu_torch import native
from valida_tpu_torch.chips.byte import byte_slots
from valida_tpu_torch.chips.cpu import CpuChip
from valida_tpu_torch.chips.memory import ranks_in_clk
from valida_tpu_torch.core import opcodes as OC
from valida_tpu_torch.core.program import InstructionWord, Operands, ProgramROM
from valida_tpu_torch.machine import examples
from valida_tpu_torch.machine.basic import BasicMachine
from valida_tpu_torch.native import build as native_build

BENCH = Path(__file__).resolve().parents[1] / "proverbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import spec  # noqa: E402  (proverbench/: the benchmark's job programs)


def random_log(seed: int, n_ops: int, per_clk: int = 3, writes: float = 0.4,
               first_clk: int = 0, gap: int = 1, left: float = 0.3,
               byte: str = "random"):
    """(clk, is_write, addr, value, left_imm, is_byte): `n_ops` ops in
    execution order, 1 to 2 * `per_clk` - 1 ops at each clk, a clk's reads
    before its writes (as an instruction runs them), a share `writes` of
    them writes; the clks from `first_clk`, 1 to `gap` apart.  The CPU log
    has a few more ops than the last clk.  left_imm flags a share `left`
    of the CPU ops; is_byte flags none, a third at random, or the ops at
    the first, the middle and the last clk of the memory log ("none",
    "random", "ends")."""
    rng = np.random.default_rng(seed)
    sizes, total = [], 0
    while total < n_ops:
        sizes.append(min(int(rng.integers(1, 2 * per_clk)), n_ops - total))
        total += sizes[-1]
    clks = first_clk + np.cumsum(rng.integers(1, gap + 1, len(sizes))) - 1
    clk = np.repeat(clks, sizes).astype(np.uint32)
    is_write = (rng.random(n_ops) < writes).astype(np.uint8)
    is_write = is_write[np.lexsort((is_write, clk))]
    addr = (4 * rng.integers(0, 1 << 20, n_ops)).astype(np.uint32)
    value = rng.integers(0, 1 << 32, n_ops, dtype=np.uint64).astype(np.uint32)
    n = (int(clk[-1]) + 1 if n_ops else first_clk) + int(rng.integers(1, 4))
    left_imm = rng.random(n) < left
    if byte == "none":
        is_byte = np.zeros(n, dtype=bool)
    elif byte == "random":
        is_byte = rng.random(n) < 1 / 3
    else:
        is_byte = np.zeros(n, dtype=bool)
        is_byte[clks[[0, len(clks) // 2, -1]]] = True
    return clk, is_write, addr, value, left_imm, is_byte


CASES = {
    # name: random_log's arguments
    "no ops": dict(n_ops=0, byte="none"),
    "one op": dict(n_ops=1),
    "one write": dict(n_ops=1, writes=1.0),
    "writes only": dict(n_ops=500, writes=1.0),
    "left-immediate ops": dict(n_ops=2000, left=1.0),
    "rank-2 reads": dict(n_ops=3000, per_clk=4, writes=0.25),
    "many ops a clk": dict(n_ops=4000, per_clk=12),
    "gaps, first clk 17": dict(n_ops=3000, first_clk=17, gap=5),
    "no byte clk": dict(n_ops=3000, byte="none"),
    "byte clks at start, middle and end": dict(n_ops=3000, per_clk=4,
                                               byte="ends"),
    "2^16 ops": dict(n_ops=1 << 16),
}
SEEDS = [2**31 + 3, 3_200_000_029]


def assert_same(got, want, dtype=np.uint32):
    """Two routings (tuples of tuples of arrays) equal array for array:
    values, lengths, dtypes; the arrays C-contiguous."""
    assert len(got) == len(want)
    for g_group, w_group in zip(got, want, strict=True):
        assert len(g_group) == len(w_group)
        for g, w in zip(g_group, w_group, strict=True):
            assert g.dtype == w.dtype == dtype and g.ndim == 1
            assert g.flags.c_contiguous
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("seed", SEEDS)
def test_channels_equal_the_numpy_version(name, seed):
    """mem_channels gives the three channels' (clk, addr, value) of
    `_channels_plain`, and every op but the reads of rank 2 and above
    lands on one channel."""
    clk, is_write, addr, value, left_imm, _ = random_log(seed, **CASES[name])
    got = native.mem_channels(clk, is_write, addr, value, left_imm)
    assert_same(got, CpuChip._channels_plain(clk, is_write, addr, value,
                                             left_imm))
    assert len(got[2][0]) == int(is_write.sum())
    reads_a_clk = np.unique(clk[is_write == 0], return_counts=True)[1]
    assert len(got[0][0]) + len(got[1][0]) == int(
        np.minimum(reads_a_clk, 2).sum())


def slots_of_the_whole_log(mclk, mwrite, maddr, mvalue, is_byte):
    """byte_slots' slots by ranking every op of the log and then keeping
    those at byte-op clks (the byte chip's routing before it ranked only
    the ops at byte-op clks)."""
    mwrite = mwrite.astype(bool)
    at_byte = is_byte[mclk]
    read_rank = ranks_in_clk(mclk, ~mwrite)
    write_rank = ranks_in_clk(mclk, mwrite)

    def ops_of(sel):
        idx = np.flatnonzero(at_byte & sel)
        return maddr[idx].astype(np.int64), mvalue[idx].astype(np.int64)

    return (ops_of(~mwrite & (read_rank == 0)),
            ops_of(~mwrite & (read_rank == 1)),
            ops_of(~mwrite & (read_rank == 2)),
            ops_of(mwrite & (write_rank == 0)))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("seed", SEEDS)
def test_byte_slots_equal_the_whole_logs_ranking(name, seed):
    """byte_slots gives the four slots' (addr, value) of the whole log's
    ranking: the first three reads and the first write at each byte op's
    clk."""
    clk, is_write, addr, value, _, is_byte = random_log(seed, **CASES[name])
    got = byte_slots(clk, is_write, addr, value, is_byte)
    assert_same(got, slots_of_the_whole_log(clk, is_write, addr, value,
                                            is_byte), np.int64)
    at_byte = is_byte[clk]
    for slot, rank in ((got[0], 0), (got[1], 1), (got[2], 2)):
        reads = np.unique(clk[at_byte & (is_write == 0)],
                          return_counts=True)[1]
        assert len(slot[0]) == int((reads > rank).sum())
    assert len(got[3][0]) == len(np.unique(clk[at_byte & (is_write != 0)]))


def _bad(log, fault: str):
    """The log with one fault: a clk below the one before it, a clk at the
    CPU log's length, int64 clks, an addr array one op short, u8 flags,
    bool writes, a strided value array or 2-d addrs."""
    clk, is_write, addr, value, flags = log
    clk = clk.copy()
    if fault == "decreasing clk":
        clk[len(clk) // 2] = clk[len(clk) // 2 - 1] - 1
    elif fault == "clk past the cpu log":
        clk[-1] = len(flags)
    elif fault == "int64 clk":
        clk = clk.astype(np.int64)
    elif fault == "addr one short":
        addr = addr[:-1]
    elif fault == "u8 flags":
        flags = flags.astype(np.uint8)
    elif fault == "bool is_write":
        is_write = is_write.astype(bool)
    elif fault == "strided value":
        value = np.repeat(value, 2)[::2]
    else:
        addr = addr.reshape(1, -1)
    return clk, is_write, addr, value, flags


FAULTS = {
    "decreasing clk": "a clk decreases or has no CPU op",
    "clk past the cpu log": "a clk decreases or has no CPU op",
    "int64 clk": "expected a contiguous 1-d uint32 array",
    "addr one short": "op arrays of different lengths",
    "u8 flags": "expected a contiguous 1-d bool array",
    "bool is_write": "expected a contiguous 1-d uint8 array",
    "strided value": "expected a contiguous 1-d uint32 array",
    "2-d addr": "expected a contiguous 1-d uint32 array",
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_bad_log_raises(fault):
    """Out of clk order, a clk with no CPU op, a wrong dtype or shape, a
    strided array or arrays of different lengths raise ValueError before
    or instead of a result."""
    clk, is_write, addr, value, left_imm, _ = random_log(7, 300, per_clk=4)
    with pytest.raises(ValueError, match=FAULTS[fault]):
        native.mem_channels(*_bad((clk, is_write, addr, value, left_imm),
                                  fault))


# -- the chips, array log against dict log --------------------------------

def _rows_of(name):
    """(instruction rows (opcode, operands), fp, static data, advice) of a
    named program: programs with byte ops, fib(25), and the benchmark's
    guests at their CPU-test sizes (the seed's first job)."""
    if name == "fib":
        return ([(iw.opcode, iw.operands.ops)
                 for iw in examples.fib_program()], 0x1000, None, b"")
    if name in BYTE_PROGRAMS:
        rows, static, advice = BYTE_PROGRAMS[name]
        return rows, 0x1000, static, advice
    config_name, log_cycles = GUESTS[name]
    bench = spec.benchmark()
    config = spec.load_json(spec.ROOT / spec.config_entry(
        bench, config_name)["file"])
    program = spec.load_json(spec.HERE / "programs"
                             / f"{config['program']}.json")
    cell = spec.Cell(f"{config_name}.test", 1, config,
                     {"log_cycles": log_cycles}, program,
                     config["sizes"][str(log_cycles)])
    rows = [(getattr(OC, op), ops)
            for op, ops in spec.job_program(cell, 2**33 + 1, 0)]
    return rows, int(program["fp"]), None, b""


def _ins(opcode, a=0, b=0, c=0, d=0, e=0):
    return (opcode, (a, b, c, d, e))


# name: (rows, static data, advice); tests/test_torch_native.py's
# advice/byte-op program and two of tests/test_torch_basic.py's
BYTE_PROGRAMS = {
    "advice_bytes": ([
        _ins(OC.READ_ADVICE, -4), _ins(OC.READ_ADVICE, -8),
        _ins(OC.READ_ADVICE, -12), _ins(OC.IMM32, -16, 0, 0, 1, 1),
        _ins(OC.STOREU8, 0, -16, -4), _ins(OC.LOADU8, -20, 0, -16),
        _ins(OC.LOADS8, -24, 0, -16), _ins(OC.STOP),
    ], {0x110: 0xAABBCCDD}, bytes([7, 9])),
    "storeu8_fresh_address": ([
        _ins(OC.IMM32, -4, 0, 0, 0, 0x41), _ins(OC.IMM32, -8, 0, 2, 0, 1),
        _ins(OC.STOREU8, 0, -8, -4), _ins(OC.LOADU8, -12, 0, -8),
        _ins(OC.STOP),
    ], None, b""),
    "byte_ops_every_slot": ([
        _ins(OC.IMM32, -4, 0x80, 0x7F, 0xFE, 0x01),
        _ins(OC.IMM32, -8, 0, 0, 0x0F, 0xFC),
        _ins(OC.IMM32, -12, 0, 0, 0x0F, 0xFD),
        _ins(OC.IMM32, -16, 0, 0, 0x0F, 0xFE),
        _ins(OC.IMM32, -20, 0, 0, 0x0F, 0xFF),
        _ins(OC.LOADU8, -24, 0, -8), _ins(OC.LOADU8, -28, 0, -12),
        _ins(OC.LOADU8, -32, 0, -16), _ins(OC.LOADU8, -36, 0, -20),
        _ins(OC.LOADS8, -40, 0, -12), _ins(OC.LOADS8, -44, 0, -16),
        _ins(OC.IMM32, -48, 0, 0, 0, 0xAB),
        _ins(OC.IMM32, -52, 0, 0, 0x20, 0x00),
        _ins(OC.IMM32, -56, 0, 0, 0x20, 0x01),
        _ins(OC.IMM32, -60, 0, 0, 0x20, 0x02),
        _ins(OC.IMM32, -64, 0, 0, 0x20, 0x03),
        _ins(OC.STOREU8, 0, -52, -48), _ins(OC.STOREU8, 0, -56, -48),
        _ins(OC.STOREU8, 0, -60, -48), _ins(OC.STOREU8, 0, -64, -48),
        _ins(OC.STOP),
    ], None, b""),
}
# name: (configuration, log cycles): proverbench's guests at the sizes
# the CPU tests run them
GUESTS = {"fibonacci_2^10": ("fibonacci", 10),
          "sha2_chain_2^13": ("sha2_chain", 13)}
PROGRAMS = list(BYTE_PROGRAMS) + ["fib"] + list(GUESTS)


def executed(name, build_lists: bool):
    """A BasicMachine after `run_native` of the named program: op logs as
    arrays (build_lists=False) or as the dict and lists."""
    rows, fp, static, advice = _rows_of(name)
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM(
        [InstructionWord(op, Operands(tuple(ops))) for op, ops in rows]))
    for addr, value in (static or {}).items():
        m.static_data().write(addr, value)
    m.cpu().fp = fp
    m.run_native(advice_bytes=advice, build_lists=build_lists)
    return m


@pytest.fixture
def plain_calls(monkeypatch):
    """How often CpuChip's numpy routing ran, counted."""
    calls = [0]
    plain = CpuChip._channels_plain

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(CpuChip, "_channels_plain", staticmethod(counted))
    return calls


@pytest.mark.parametrize("name", PROGRAMS)
def test_array_log_gives_the_dict_logs_trace_inputs(name, plain_calls):
    """The CPU and byte chips' trace inputs from the native core's op
    arrays equal those from the dict log of the same run, array for array
    and dtype for dtype, with the same meta; cpu's channels (routed in
    C++ from either log; the numpy version never runs in a chip) equal
    the numpy version's on that log."""
    arrays, lists = executed(name, False), executed(name, True)
    assert arrays.mem().ops_arrays is not None
    assert lists.mem().ops_arrays is None
    for chip_name in ("cpu", "byte"):
        chips = [next(c for c in m.chips() if c.name == chip_name)
                 for m in (arrays, lists)]
        got, got_meta = chips[0].device_trace_inputs(arrays)
        want, want_meta = chips[1].device_trace_inputs(lists)
        assert plain_calls[0] == 0
        assert got_meta == want_meta
        assert len(got) == len(want)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.flags.c_contiguous
            np.testing.assert_array_equal(g, w)
        if chip_name == "cpu":
            channels = (got[7:10], got[10:13], got[13:16])
    if name in BYTE_PROGRAMS:
        assert got_meta[0] > 0  # the byte chip has rows
    kinds, has_imm = lists.cpu().op_arrays()[:2]
    left_imm = (kinds == 14) & (has_imm != 0)
    assert_same(channels, CpuChip._channels_plain(*lists.mem().op_arrays(),
                                                  left_imm))


@pytest.mark.parametrize("build_lists", [False, True],
                         ids=["array log", "dict log"])
def test_routing_has_no_fallback(monkeypatch, tmp_path, plain_calls,
                                 build_lists):
    """With the routing's source missing (so no library can be built or
    loaded), cpu's trace inputs raise NativeRunError from an array log
    and from a dict log, and never run the numpy version."""
    m = executed("advice_bytes", build_lists)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native_build, "MEMROUTE_SRC",
                        tmp_path / "missing.cpp")
    chip = next(c for c in m.chips() if c.name == "cpu")
    with pytest.raises(native.NativeRunError, match="unavailable"):
        chip.device_trace_inputs(m)
    assert plain_calls[0] == 0
