"""Memory chip: read/write log, (addr, clk)-sorted trace, memory-bus
receives, and the ENABLED ordering/consistency argument.

Counterpart of valida_tpu/chips/memory.py.  The sort and the range
assertion run on the host (numpy); the trace is built from the sorted
rows by torch operations on the prover's device.

The reference's memory AIR is fully commented out and its dummy-read
machinery disabled (`memory/src/stark.rs:22-78`, `memory/src/lib.rs:
160-162,286-411`) — this implements the intended design, completed:

* static-data initial writes are MERGED into the (addr, clk) sort (the
  reference prepends them, which breaks address ordering across the
  static/ops boundary — one reason its constraints could not be enabled);
* every sort delta is proven non-negative by a 4-limb base-256
  decomposition sent to the GLOBAL 8-bit range bus (top limb sent as
  4*limb, bounding deltas to 2^30) — this replaces the reference's
  intended dummy-read machinery (memory/src/lib.rs:286-411), whose row
  count is O(address gap / table length): a program touching both low
  static addresses and a 2^24 stack would pay ~2^19 dummy rows and a
  data-dependent trace height, fatal for jitted static shapes.  The only
  remaining dummies are the power-of-two tail padding;
* constraints: flag booleanity, addr_not_equal correctness, delta-limb
  recomposition, read value consistency at unchanged addresses,
  first-touch non-write rows carry value 0 (zero-initialized-memory
  semantics — the reference's STOREU8 merge uses `read_or_init`,
  cpu/src/lib.rs:687, so a read's first touch of an address must be
  provable, with value pinned to the init default 0).

Same-clk ordering: one instruction can read and write the same address in
one cycle (STOREU8's read-modify-write merge, LOAD32 to its own source).
The sort diff on an unchanged address is phase-weighted,
``2*(clk' - clk) + phase' - phase`` with ``phase = 1 - is_read -
2*is_static_initial`` (static -1, read 0, write/dummy +1), so the range
check proves static-init < reads < writes within a clk — a prover cannot
reorder a same-clk read after the write to leak the new value into the
merge.  (Consequence: an op that READS an address it already WROTE at the
same clk — JALV with overlapping operand slots — is unprovable; the
execution order of every op is reads-then-write.)  See docs/deviations.md.
"""

from __future__ import annotations

import numpy as np
import torch

from ..air.types import VPCol, Interaction
from ..core.word import MASK32
from .chip import (Chip, IndexAllocator, assemble_columns, be_byte,
                   canon_inv, mod_p, wide)

_a = IndexAllocator()
ADDR = _a.scalar()
VALUE = _a.word()
CLK = _a.scalar()
IS_STATIC_INITIAL = _a.scalar()
IS_READ = _a.scalar()
IS_WRITE = _a.scalar()
DIFF_INV = _a.scalar()
ADDR_NOT_EQUAL = _a.scalar()
DELTA = _a.array(4)  # base-256 limbs (LE) of the sort delta; top limb < 64
NUM_MEM_COLS = _a.width


def ranks_in_clk(clk: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """For ops in execution order (clk nondecreasing): how many ops of
    `mask` precede each op at its clk, i.e. the rank of a `mask` op among
    its clk's."""
    clk = clk.astype(np.int64)
    group_start = np.searchsorted(clk, clk, side="left")
    cum_excl = np.cumsum(mask) - mask
    return cum_excl - cum_excl[group_start]


class ReadBeforeWrite(Exception):
    pass


class SameClkReadAfterWrite(Exception):
    pass


class MemoryChip(Chip):
    name = "mem"

    def __init__(self):
        self.cells: dict[int, int] = {}
        self.operations: dict[int, list] = {}  # clk -> [(kind, addr, value)]
        self.static_data: dict[int, int] = {}
        # the op log as arrays (run_native(build_lists=False)); the dict
        # above is then empty: see op_arrays
        self.ops_arrays = None
        self._rows_cache = None

    # -- execution side (memory/src/lib.rs:85-136) --------------------------

    def _check_same_clk_raw(self, clk, address, pc, opcode):
        """A read of an address already WRITTEN at this clk is unprovable
        (phase ordering proves reads < writes within a clk — module
        docstring / docs/deviations.md §12).  Detect it at execute time
        with a clear error instead of failing later in constraint checks
        (the JALV-overlapping-operands case)."""
        for kind, a, _v in self.operations.get(clk, ()):
            if kind == "w" and a == address:
                raise SameClkReadAfterWrite(
                    f"memory chip: read of {address} after a same-clk "
                    f"write (clk = {clk}, pc = {pc}, opcode = {opcode}); "
                    "one instruction cannot read a cell it already wrote "
                    "this cycle — unprovable under the phase-ordered "
                    "memory argument"
                )

    def read(self, clk, address, log, pc=0, opcode=0, ordinal=0):
        if address not in self.cells:
            raise ReadBeforeWrite(
                f"memory chip: read before write: {address} (pc = {pc}, "
                f"opcode = {opcode}, ordinal = {ordinal})"
            )
        value = self.cells[address]
        if log:
            self._check_same_clk_raw(clk, address, pc, opcode)
            self.operations.setdefault(clk, []).append(("r", address, value))
        return value

    def read_or_init(self, clk, address, log):
        value = self.cells.get(address, 0)
        if log:
            self._check_same_clk_raw(clk, address, 0, 0)
            self.operations.setdefault(clk, []).append(("r", address, value))
        return value

    def peek(self, address):
        """Unlogged read (0 if uninitialized) — debugger/host inspection
        only; never use for proved semantics (use read / read_or_init)."""
        return self.cells.get(address, 0)

    def write(self, clk, address, value, log):
        if log:
            self.operations.setdefault(clk, []).append(("w", address, value))
        self.cells[address] = value & MASK32

    def write_static(self, address, value):
        self.cells[address] = value & MASK32
        self.static_data[address] = value & MASK32

    def examine(self, address):
        return str(self.cells[address]) if address in self.cells else "--------"

    # -- trace --------------------------------------------------------------

    def width(self):
        return NUM_MEM_COLS

    def op_arrays(self):
        """The op log as arrays in execution order (clk nondecreasing, a
        clk's ops in the order they ran): (clk u32[n], is_write u8[n],
        addr u32[n], value u32[n]).  `ops_arrays` when the native core set
        it, else made from the dict."""
        if self.ops_arrays is not None:
            return self.ops_arrays
        clks = sorted(self.operations)
        n = sum(len(self.operations[ck]) for ck in clks)
        ops = [op for ck in clks for op in self.operations[ck]]
        return (
            np.fromiter((ck for ck in clks for _ in self.operations[ck]),
                        np.uint32, n),
            np.fromiter((k == "w" for k, _a, _v in ops), np.uint8, n),
            np.fromiter((a for _k, a, _v in ops), np.uint32, n),
            np.fromiter((v for _k, _a, v in ops), np.uint32, n),
        )

    def _sorted_rows(self) -> np.ndarray:
        """int64 [n2, 4] rows (clk, kind, addr, value): static merged,
        sorted by (addr, clk, static first; ties stable = execution
        order), padded to a power of two with trailing dummies that repeat
        the last row's clk, addr and value.

        kind: 0 = dummy, 1 = read, 2 = write, 3 = static initial write.
        The sort is numpy's stable lexsort on the same keys as the JAX
        package's list sort, so the rows are the same.
        """
        if self._rows_cache is not None:
            return self._rows_cache
        mclk, mwrite, maddr, mvalue = self.op_arrays()
        n_static = len(self.static_data)
        n = n_static + len(mclk)
        if n == 0:
            self._rows_cache = np.zeros((1, 4), dtype=np.int64)
            return self._rows_cache
        static_addr = np.fromiter(self.static_data.keys(), np.int64, n_static)
        static_value = np.fromiter(self.static_data.values(), np.int64,
                                   n_static)
        clk = np.concatenate([np.zeros(n_static, np.int64),
                              mclk.astype(np.int64)])
        kind = np.concatenate([np.full(n_static, 3, np.int64),
                               1 + mwrite.astype(np.int64)])
        addr = np.concatenate([static_addr, maddr.astype(np.int64)])
        value = np.concatenate([static_value, mvalue.astype(np.int64)])
        order = np.lexsort((kind != 3, clk, addr))
        rows = np.stack([clk, kind, addr, value], axis=1)[order]
        n2 = 1 << max((n - 1).bit_length(), 0)
        if n2 > n:
            pad = np.repeat(rows[-1:], n2 - n, axis=0)
            pad[:, 1] = 0
            rows = np.concatenate([rows, pad])
        self._rows_cache = rows
        return rows

    def device_trace_inputs(self, machine):
        arr = self._sorted_rows()  # [n2, 4] clk kind addr value
        # the range assertion stays on the host (data-dependent; the
        # builder is branchless and produces the same limbs)
        self._sort_deltas(arr[:, 0], arr[:, 1], arr[:, 2])
        n2 = arr.shape[0]
        return tuple(np.ascontiguousarray(arr.T.astype(np.uint32))), (n2, n2)

    def build_trace(self, inputs, meta):
        clk, kind, addr, vals = wide(inputs)
        n2, _ = meta
        cols = {}
        cols[CLK] = mod_p(clk)
        cols[ADDR] = mod_p(addr)
        for k in range(4):
            cols[VALUE[k]] = be_byte(vals, k)
        is_read = (kind == 1).to(torch.int64)
        is_static = (kind == 3).to(torch.int64)
        cols[IS_READ] = is_read
        cols[IS_WRITE] = ((kind == 2) | (kind == 3)).to(torch.int64)
        cols[IS_STATIC_INITIAL] = is_static

        # delta limbs / diff_inv / addr_not_equal witnesses; clk deltas are
        # phase-weighted (static -1 < read 0 < write/dummy +1) to prove
        # same-clk ordering (module docstring).  The JAX package computes
        # them in wrapping u32 arithmetic; the mask reproduces the wrap
        # (every delta the trace keeps is nonnegative, asserted on the
        # host in device_trace_inputs).
        addr_delta = addr[1:] - addr[:-1]
        phase = 1 - is_read - 2 * is_static
        clk_delta = 2 * (clk[1:] - clk[:-1]) + (phase[1:] - phase[:-1])
        ane = addr_delta != 0
        diff = torch.where(ane, addr_delta, clk_delta) & 0xFFFFFFFF
        zero1 = diff.new_zeros(1)
        for k in range(4):
            cols[DELTA[k]] = torch.cat([(diff >> (8 * k)) & 0xFF, zero1])
        cols[ADDR_NOT_EQUAL] = torch.cat([ane.to(torch.int64), zero1])
        dinv_src = torch.where(ane, mod_p(addr_delta & 0xFFFFFFFF), 0)
        cols[DIFF_INV] = torch.cat([canon_inv(dinv_src), zero1])
        return assemble_columns(NUM_MEM_COLS, n2, cols, clk.device)

    @staticmethod
    def _sort_deltas(clk, kind, addr):
        addr_delta = addr[1:] - addr[:-1]
        phase = (1 - (kind == 1).astype(np.int64)
                 - 2 * (kind == 3).astype(np.int64))
        clk_delta = 2 * (clk[1:] - clk[:-1]) + (phase[1:] - phase[:-1])
        ane = addr_delta != 0
        diff = np.where(ane, addr_delta, clk_delta)
        assert (diff >= 0).all() and (diff < (1 << 30)).all(), \
            "sort delta outside the 2^30 range argument"
        return diff, ane, addr_delta

    def register_range_checks(self, machine):
        """Bump the range chip's multiplicities for this trace's delta
        limbs (called once after execution; the range trace must see the
        counts before it is generated)."""
        arr = self._sorted_rows()
        diff, _ane, _ad = self._sort_deltas(arr[:, 0], arr[:, 1], arr[:, 2])
        r = machine.range()
        # the last row's limbs are zero (no transition)
        for k in range(3):
            vals, counts = np.unique((diff >> (8 * k)) & 0xFF,
                                     return_counts=True)
            for v, c in zip(vals.tolist(), counts.tolist()):
                r.count[v] = r.count.get(v, 0) + c
            r.count[0] = r.count.get(0, 0) + 1
        vals, counts = np.unique(4 * ((diff >> 24) & 0xFF),
                                 return_counts=True)
        for v, c in zip(vals.tolist(), counts.tolist()):
            r.count[v] = r.count.get(v, 0) + c
        r.count[0] = r.count.get(0, 0) + 1

    # -- interactions -------------------------------------------------------

    def global_sends(self, machine):
        # sort-delta limbs on the 8-bit range bus; the top limb is sent as
        # 4*limb, bounding deltas (and the address space) to 2^30
        sends = []
        for k in range(3):
            sends.append(Interaction(
                fields=[VPCol.single_main(DELTA[k])], count=VPCol.one(),
                bus=machine.range_bus()))
        sends.append(Interaction(
            fields=[VPCol([(("main", DELTA[3]), 4)])], count=VPCol.one(),
            bus=machine.range_bus()))
        return sends

    def global_receives(self, machine):
        fields = [
            VPCol.single_main(IS_READ),
            VPCol.single_main(CLK),
            VPCol.single_main(ADDR),
            VPCol.single_main(IS_STATIC_INITIAL),
        ] + [VPCol.single_main(VALUE[i]) for i in range(4)]
        return [
            Interaction(fields=fields,
                        count=VPCol.sum_main([IS_READ, IS_WRITE]),
                        bus=machine.mem_bus())
        ]

    # -- AIR (the intended design, memory/src/stark.rs:25-77) ---------------

    def eval(self, b):
        local = b.main_local
        nxt = b.main_next
        one = 1

        b.assert_bool(local[IS_READ])
        b.assert_bool(local[IS_WRITE])
        b.assert_bool(local[IS_READ] + local[IS_WRITE])
        b.assert_bool(local[ADDR_NOT_EQUAL])
        # static-initial rows are writes (a dummy may not claim the static
        # phase to bend the same-clk ordering below)
        b.assert_bool(local[IS_STATIC_INITIAL])
        b.assert_zero(local[IS_STATIC_INITIAL] * (one - local[IS_WRITE]))

        addr_delta = nxt[ADDR] - local[ADDR]
        addr_equal = one - local[ADDR_NOT_EQUAL]

        b.when_transition().when(local[ADDR_NOT_EQUAL]).assert_one(
            addr_delta * local[DIFF_INV]
        )
        b.when_transition().when(addr_equal).assert_zero(addr_delta)

        # the range-checked limb recomposition proves the sort delta is a
        # non-negative integer < 2^30 (no field wrap: 2^30 < p)
        delta = (local[DELTA[0]] + 256 * local[DELTA[1]]
                 + 65536 * local[DELTA[2]] + 16777216 * local[DELTA[3]])
        b.when_transition().when(local[ADDR_NOT_EQUAL]).assert_eq(
            delta, addr_delta
        )
        # phase-weighted clk delta: phase = 1 - is_read - 2*is_static
        phase_local = one - local[IS_READ] - 2 * local[IS_STATIC_INITIAL]
        phase_next = one - nxt[IS_READ] - 2 * nxt[IS_STATIC_INITIAL]
        b.when_transition().when(addr_equal).assert_eq(
            delta,
            2 * (nxt[CLK] - local[CLK]) + phase_next - phase_local,
        )

        # non-write rows (reads and dummies) at an unchanged address
        # preserve the value — the chain from the last write to every read
        for k in range(4):
            b.when_transition().when(
                (one - nxt[IS_WRITE]) * addr_equal
            ).assert_eq(nxt[VALUE[k]], local[VALUE[k]])
        # non-write rows entering a NEW address carry value 0: a read's
        # first touch of an address (read_or_init, and reads chained off
        # address-stepping dummies) can only yield the init default 0,
        # never an arbitrary value; same for row 0
        for k in range(4):
            b.when_transition().when(
                local[ADDR_NOT_EQUAL] * (one - nxt[IS_WRITE])
            ).assert_zero(nxt[VALUE[k]])
            b.when_first_row().assert_zero(
                (one - local[IS_WRITE]) * local[VALUE[k]]
            )
        # the last row has no transition; its delta limbs must still be
        # valid range-bus messages (the trace leaves them zero, but any
        # in-range value is harmless — the messages are count-1 sends
        # matched by execution-registered multiplicities)
