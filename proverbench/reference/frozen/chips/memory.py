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


from ..air.types import VPCol, Interaction
from .chip import Chip, IndexAllocator

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


    # -- trace --------------------------------------------------------------

    def width(self):
        return NUM_MEM_COLS


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
