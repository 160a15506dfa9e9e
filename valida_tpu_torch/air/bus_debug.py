"""Bus-traffic diagnostic: materialize every send/receive message as a
concrete field tuple and report per-bus multiset imbalances with the
offending chip/rows.

Counterpart of valida_tpu/air/bus_debug.py.  The LogUp argument is sound
iff, per bus, the send multiset equals the receive multiset; this tool
pinpoints divergence far more precisely than a nonzero cumulative sum.  It
reads the chips' traces built on the CPU and runs on the host.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..chips.chip import trace_on
from ..convert import to_numpy
from ..field import babybear as bb
from .types import SEND


def _apply_host(vp, prep_row, main_row):
    acc = vp.constant % bb.P
    for (trace, idx), w in vp.weights:
        col = main_row[idx] if trace == "main" else prep_row[idx]
        acc = (acc + w * int(col)) % bb.P
    return acc


def collect_bus_traffic(machine):
    """Returns {bus: (sends Counter, receives Counter)} of
    (message tuple) -> total multiplicity, plus row provenance."""
    traffic = {}
    provenance = {}
    for chip in machine.chips():
        main = to_numpy(trace_on(chip, machine, "cpu"))
        prep = chip.preprocessed_trace()
        n = main.shape[0]
        if prep is not None:
            prep = np.asarray(prep)
            if prep.shape[0] < n:
                prep = np.concatenate(
                    [prep, np.zeros((n - prep.shape[0], prep.shape[1]),
                                    dtype=prep.dtype)]
                )
        for inter, itype in chip.typed_interactions(machine):
            key = (inter.bus.kind, inter.bus.index)
            sends, recvs = traffic.setdefault(key, (Counter(), Counter()))
            target = sends if itype == SEND else recvs
            for r in range(n):
                prep_row = prep[r] if prep is not None else []
                mult = _apply_host(inter.count, prep_row, main[r])
                if mult == 0:
                    continue
                msg = tuple(
                    _apply_host(f, prep_row, main[r]) for f in inter.fields
                )
                # messages of different field counts are RLC-equal when the
                # extra trailing fields are zero — normalize
                while msg and msg[-1] == 0:
                    msg = msg[:-1]
                target[msg] += mult
                provenance.setdefault((key, msg), []).append(
                    (chip.name, itype, r, mult)
                )
    return traffic, provenance


def report_imbalances(machine, max_items: int = 10) -> str:
    traffic, provenance = collect_bus_traffic(machine)
    lines = []
    for bus, (sends, recvs) in sorted(traffic.items()):
        diff = Counter(sends)
        diff.subtract(recvs)
        bad = {m: c for m, c in diff.items() if c != 0}
        if not bad:
            lines.append(f"bus {bus}: balanced ({sum(sends.values())} msgs)")
            continue
        lines.append(f"bus {bus}: IMBALANCED ({len(bad)} distinct messages)")
        for msg, c in list(bad.items())[:max_items]:
            lines.append(f"  {'+' if c > 0 else ''}{c} x {msg}")
            for who in provenance.get((bus, msg), [])[:4]:
                lines.append(f"      from {who}")
    return "\n".join(lines)
