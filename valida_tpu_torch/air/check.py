"""Debug constraint checker — row-wise zero-checking of every constraint on
the trace domain, plus bus-balance assertion.

Counterpart of valida_tpu/air/check.py (the Rust machine crate's
check_constraints.rs / debug_builder.rs): run inside prove() when debug
checking is enabled, it catches witness/AIR divergence at the exact chip
before anything is committed.  The rows are checked on the traces' device;
only one flag per constraint (and, on a failure, the failing rows) comes
back to the host.
"""

from __future__ import annotations

import torch

from ..field import babybear as bb
from ..field import ext as extf
from .builder import VectorBuilder, VVal
from .lookup import eval_permutation_constraints, padded_prep


def check_constraints(machine, chip, main_trace, perm_trace, perm_challenges,
                      cumulative_sum_value):
    """Assert every constraint of `chip` vanishes on all trace rows.

    main_trace: canonical int32 tensor [N, C]; perm_trace: the [N, K, 5]
    Montgomery tensor `generate_permutation_trace` returns, on the same
    device."""
    dev = main_trace.device
    n = int(main_trace.shape[0])

    def window(arr):
        local = [VVal(arr[:, c], False) for c in range(arr.shape[1])]
        rolled = torch.roll(arr, -1, dims=0)
        nxt = [VVal(rolled[:, c], False) for c in range(arr.shape[1])]
        return local, nxt

    main_local, main_next = window(bb.to_monty(main_trace))
    prep = padded_prep(chip, n, dev)
    prep_local, prep_next = (window(bb.to_monty(prep)) if prep is not None
                             else ([], []))

    k = perm_trace.shape[1]
    perm_local = [VVal(perm_trace[:, i], True) for i in range(k)]
    perm_rolled = torch.roll(perm_trace, -1, dims=0)
    perm_next = [VVal(perm_rolled[:, i], True) for i in range(k)]

    idx = torch.arange(n, device=dev)

    def selector(mask):
        return VVal(torch.where(mask, bb.ONE, 0).to(torch.int32), False)

    builder = VectorBuilder(
        machine,
        main_local=main_local,
        main_next=main_next,
        prep_local=prep_local,
        prep_next=prep_next,
        perm_local=perm_local,
        perm_next=perm_next,
        perm_challenges=[VVal(extf.ext_const(c, dev), True)
                         for c in perm_challenges],
        is_first_row=selector(idx == 0),
        is_last_row=selector(idx == n - 1),
        is_transition=selector(idx < n - 1),
        trace_height=n,
    )
    chip.eval(builder)
    eval_permutation_constraints(chip, builder, cumulative_sum_value)

    if not builder.collected:
        return
    # a constraint's words are zero iff its canonical words are (0 is the
    # Montgomery form of 0): one flag each, one copy to the host
    nonzero = torch.stack([c._as_ext().ne(0).any()
                           for c in builder.collected]).tolist()
    for ci, bad in enumerate(nonzero):
        if bad:
            vals = builder.collected[ci]._as_ext()
            rows = torch.nonzero(vals.ne(0).any(dim=-1).reshape(-1))
            raise AssertionError(
                f"chip {chip.name}: constraint #{ci} nonzero at rows "
                f"{rows[:5, 0].tolist()} (of {n})"
            )


def check_cumulative_sums(cumulative_sums):
    total = extf.E_ZERO
    for cs in cumulative_sums:
        total = extf.e_add(total, cs)
    assert total == extf.E_ZERO, (
        f"bus imbalance: sum of cumulative sums = {total}"
    )
