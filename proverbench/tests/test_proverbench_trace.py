"""The traced run's reduction and the frozen rooflines."""

import json

import pytest

import roofline
import spec
import trace


def _events():
    us = 1e6
    X = lambda cat, name, s, d: {"ph": "X", "cat": cat, "name": name,
                                 "ts": s * us, "dur": d * us}
    return [
        X("user_annotation", trace.WINDOW, 0.0, 10.0),
        X("user_annotation", "job: prove", 1.5, 6.5),
        X("user_annotation", "compute quotient polynomial", 2.0, 2.0),
        X("gpu_user_annotation", "compute quotient polynomial", 2.0, 1.5),
        X("kernel", "constraint_eval", 2.0, 1.0),
        X("kernel", "field_elementwise", 2.5, 1.0),
        X("gpu_memcpy", "Memcpy HtoD", 6.0, 1.0),
        X("kernel", "outside the window", 11.0, 1.0),
        X("cpu_op", "aten::add", 2.0, 0.1),
    ]


def test_trace_reduction():
    t = trace.Trace(_events())
    assert t.window_s == 10.0
    assert t.busy_s == pytest.approx(2.5)  # [2, 3.5] and [6, 7]
    assert len(t.ops) == 3
    assert t.busy_in({"compute quotient polynomial"}) == pytest.approx(1.5)
    assert t.busy_in({"no such stage"}) is None
    b = t.breakdown()
    assert b["device_ops"] == [["constraint_eval", 1.0],
                               ["field_elementwise", 1.0],
                               ["Memcpy HtoD", 1.0]]
    # gaps [0, 2], [3.5, 6], [7, 10] against the host: outside [0, 1.5),
    # the prove [1.5, 2), the quotient [2, 4), the prove [4, 8), outside
    idle = dict(b["idle_gaps"])
    assert idle == pytest.approx({"outside every range": 1.5 + 2.0,
                                  "job: prove": 0.5 + 2.0 + 1.0,
                                  "compute quotient polynomial": 0.5})
    assert sum(idle.values()) == pytest.approx(10.0 - 2.5)


def test_tree_permutations():
    # 4 rows of 40 words (2 blocks each) and 2 rows of 10 words (1 block):
    # 8 leaf blocks; level 1: 2 pairs, 2 rows hashed, 2 injections; level
    # 0: 1 pair
    assert roofline.tree_permutations([(2, 40), (1, 10)]) == 8 + 2 + 2 + 2 + 1


def test_frozen_quotient_bound(small_cell):
    """The frozen issue slots of each chip's constraint row are what
    chip_smoke.py's `constraint_slots` counts for the port's program at
    that height, and both rooflines of every cell are bound by
    operations."""
    import chip_smoke
    import port
    from valida_tpu_torch.air.program import chip_program

    m = port.execute(spec.job_program(small_cell, 5, 0),
                     small_cell.program["fp"])
    for chip in m.chips():
        frozen = small_cell.size["chips"][chip.name]
        prog = chip_program(m, chip, frozen["log_height"])
        assert frozen["quotient_slots"] == chip_smoke.constraint_slots(prog)
    bench = spec.benchmark()
    for w in bench["workloads"]:
        size = spec.cell(bench, w["name"]).size
        assert roofline.quotient_bound(size)[1] == "operations"
        assert roofline.commit_bound(size, 1)[1] == "operations"
