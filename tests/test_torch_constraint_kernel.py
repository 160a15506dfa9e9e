"""The quotient kernel of valida_tpu_torch/csrc/constraint.cu on the CPU.

Its row interpreter lives in csrc/constraint.cuh as `__host__ __device__`
functions beside `eval_host`, the launch's whole function on the host;
g++ compiles the header (the CUDA macros defined away) into a small ctypes
harness in build/valida_tpu_torch/.  `quotient_rows`' kernel branch runs
on CPU tensors with `_build.launch` replaced by the harness (an emulated
launch: the wrapper's program, tables, parameters and pointers as the card
would get them), and is held word for word against `quotient_rows_plain`
(VectorBuilder), against the JAX package's numpy `quotient_values`, and
through whole proofs against their pinned bytes.  Then the program cache,
the selector tables and the dispatch: a CPU tensor never reaches a launch,
any other device launches or raises.  Skips only where g++ is absent."""

import copy
import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from valida_tpu import backend
from valida_tpu.air import quotient as rquotient
from valida_tpu.commit.fri import FriConfig as RefFriConfig
from valida_tpu.commit.pcs import TwoAdicFriPcs as RefPcs
from valida_tpu.field import babybear as rbb
from valida_tpu.machine import examples as rexamples
from valida_tpu.poly.domain import ZerofierOnCoset as RefZerofier
from valida_tpu.poly.domain import coset_points as ref_coset_points
from valida_tpu_torch import _build
from valida_tpu_torch.air import program, quotient
from valida_tpu_torch.air.lookup import (cumulative_sum, flatten_perm_trace,
                                         generate_permutation_trace)
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.field import babybear as bb
from valida_tpu_torch.field import ext as extf
from valida_tpu_torch.machine import examples
from valida_tpu_torch.parallel.dryrun import ALU_LOOP_SHA256, alu_loop_machine
from valida_tpu_torch.poly import ntt as nttm

P = bb.P
HEADERS = [_build.CSRC / "constraint.cuh", _build.CSRC / "field.cuh"]
CHALLENGES = [(1234567, 7654321, 1111111, 2222222, 3333333),
              (987654321, 12345, 67890, 13579, 24680),
              (P - 1, 5, P - 7, 11, 2013)]
ALPHA = (192837465, 564738291, 1029384756, 5, P - 2)

HARNESS = r"""
#include "constraint.cuh"

extern "C" {
int h_eval(const int32_t* prog, const int32_t* main_lde,
           const int32_t* prep, const int32_t* perm, const int32_t* sel,
           const int32_t* zinv, const int32_t* ch, const int32_t* alpha,
           const int32_t* cum, int32_t* out, const int64_t* params) {
  return cst::eval_host(prog, main_lde, prep, perm, sel, zinv, ch, alpha,
                        cum, out, params);
}
int64_t h_block_rows(const int64_t* params, int has_prep) {
  return cst::block_rows(params, has_prep != 0);
}
void h_constants(int32_t* out) {
  out[0] = cst::N_PARAMS;
  out[1] = cst::OP_ADD; out[2] = cst::OP_SUB; out[3] = cst::OP_MUL;
  out[4] = cst::OP_NEG; out[5] = cst::OP_ACC; out[6] = cst::OP_LOAD;
  out[7] = cst::K_SLOT; out[8] = cst::K_UNI; out[9] = cst::K_MAIN_L;
  out[10] = cst::K_MAIN_N; out[11] = cst::K_PREP_L; out[12] = cst::K_PREP_N;
  out[13] = cst::K_PERM_L; out[14] = cst::K_PERM_N; out[15] = cst::K_SEL;
  out[16] = cst::K_INPUT; out[17] = cst::K_IMM;
  out[18] = cst::E_PARAMS; out[19] = cst::E_SMEM;
  out[20] = (int32_t)(cst::SMEM_MAX / 4);
}
}
"""
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Werror")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers run at once: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def harness():
    """The harness library, built by g++ at first use (named by a hash of
    the headers, the harness and the flags, written to a temporary file
    and renamed into place)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    digest = hashlib.sha256(b"".join(h.read_bytes() for h in HEADERS)
                            + HARNESS.encode()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libconstraint_harness-{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(f".{os.getpid()}.cpp")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(HARNESS)
        proc = subprocess.run(["g++", *FLAGS, f"-I{_build.CSRC}", "-o",
                               str(tmp), str(src)], capture_output=True,
                              text=True)
        src.unlink()
        assert proc.returncode == 0, proc.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.h_eval.argtypes = [ctypes.c_void_p] * 11
    lib.h_eval.restype = ctypes.c_int
    lib.h_block_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.h_block_rows.restype = ctypes.c_int64
    lib.h_constants.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture
def emulated(harness, monkeypatch):
    """`_build.launch` of the constraint library runs `eval_host` in the
    harness on the CPU tensors' words, and raises for its return code as
    `_build.launch` does; returns the parameters of each launch it
    emulated."""
    seen = []
    other = _build.launch

    def launch(lib, fn, *args):
        if lib != "constraint":
            return other(lib, fn, *args)
        assert fn == "constraint_eval_launch" and len(args) == 11
        for a in args[:-1]:
            assert a is None or (a.device.type == "cpu" and a.is_contiguous()
                                 and a.dtype == torch.int32)
        seen.append(list(args[-1]))
        _build.raise_for(fn, harness.h_eval(
            *(None if a is None else a.data_ptr() for a in args[:-1]),
            args[-1]))

    monkeypatch.setattr(_build, "launch", launch)
    saved = dict(_build.LAUNCHES)
    yield seen
    _build.LAUNCHES.update(saved)


@pytest.fixture
def kernel_branch(emulated, monkeypatch):
    """`quotient_rows` takes its kernel branch on CPU tensors, into the
    emulated launch."""
    monkeypatch.setattr(quotient, "_plain_side", lambda main: False)
    return emulated


def _words(rng, shape, edges=True):
    """Random u32 words (any bit pattern, mostly below p), with the edge
    words 0, 1, p - 1 (and p, 2^32 - 1) in a share of the places."""
    w = rng.integers(0, P, shape, dtype=np.uint32)
    if edges:
        flat = w.reshape(-1)
        pick = rng.random(flat.shape[0])
        edge = np.array([0, 1, P - 1, P, 0xFFFFFFFF, rbb.R1], dtype=np.uint32)
        where = pick < 0.25
        flat[where] = edge[rng.integers(0, len(edge), int(where.sum()))]
    return from_reference(w)


def _buffers(rng, machine, chip, rows_total):
    w, pw = chip.width(), chip.preprocessed_width()
    n_perm = len(chip.all_interactions(machine)) + 1
    main = _words(rng, (rows_total, w))
    prep = _words(rng, (rows_total, pw)) if pw else None
    perm = _words(rng, (rows_total, 5 * n_perm))
    return prep, main, perm


def _inputs(rng):
    return (_words(rng, (3, 5), edges=False), _words(rng, (5,), edges=False),
            _words(rng, (5,), edges=False))


BASIC = alu_loop_machine(8)
BASIC_CHIPS = [c.name for c in BASIC.chips()]


def _chip(machine, name):
    return next(c for c in machine.chips() if c.name == name)


@pytest.mark.parametrize("name", BASIC_CHIPS)
def test_every_basic_chip_against_plain(kernel_branch, name):
    """Every BasicMachine chip's program over random rows (edge words
    included) at blowup 2: the kernel branch's words == the plain path's."""
    rng = np.random.default_rng(BASIC_CHIPS.index(name))
    chip = _chip(BASIC, name)
    log_degree, qd, log_blowup = 5, 1, 2
    q = 1 << (log_degree + qd)
    prep, main, perm = _buffers(rng, BASIC, chip, q << (log_blowup - qd))
    ch, al, cs = _inputs(rng)
    args = (BASIC, chip, log_degree, qd, prep, main, perm, cs, ch, al, 31)
    got = quotient.quotient_rows(*args, stride=2)
    want = quotient.quotient_rows_plain(*args, stride=2)
    assert got.shape == (q, 5)
    assert torch.equal(got, want)
    assert len(kernel_branch) == 1


@pytest.mark.parametrize("name", ["cpu", "mem", "div_u32"])
def test_halo_form(kernel_branch, name):
    """A mesh rank's form: a buffer of R + 2^qd natural rows from row0 > 0
    (its block and the halo), no wrap."""
    rng = np.random.default_rng(40)
    chip = _chip(BASIC, name)
    log_degree, qd = 6, 1
    q = 1 << (log_degree + qd)
    rows, row0 = q // 4, 2 * (q // 4)
    prep, main, perm = _buffers(rng, BASIC, chip, rows + (1 << qd))
    ch, al, cs = _inputs(rng)
    args = (BASIC, chip, log_degree, qd, prep, main, perm, cs, ch, al, 31,
            row0)
    got = quotient.quotient_rows(*args, rows=rows)
    want = quotient.quotient_rows_plain(*args, rows=rows)
    assert torch.equal(got, want)
    assert kernel_branch[0][:2] == [rows, rows + (1 << qd)]


@pytest.mark.parametrize("name", ["cpu", "program", "range"])
def test_bit_reversed_in_place(kernel_branch, name):
    """The staged prover's form: the bit-reversed LDE read in place equals
    the plain path on its natural order (`natural()` then [::stride] and
    the roll)."""
    rng = np.random.default_rng(41)
    chip = _chip(BASIC, name)
    log_degree, qd, log_blowup = 5, 1, 3
    length = 1 << (log_degree + log_blowup)
    prep, main, perm = _buffers(rng, BASIC, chip, length)
    ch, al, cs = _inputs(rng)

    def natural(t):
        return None if t is None else nttm._gather_bitrev(
            t, length.bit_length() - 1)

    stride = 1 << (log_blowup - qd)
    got = quotient.quotient_rows(BASIC, chip, log_degree, qd, prep, main,
                                 perm, cs, ch, al, 31, stride=stride,
                                 bitrev=True)
    want = quotient.quotient_rows_plain(
        BASIC, chip, log_degree, qd, natural(prep), natural(main),
        natural(perm), cs, ch, al, 31, stride=stride)
    assert torch.equal(got, want)
    assert kernel_branch[0][3] == length.bit_length() - 1


# the JAX package's machines, built from the same seeds in both packages
MACHINES = {
    "mini": (lambda: rexamples.random_mini_machine(40, seed=5),
             lambda: examples.random_mini_machine(40, seed=5)),
    "ragged": (lambda: rexamples.random_ragged_machine(64, seed=7),
               lambda: examples.random_ragged_machine(64, seed=7)),
}
CHIPS = [(name, ci) for name, n in (("mini", 2), ("ragged", 4))
         for ci in range(n)]


@pytest.mark.parametrize("name,ci", CHIPS)
def test_against_the_jax_package(kernel_branch, name, ci):
    """quotient_values through the kernel branch on the JAX package's own
    LDEs (committed by its numpy PCS) == its numpy quotient_values."""
    ref_m, m = MACHINES[name][0](), MACHINES[name][1]()
    rchip, chip = ref_m.chips()[ci], m.chips()[ci]
    trace = np.asarray(rchip.generate_trace(ref_m), dtype=np.uint32)
    log_degree = trace.shape[0].bit_length() - 1
    qd = rquotient.get_log_quotient_degree(ref_m, rchip)
    perm = generate_permutation_trace(m, chip, from_reference(trace),
                                      CHALLENGES)
    cs = cumulative_sum(perm)
    pcs = RefPcs(RefFriConfig(), coset_shift=rbb.GENERATOR)
    prep = rchip.preprocessed_trace()
    with backend.use_backend("numpy"):
        mats = [trace, to_numpy(flatten_perm_trace(perm))]
        if prep is not None:
            mats.append(np.asarray(prep, dtype=np.uint32))
        ldes = [np.asarray(lde) for lde in
                pcs.get_ldes(pcs.commit_batches(mats)[1])]
        prep_lde = ldes[2] if prep is not None else None
        want = np.asarray(rquotient.quotient_values(
            ref_m, rchip, log_degree, qd, prep_lde, ldes[0], ldes[1], cs,
            CHALLENGES, ALPHA, pcs.coset_shift(), pcs.log_blowup))
    got = quotient.quotient_values(
        m, chip, log_degree, qd,
        None if prep_lde is None else from_reference(prep_lde),
        from_reference(ldes[0]), from_reference(ldes[1]), cs, CHALLENGES,
        ALPHA, pcs.coset_shift(), pcs.log_blowup)
    np.testing.assert_array_equal(to_numpy(got), want)
    assert len(kernel_branch) == 1


def test_kernel_branch_proves_the_fixture(kernel_branch):
    """The golden fixture's machine proved with every quotient through the
    kernel branch gives the fixture's bytes, by the eager and the staged
    prover (the LDEs read in natural order with a stride, and bit-reversed
    in place)."""
    from tests.test_torch_machine import FIXTURE
    from valida_tpu_torch.core.config import default_config
    from valida_tpu_torch.machine import jit_prover
    from valida_tpu_torch.tooling.serde import serialize_proof

    with open(FIXTURE, "rb") as f:
        want = f.read()
    m = examples.random_mini_machine(48, seed=3)
    cfg = default_config(num_queries=3, proof_of_work_bits=1, device="cpu")
    assert serialize_proof(m.prove(cfg)) == want
    n_eager = len(kernel_branch)
    assert n_eager == len(m.chips())
    assert serialize_proof(jit_prover.prove_jit(m, cfg)) == want
    assert len(kernel_branch) == 2 * n_eager
    assert all(p[3] > 0 for p in kernel_branch[n_eager:])  # bit-reversed


def test_kernel_branch_proves_the_alu_loop(kernel_branch):
    """The ALU loop at 2^13 cycles, every chip's quotient through the
    kernel branch: the JAX package's pinned bytes."""
    from valida_tpu_torch.core.config import default_config
    from valida_tpu_torch.tooling.serde import serialize_proof

    m = alu_loop_machine(13)
    proof = m.prove(default_config(debug_checks=False, device="cpu"))
    assert (hashlib.sha256(serialize_proof(proof)).hexdigest()
            == ALU_LOOP_SHA256[13])
    assert len(kernel_branch) == len(m.chips())


# ---------------------------------------------------------------------------
# The program: its encoding, its cache
# ---------------------------------------------------------------------------


def test_encoding_constants(harness):
    out = np.zeros(21, dtype=np.int32)
    harness.h_constants(out.ctypes.data)
    assert out[0] == len(quotient._PARAMS()) == 12
    assert list(out[1:7]) == [program.OP_ADD, program.OP_SUB, program.OP_MUL,
                              program.OP_NEG, program.OP_ACC,
                              program.OP_LOAD]
    assert list(out[7:18]) == list(range(11))
    assert [program.K_SLOT, program.K_UNI, program.K_MAIN_L,
            program.K_IMM] == [out[7], out[8], out[9], out[17]]
    assert set(_build.REFUSALS) == {out[18], out[19]}
    assert "shared memory" in _build.REFUSALS[out[19]]


def test_program_cache():
    """A program is built once per chip object, log_degree and machine:
    two machines of one type never share one, nor two heights (the mul
    chip's counter constraint reads trace_height)."""
    m1, m2 = alu_loop_machine(6), alu_loop_machine(6)
    c1, c2 = _chip(m1, "mul_u32"), _chip(m2, "mul_u32")
    p1 = program.chip_program(m1, c1, 6)
    assert program.chip_program(m1, c1, 6) is p1
    p2 = program.chip_program(m2, c2, 6)
    assert p2 is not p1
    p3 = program.chip_program(m1, c1, 7)
    assert p3 is not p1
    imms = lambda p: {int(w) for c, _d, a, b in p.code  # noqa: E731
                      for kind, w in (((c >> 8) & 15, a), ((c >> 12) & 15, b))
                      if kind == program.K_IMM}
    assert bb.monty_scalar(1 << 6) in imms(p1)
    assert bb.monty_scalar(1 << 7) in imms(p3)
    assert not np.array_equal(p1.code, p3.code)
    assert np.array_equal(p1.code, p2.code)  # the same chip, rebuilt
    # different chips of one machine: different programs
    assert program.chip_program(m1, _chip(m1, "cpu"), 6) is not p1


def test_program_shape():
    """Uniform instructions first (the inputs it reads loaded, the alpha
    powers); one ACC per constraint in the row program; slots within the
    count."""
    prog = program.chip_program(BASIC, _chip(BASIC, "cpu"), 8)
    ops = prog.code[:, 0] & 15
    uni = (prog.code[:, 0] >> 6) & 1
    assert (uni[:prog.n_uniform] == 1).all() and (uni[prog.n_uniform:] == 0).all()
    assert (ops[prog.n_uniform:] == program.OP_ACC).sum() == prog.n_constraints
    loads = prog.code[:prog.n_uniform][ops[:prog.n_uniform] == program.OP_LOAD]
    assert {program.IN_ALPHA, program.IN_CUM} <= set(loads[:, 2].tolist())
    assert set(loads[:, 2].tolist()) <= set(range(5))  # only what is read
    row = prog.code[prog.n_uniform:]
    written = row[row[:, 0] & 15 != program.OP_ACC]
    ext = ((written[:, 0] >> 4) | (written[:, 0] >> 5)) & 1
    assert (written[:, 1] + np.where(ext == 1, 5, 1)).max() <= prog.slot_words


# ---------------------------------------------------------------------------
# The selector tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_degree,qd,row0,rows", [(5, 1, 0, 64),
                                                     (4, 2, 16, 32),
                                                     (6, 1, 64, 32)])
def test_selector_tables_are_todays_words(log_degree, qd, row0, rows):
    """The tables hold the words the JAX package's host branch computes
    (Lagrange selectors, Z_H^-1 over a period, x - g^-1)."""
    shift = rbb.GENERATOR
    sel, zinv = quotient.selector_tables(log_degree, qd, shift, row0, rows,
                                         "cpu")
    zc = RefZerofier(log_degree, qd, shift)
    span = slice(row0, row0 + rows)
    xs = ref_coset_points(log_degree + qd, shift)
    sub_last = rbb.monty_scalar(rbb.h_inv(rbb.two_adic_generator(log_degree)))
    want = np.stack([zc.lagrange_basis_unnormalized(0)[span],
                     zc.lagrange_basis_unnormalized((1 << log_degree) - 1)
                     [span], rbb.sub(xs, np.uint32(sub_last))[span]])
    np.testing.assert_array_equal(to_numpy(sel), want)
    np.testing.assert_array_equal(to_numpy(zinv), zc._zinv_period)
    assert quotient.selector_tables(log_degree, qd, shift, row0, rows,
                                    "cpu")[0] is sel  # once per shape
    first, last, trans, zp = quotient._selector_vectors(
        log_degree, qd, shift, torch.device("cpu"), row0, rows)
    assert torch.equal(torch.stack([first, last, trans]), sel)
    assert torch.equal(zp, zinv)


def test_release_graphs_drops_the_selector_tables():
    """The tables live as long as the staged prover's graphs, which read
    them: `release_graphs` drops both; the next call builds them anew."""
    from valida_tpu_torch.machine import jit_prover

    shift = rbb.GENERATOR
    sel, _ = quotient.selector_tables(5, 1, shift, 0, 64, "cpu")
    assert quotient.selector_tables(5, 1, shift, 0, 64, "cpu")[0] is sel
    jit_prover.release_graphs()
    assert not quotient._SELECTORS
    again, _ = quotient.selector_tables(5, 1, shift, 0, 64, "cpu")
    assert again is not sel and torch.equal(again, sel)


# the field functions that dispatch to csrc/field.cu on the card
DISPATCHING = {bb: ("mul", "add", "sub", "neg", "double", "to_monty",
                    "from_monty", "from_wrapped_u32", "exp", "inv",
                    "inv_batch"),
               extf: ("ext_mul", "ext_inv", "ext_mul_base", "ext_add",
                      "ext_sub", "ext_neg", "ext_scale", "frobenius",
                      "ext_exp")}


@pytest.mark.parametrize("name", ["cpu", "range", "mul_u32"])
def test_plain_version_calls_no_field_kernel(monkeypatch, name):
    """quotient_rows_plain computes with the `*_plain` field functions
    alone (selectors, constraints, fold, 1/Z_H), so on the card it shares
    no CUDA code with the kernel it is held against: with every
    dispatching field function refused, it gives the same words."""
    rng = np.random.default_rng(BASIC_CHIPS.index(name) + 50)
    chip = _chip(BASIC, name)
    prep, main, perm = _buffers(rng, BASIC, chip, 128)
    ch, al, cs = _inputs(rng)
    args = (BASIC, chip, 5, 1, prep, main, perm, cs, ch, al, 31)
    want = quotient.quotient_rows_plain(*args, stride=2)
    host = quotient.quotient_rows_plain(
        *args[:7], CHALLENGES[0], CHALLENGES, ALPHA, 31, stride=2)
    for mod, names in DISPATCHING.items():
        for fn in names:
            monkeypatch.setattr(mod, fn, lambda *a, _fn=fn: pytest.fail(
                f"the plain version called {_fn}"))
    assert torch.equal(quotient.quotient_rows_plain(*args, stride=2), want)
    assert torch.equal(quotient.quotient_rows_plain(
        *args[:7], CHALLENGES[0], CHALLENGES, ALPHA, 31, stride=2), host)


# ---------------------------------------------------------------------------
# Dispatch: a CPU tensor runs the plain path, never a launch; any other
# device launches the kernel or raises
# ---------------------------------------------------------------------------


def test_cpu_tensors_never_launch(monkeypatch):
    def refuse(*args):
        raise AssertionError(f"a CPU tensor reached a launch: {args[:2]}")

    monkeypatch.setattr(_build, "launch", refuse)
    rng = np.random.default_rng(3)
    chip = _chip(BASIC, "add_u32")
    prep, main, perm = _buffers(rng, BASIC, chip, 64)
    ch, al, cs = _inputs(rng)
    args = (BASIC, chip, 4, 1, prep, main, perm, cs, ch, al, 31)
    assert torch.equal(quotient.quotient_rows(*args, stride=2),
                       quotient.quotient_rows_plain(*args, stride=2))


def _meta(shape):
    return torch.zeros(shape, dtype=torch.int32, device="meta")


def test_other_devices_launch(monkeypatch):
    """On tensors off the CPU (here `meta`, which has no data) the kernel
    branch calls its entry once and counts one launch; the plain path is
    not called."""
    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda *args: launched.append(args))
    monkeypatch.setattr(quotient, "quotient_rows_plain",
                        lambda *a, **k: pytest.fail("plain"))
    monkeypatch.setattr(quotient, "selector_tables",
                        lambda *a: (_meta((3, 32)), _meta((2,))))
    chip = _chip(BASIC, "cpu")
    w, _pw, n_perm = program.chip_program(BASIC, chip, 4).widths
    saved = dict(_build.LAUNCHES)
    try:
        out = quotient.quotient_rows(
            BASIC, chip, 4, 1, None, _meta((64, w)), _meta((64, 5 * n_perm)),
            _meta((5,)), _meta((3, 5)), _meta((5,)), 31, stride=2)
        assert out.device.type == "meta" and tuple(out.shape) == (32, 5)
        assert len(launched) == 1
        assert launched[0][:2] == ("constraint", "constraint_eval_launch")
        assert _build.LAUNCHES["constraint_eval"] == saved["constraint_eval"] + 1
    finally:
        _build.LAUNCHES.update(saved)


@pytest.mark.parametrize("bad", ["int64", "width", "not contiguous",
                                 "missing prep", "host ext on meta"])
def test_what_the_kernel_does_not_take_raises(monkeypatch, bad):
    monkeypatch.setattr(_build, "launch",
                        lambda *args: pytest.fail("launched"))
    monkeypatch.setattr(quotient, "selector_tables",
                        lambda *a: (_meta((3, 32)), _meta((2,))))
    name = "range" if bad == "missing prep" else "cpu"
    chip = _chip(BASIC, name)
    w, pw, n_perm = program.chip_program(BASIC, chip, 4).widths
    main, perm = _meta((64, w)), _meta((64, 5 * n_perm))
    prep = _meta((64, pw)) if pw else None
    ch = _meta((3, 5))
    if bad == "int64":
        main = main.to(torch.int64)
    elif bad == "width":
        main = _meta((64, w + 1))
    elif bad == "not contiguous":
        main = _meta((w, 64)).t()
    elif bad == "missing prep":
        prep = None
    else:
        ch = CHALLENGES
    with pytest.raises(ValueError):
        quotient.quotient_rows(BASIC, chip, 4, 1, prep, main, perm,
                               _meta((5,)), ch, _meta((5,)), 31, stride=2)


def _fitting_slot_words(harness, prog, qd, rows):
    """The most slot words with which a block of `rows` rows still fits
    (csrc/constraint.cuh `smem_words` against SMEM_MAX)."""
    consts = np.zeros(21, dtype=np.int32)
    harness.h_constants(consts.ctypes.data)
    w, pw, n_perm = prog.widths
    staged = (rows + (1 << qd)) * sum((c | 1) if c else 0
                                      for c in (w, pw, 5 * n_perm))
    return (int(consts[20]) - prog.uni_words - staged) // rows


def _block_rows(harness, prog, qd, slot_words, has_prep=False, lq=64):
    w, pw, n_perm = prog.widths
    params = quotient._PARAMS(32, lq, 2, -1, qd, w, pw, 5 * n_perm,
                              prog.n_uniform, prog.n_row, prog.uni_words,
                              slot_words)
    return harness.h_block_rows(params, int(has_prep))


def test_block_rows(harness):
    """The entry takes the most rows a block of 128, 64 or 32 whose shared
    memory fits, and refuses the rest."""
    prog = program.chip_program(BASIC, _chip(BASIC, "cpu"), 4)
    assert _block_rows(harness, prog, 1, prog.slot_words) == 128
    for rows in (128, 64, 32):
        most = _fitting_slot_words(harness, prog, 1, rows)
        assert _block_rows(harness, prog, 1, most) == rows
        assert _block_rows(harness, prog, 1, most + 1) == (
            rows // 2 if rows > 32 else -2)
    assert _block_rows(harness, prog, 11, prog.slot_words) == -1  # qd
    assert _block_rows(harness, prog, 1, prog.slot_words, lq=0) == -1
    prep_prog = program.chip_program(BASIC, _chip(BASIC, "range"), 4)
    assert prep_prog.widths[1] > 0
    assert _block_rows(harness, prep_prog, 1, prep_prog.slot_words) == -1
    assert _block_rows(harness, prep_prog, 1, prep_prog.slot_words,
                       has_prep=True) == 128


def test_a_program_too_large_raises(kernel_branch, harness, monkeypatch):
    """A program whose slots do not fit a block's shared memory at the
    fewest rows is refused by the entry, and the wrapper raises; it never
    takes the plain path.  One word fewer runs, at 32 rows a block."""
    rng = np.random.default_rng(5)
    chip = _chip(BASIC, "cpu")
    prep, main, perm = _buffers(rng, BASIC, chip, 64)
    ch, al, cs = _inputs(rng)
    args = (BASIC, chip, 4, 1, prep, main, perm, cs, ch, al, 31)
    want = quotient.quotient_rows_plain(*args, stride=2)
    monkeypatch.setattr(quotient, "quotient_rows_plain",
                        lambda *a, **k: pytest.fail("plain"))
    big = copy.copy(program.chip_program(BASIC, chip, 4))
    monkeypatch.setattr(quotient, "chip_program", lambda *a: big)
    most = _fitting_slot_words(harness, big, 1, 32)
    big.slot_words = most + 1
    with pytest.raises(ValueError, match="shared memory"):
        quotient.quotient_rows(*args, stride=2)
    big.slot_words = most
    assert _block_rows(harness, big, 1, most) == 32
    assert torch.equal(quotient.quotient_rows(*args, stride=2), want)
    assert len(kernel_branch) == 2


def test_build_carries_the_constraint_kernel():
    assert set(_build.SIGNATURES["constraint"]) == {"constraint_eval_launch"}
    assert "constraint_eval" in _build.LAUNCHES
    assert "constraint_eval" in _build.CAPTURED
    src = (_build.CSRC / "constraint.cu").read_text()
    assert 'extern "C" int constraint_eval_launch(' in src
    head = src[src.index("int constraint_eval_launch("):]
    args = head[head.index("(") + 1:head.index(")")]
    assert args.count(",") + 1 == len(
        _build.SIGNATURES["constraint"]["constraint_eval_launch"]) == 12
