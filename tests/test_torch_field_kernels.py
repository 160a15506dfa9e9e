"""The field kernels of valida_tpu_torch/csrc/field.cu on the CPU.

Their arithmetic lives in csrc/field.cuh as `__host__ __device__`
functions; g++ compiles the same header (the CUDA macros defined away) into
a small ctypes harness in build/valida_tpu_torch/, which is held word for
word against the port's plain versions and the JAX package's numpy
functions, on edge words and on 10^5 random words from a numpy seed.  The
wrappers' layouts (broadcast strides, merged dims) are held by running each
wrapper's kernel branch on CPU tensors with `_build.launch` replaced by an
emulator: the kernels' own indexing in numpy around the harness's words.
Then the dispatch: a CPU tensor never reaches a launch, any other device
launches or raises.  Skips only where g++ is absent."""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from valida_tpu.field import babybear as rbb
from valida_tpu.field import ext as rext
from valida_tpu_torch import _build
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.field import babybear as bb
from valida_tpu_torch.field import ext as extf

P = bb.P
N_RANDOM = 100_000
HEADER = _build.CSRC / "field.cuh"

# the harness: each of field.cuh's per-element entries over a flat array
HARNESS = r"""
#include "field.cuh"

extern "C" {
void h_elementwise(int op, const int32_t* a, const int32_t* b, int32_t* out,
                   int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    switch (op) {
      case bbf::OP_MUL:
        out[i] = bbf::apply_elementwise<bbf::OP_MUL>(a[i], b[i]); break;
      case bbf::OP_ADD:
        out[i] = bbf::apply_elementwise<bbf::OP_ADD>(a[i], b[i]); break;
      case bbf::OP_SUB:
        out[i] = bbf::apply_elementwise<bbf::OP_SUB>(a[i], b[i]); break;
      case bbf::OP_NEG:
        out[i] = bbf::apply_elementwise<bbf::OP_NEG>(a[i], b[i]); break;
      case bbf::OP_TO_MONTY:
        out[i] = bbf::apply_elementwise<bbf::OP_TO_MONTY>(a[i], b[i]); break;
      case bbf::OP_FROM_MONTY:
        out[i] = bbf::apply_elementwise<bbf::OP_FROM_MONTY>(a[i], b[i]);
        break;
      default:
        out[i] = bbf::apply_elementwise<bbf::OP_FROM_WRAPPED_U32>(a[i], b[i]);
    }
  }
}
void h_ext_mul(const int32_t* a, const int32_t* b, int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    bbf::apply_ext_mul(a + 5 * i, 1, b + 5 * i, 1, out + 5 * i);
}
void h_inv(const int32_t* a, int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = bbf::apply_inv(a[i]);
}
void h_ext_inv(const int32_t* a, int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    bbf::apply_ext_inv(a + 5 * i, 1, out + 5 * i);
}
void h_constants(uint32_t* out) {
  out[0] = bbf::P; out[1] = bbf::MONTY_MU; out[2] = bbf::R1; out[3] = bbf::R2;
  for (int i = 0; i < bbf::D; ++i) out[4 + i] = bbf::frob(i);
  out[9] = bbf::N_OPS;
}
}
"""
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Werror")


@pytest.fixture(scope="module")
def harness():
    """The harness library, built by g++ at first use (named by a hash of
    the header, the harness and the flags, written to a temporary file and
    renamed into place, as native/build.py builds the interpreter core)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    digest = hashlib.sha256(HEADER.read_bytes() + HARNESS.encode()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libfield_harness-{digest}.so"
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
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.h_elementwise.argtypes = [ctypes.c_int, vp, vp, vp, i64]
    lib.h_ext_mul.argtypes = [vp, vp, vp, i64]
    lib.h_inv.argtypes = [vp, vp, i64]
    lib.h_ext_inv.argtypes = [vp, vp, i64]
    lib.h_constants.argtypes = [vp]
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def h_elementwise(lib, op: str, a, b=None) -> np.ndarray:
    """The harness's words of op on int32 (or u32) arrays of one shape."""
    a = np.ascontiguousarray(a).view(np.int32)
    b = a if b is None else np.ascontiguousarray(b).view(np.int32)
    out = np.empty_like(a)
    lib.h_elementwise(bb.OPS[op], _ptr(a), _ptr(b), _ptr(out), a.size)
    return out.view(np.uint32)


def h_ext(lib, fn: str, *args) -> np.ndarray:
    args = [np.ascontiguousarray(x).view(np.int32) for x in args]
    out = np.empty_like(args[0])
    getattr(lib, fn)(*map(_ptr, args), _ptr(out), args[0].size // 5)
    return out.view(np.uint32)


def edge_words() -> np.ndarray:
    """u32 words where the arithmetic turns: 0, 1, p - 1, p, 2p - 1, 2p,
    2^31 - 1, 2^31 (the first negative int32), R, 0x77FFFFFF, 2^32 - 1."""
    return np.array([0, 1, 2, P - 2, P - 1, P, P + 1, 2 * P - 1, 2 * P,
                     (1 << 31) - 1, 1 << 31, (1 << 31) + 1, rbb.R1,
                     0x77FFFFFF, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)


def operands(seed: int, canonical: bool):
    """(a, b) u32 arrays: every pair of edge words, then N_RANDOM random
    words each (below p, or any u32 bit pattern)."""
    e = edge_words()
    if canonical:
        e = e[e < P]
    rng = np.random.default_rng(seed)
    top = P if canonical else 1 << 32
    a = np.concatenate([np.repeat(e, len(e)),
                        rng.integers(0, top, N_RANDOM, dtype=np.uint32)])
    b = np.concatenate([np.tile(e, len(e)),
                        rng.integers(0, top, N_RANDOM, dtype=np.uint32)])
    return a, b


def plain(name: str, *args) -> np.ndarray:
    fn = getattr(bb, f"{name}_plain")
    return to_numpy(fn(*[from_reference(x) for x in args]))


BINARY = ["mul", "add", "sub"]
UNARY = ["neg", "to_monty", "from_monty", "from_wrapped_u32"]


def test_constants(harness):
    out = np.zeros(10, dtype=np.uint32)
    harness.h_constants(_ptr(out))
    assert list(out[:4]) == [rbb.P, rbb.MONTY_MU, rbb.R1, rbb.R2]
    assert list(out[4:9]) == extf._FROB_COEFFS_MONTY
    assert list(out[4:9]) == [int(x) for x in rext._FROB_COEFFS_MONTY]
    assert out[9] == len(bb.OPS) and sorted(bb.OPS.values()) == list(range(7))


@pytest.mark.parametrize("op", BINARY + UNARY)
def test_elementwise_on_canonical_words(harness, op):
    """The JAX package's numpy function, the port's plain version and the
    harness agree on words below p (any u32 for from_wrapped_u32)."""
    a, b = operands(1, canonical=op != "from_wrapped_u32")
    args = (a, b) if op in BINARY else (a,)
    got = h_elementwise(harness, op, *args)
    np.testing.assert_array_equal(got, getattr(rbb, op)(*args))
    np.testing.assert_array_equal(got, plain(op, *args))


@pytest.mark.parametrize("op", BINARY + UNARY)
def test_elementwise_on_any_word(harness, op):
    """On every int32 word (>= p, negative bit patterns) the harness
    computes the plain version's function, which reads a word as a signed
    value (from_wrapped_u32: as unsigned)."""
    a, b = operands(2, canonical=False)
    args = (a, b) if op in BINARY else (a,)
    np.testing.assert_array_equal(h_elementwise(harness, op, *args),
                                  plain(op, *args))


def test_double(harness):
    a, _ = operands(3, canonical=False)
    np.testing.assert_array_equal(h_elementwise(harness, "add", a, a),
                                  plain("double", a))


def _inv_words(lib, a):
    a = np.ascontiguousarray(a).view(np.int32)
    out = np.empty_like(a)
    lib.h_inv(_ptr(a), _ptr(out), a.size)
    return out.view(np.uint32)


def test_inv(harness):
    a, _ = operands(4, canonical=True)
    a = a[:20_000]  # the plain version's square and multiply is slow
    got = _inv_words(harness, a)
    np.testing.assert_array_equal(got, rbb.inv(a))
    np.testing.assert_array_equal(got, plain("inv", a))
    np.testing.assert_array_equal(got, plain("inv_batch", a))
    assert got[0] == 0  # 0 -> 0
    wild, _ = operands(5, canonical=False)
    wild = wild[:4_000]
    np.testing.assert_array_equal(_inv_words(harness, wild),
                                  plain("inv", wild))
    # a word that is 0 mod p (p, 2p, -p) is set aside, not the whole tree
    np.testing.assert_array_equal(plain("inv_batch", wild),
                                  plain("inv", wild))


def ext_operands(seed: int, canonical: bool):
    """[n, 5] u32: N_RANDOM // 5 random elements, then elements of edge
    words (zero, one, every coefficient p - 1, ...)."""
    rng = np.random.default_rng(seed)
    top = P if canonical else 1 << 32
    a = rng.integers(0, top, (N_RANDOM // 5, 5), dtype=np.uint32)
    b = rng.integers(0, top, (N_RANDOM // 5, 5), dtype=np.uint32)
    e = edge_words()
    if canonical:
        e = e[e < P]
    a[:len(e)] = e[:, None]
    b[:len(e)] = e[::-1, None]
    a[len(e)] = 0
    a[len(e) + 1] = [rbb.R1, 0, 0, 0, 0]
    b[len(e) + 2, 1:] = 0
    return a, b


def test_ext_mul(harness):
    a, b = ext_operands(7, canonical=True)
    got = h_ext(harness, "h_ext_mul", a, b)
    np.testing.assert_array_equal(got, rext.ext_mul(a, b))
    np.testing.assert_array_equal(got, to_numpy(extf.ext_mul_plain(
        from_reference(a), from_reference(b))))
    a, b = ext_operands(8, canonical=False)
    np.testing.assert_array_equal(
        h_ext(harness, "h_ext_mul", a, b),
        to_numpy(extf.ext_mul_plain(from_reference(a), from_reference(b))))


def test_ext_inv(harness):
    a, _ = ext_operands(9, canonical=True)
    got = h_ext(harness, "h_ext_inv", a)
    np.testing.assert_array_equal(got, rext.ext_inv(a))
    np.testing.assert_array_equal(got, to_numpy(extf.ext_inv_plain(
        from_reference(a))))
    assert not got[np.all(a == 0, axis=1)].any()  # 0 -> 0
    a, _ = ext_operands(10, canonical=False)
    a = a[:4_000]
    np.testing.assert_array_equal(
        h_ext(harness, "h_ext_inv", a),
        to_numpy(extf.ext_inv_plain(from_reference(a))))


# ---------------------------------------------------------------------------
# The wrappers' layouts: their kernel branches on CPU tensors, the launch
# emulated (csrc/field.cu's indexing in numpy, the harness's arithmetic)
# ---------------------------------------------------------------------------


def _storage(t):
    """t's storage as a flat int32 numpy array, and t's offset in it."""
    flat = torch.as_strided(t, (t.untyped_storage().nbytes() // 4,), (1,), 0)
    return flat.numpy(), t.storage_offset()


def _offsets(layout):
    """Each element's word offsets into the two operands, as the kernels'
    `offsets` computes them."""
    n, nd = layout[0], layout[1]
    sizes = layout[2:2 + nd]
    sa, sb = layout[8:8 + nd], layout[14:14 + nd]
    i = np.arange(n, dtype=np.int64)
    oa = np.zeros(n, dtype=np.int64)
    ob = np.zeros(n, dtype=np.int64)
    for d in range(nd - 1, -1, -1):
        i, r = np.divmod(i, sizes[d])
        oa += r * sa[d]
        ob += r * sb[d]
    return oa, ob


@pytest.fixture
def emulated(harness, monkeypatch):
    """`_build.launch` of the field library runs the kernel's indexing in
    numpy around the harness; returns the launches it emulated."""
    seen = []

    def launch(lib, fn, *args):
        assert lib == "field"
        layout = list(args[-1])
        seen.append((fn, layout))
        oa, ob = _offsets(layout)
        if fn == "field_elementwise_launch":
            op, ta, tb, wa, wb, out, _ = args
            x = (np.full(oa.shape, wa, np.int32) if ta is None
                 else (lambda s, o: s[o + oa])(*_storage(ta)))
            y = (np.full(ob.shape, wb, np.int32) if tb is None
                 else (lambda s, o: s[o + ob])(*_storage(tb)))
            name = {v: k for k, v in bb.OPS.items()}[op]
            words = h_elementwise(harness, name, x, y)
        else:
            ta, out = args[0], args[-2]
            ca, cb = layout[20], layout[21]
            coef = np.arange(5, dtype=np.int64)
            s, o = _storage(ta)
            x = s[o + oa[:, None] + coef * ca]
            if fn == "field_ext_mul_launch":
                s, o = _storage(args[1])
                y = s[o + ob[:, None] + coef * cb]
                words = h_ext(harness, "h_ext_mul", x, y)
            elif fn == "field_ext_inv_launch":
                words = h_ext(harness, "h_ext_inv", x)
            else:
                words = _inv_words(harness, x[:, 0].copy())
        out.view(-1).copy_(torch.from_numpy(words.view(np.int32).reshape(-1)))

    monkeypatch.setattr(_build, "launch", launch)
    saved = dict(_build.LAUNCHES)
    yield seen
    _build.LAUNCHES.update(saved)


def _field(shape, seed, top=P):
    rng = np.random.default_rng(seed)
    return from_reference(rng.integers(0, top, shape, dtype=np.uint32))


# the broadcast patterns of the prover's calls: (a, b) factories
PATTERNS = {
    "same shape": lambda: (_field((64, 9), 1), _field((64, 9), 2)),
    "[K, Q] x [K, 1] (air/builder.py)": lambda: (_field((6, 40), 3),
                                                 _field((6, 1), 4)),
    "[n, 1] x [1, 5] (air/lookup.py)": lambda: (_field((33, 1), 5),
                                                _field((1, 5), 6)),
    "0-d tensor": lambda: (_field((), 7), _field((17, 3), 8)),
    "scalar word": lambda: (_field((12, 5), 9), 123456789),
    "scalar word >= p": lambda: (_field((12, 5), 10), 2 * P + 5),
    "negative scalar": lambda: (_field((12, 5), 11), -7),
    "strided view": lambda: (_field((42, 6), 12)[1::3, ::2],
                             _field((14, 3), 13)),
    "column of a row-major array": lambda: (_field((25, 4), 14)[:, 2],
                                            _field((25,), 15)),
    "transposed": lambda: (_field((8, 12), 16).t(), _field((12, 8), 17)),
    "seven dims merged": lambda: (_field((2, 1, 3, 2, 1, 2, 3), 18),
                                  _field((2, 1, 3, 2, 1, 2, 3), 19)),
    "empty": lambda: (_field((0, 5), 20), _field((0, 5), 21)),
    "u32 words": lambda: (_field((50,), 22, 1 << 32),
                          _field((50,), 23, 1 << 32)),
}


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_elementwise_layouts(emulated, op, pattern):
    a, b = PATTERNS[pattern]()
    got = bb._elementwise(op, a, b)
    want = getattr(bb, f"{op}_plain")(a, b)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)
    assert len(emulated) == (0 if got.numel() == 0 else 1)
    if pattern == "seven dims merged":
        assert emulated[0][1][1] == 1  # contiguous: one dim


@pytest.mark.parametrize("op", UNARY)
@pytest.mark.parametrize("pattern", ["strided view", "transposed",
                                     "u32 words", "0-d tensor"])
def test_unary_layouts(emulated, op, pattern):
    a, _ = PATTERNS[pattern]()
    assert torch.equal(bb._elementwise(op, a),
                       getattr(bb, f"{op}_plain")(a))


def test_too_many_dims_raise(emulated):
    a = _field((2,) * 7, 1)
    b = _field((2, 1, 2, 1, 2, 1, 2), 2)
    with pytest.raises(ValueError, match="at most 6"):
        bb._elementwise("mul", a, b)


@pytest.mark.parametrize("case", ["same", "[n, 1, 5] x [1, m, 5]",
                                  "[5] scalar", "strided", "empty"])
def test_ext_layouts(emulated, case):
    e = lambda shape, seed: _field(shape + (5,), seed)  # noqa: E731
    a, b = {"same": lambda: (e((30,), 1), e((30,), 2)),
            "[n, 1, 5] x [1, m, 5]": lambda: (e((7, 1), 3), e((1, 4), 4)),
            "[5] scalar": lambda: (e((3, 11), 5), e((), 6)),
            "strided": lambda: (e((20, 3), 7)[::2, 1], e((10,), 8)),
            "empty": lambda: (e((0,), 9), e((0,), 10))}[case]()
    got = extf._ext_mul_kernel(a, b)
    assert torch.equal(got, extf.ext_mul_plain(a, b))
    got = extf._ext_inv_kernel(a)
    assert torch.equal(got, extf.ext_inv_plain(a))
    got = bb._inv_kernel(a[..., 1])
    assert torch.equal(got, bb.inv_plain(a[..., 1]))


# ---------------------------------------------------------------------------
# Dispatch: a CPU tensor runs the plain version, never a launch; any other
# device launches the kernel or raises
# ---------------------------------------------------------------------------

PUBLIC_UNARY = ["neg", "double", "to_monty", "from_monty",
                "from_wrapped_u32", "inv", "inv_batch"]


def test_cpu_tensors_never_launch(monkeypatch):
    def refuse(*args):
        raise AssertionError(f"a CPU tensor reached a launch: {args[:2]}")

    monkeypatch.setattr(_build, "launch", refuse)
    a, b = _field((9, 5), 1), _field((9, 5), 2)
    for op in BINARY:
        assert torch.equal(getattr(bb, op)(a, b),
                           getattr(bb, f"{op}_plain")(a, b))
        assert torch.equal(getattr(bb, op)(a, 77),
                           getattr(bb, f"{op}_plain")(a, 77))
    for op in PUBLIC_UNARY:
        assert torch.equal(getattr(bb, op)(a), getattr(bb, f"{op}_plain")(a))
    assert torch.equal(extf.ext_mul(a, b), extf.ext_mul_plain(a, b))
    assert torch.equal(extf.ext_inv(a), extf.ext_inv_plain(a))


def test_other_devices_launch(monkeypatch):
    """On a tensor off the CPU (here `meta`, which has no data) each
    function calls its entry once and counts one launch; the plain
    versions are not called."""
    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda *args: launched.append(args[:2]))
    for name in ("mul_plain", "add_plain", "inv_plain", "inv_batch_plain"):
        monkeypatch.setattr(bb, name, lambda *a: pytest.fail("plain"))
    saved = dict(_build.LAUNCHES)
    m = torch.zeros(4, 5, dtype=torch.int32, device="meta")
    try:
        calls = [(lambda: bb.mul(m, m), "field_elementwise"),
                 (lambda: bb.add(m, 3), "field_elementwise"),
                 (lambda: bb.double(m), "field_elementwise"),
                 (lambda: bb.from_wrapped_u32(m), "field_elementwise"),
                 (lambda: bb.inv(m), "field_inv"),
                 (lambda: bb.inv_batch(m), "field_inv"),
                 (lambda: extf.ext_mul(m, m[0]), "field_ext_mul"),
                 (lambda: extf.ext_inv(m), "field_ext_inv")]
        for fn, kernel in calls:
            before = dict(_build.LAUNCHES)
            out = fn()
            assert out.device.type == "meta" and out.dtype == torch.int32
            assert launched[-1] == ("field", f"{kernel}_launch")
            assert {k: _build.LAUNCHES[k] - n for k, n in before.items()
                    if _build.LAUNCHES[k] != n} == {kernel: 1}
        assert len(launched) == len(calls)
    finally:
        _build.LAUNCHES.update(saved)


@pytest.mark.parametrize("bad", ["int64", "bool", "mixed devices",
                                 "ext width"])
def test_what_the_kernels_do_not_take_raises(monkeypatch, bad):
    monkeypatch.setattr(_build, "launch",
                        lambda *args: pytest.fail("launched"))
    m = torch.zeros(4, 5, dtype=torch.int32, device="meta")
    call = {"int64": lambda: bb.mul(m, m.to(torch.int64)),
            "bool": lambda: bb.to_monty(m.bool()),
            "mixed devices": lambda: bb.add(m, torch.zeros(4, 5,
                                                           dtype=torch.int32)),
            "ext width": lambda: extf.ext_mul(m[:, :4], m[:, :4])}[bad]
    with pytest.raises((TypeError, ValueError)):
        call()


def test_const_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bb.const(5, (3,), device="cuda")


def test_build_carries_the_field_kernels(monkeypatch, tmp_path):
    assert set(_build.SIGNATURES["field"]) == {
        "field_elementwise_launch", "field_ext_mul_launch",
        "field_inv_launch", "field_ext_inv_launch"}
    for k in ("field_elementwise", "field_ext_mul", "field_inv",
              "field_ext_inv"):
        assert k in _build.LAUNCHES and k in _build.CAPTURED
    src = (_build.CSRC / "field.cu").read_text()
    for fn in _build.SIGNATURES["field"]:
        assert f'extern "C" int {fn}(' in src
    # build_all starts one nvcc a source, field.cu among them; the
    # library's name follows the header too
    started = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            started.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return ("",)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    logs = _build.build_all()
    assert set(logs) == set(_build.SIGNATURES)
    assert any(cmd[-1].endswith("field.cu") for cmd in started)
    assert _build._target("field").exists()
    name = _build._target("field").name
    real = HEADER.read_bytes()
    monkeypatch.setattr(type(HEADER), "read_bytes",
                        lambda self: real + b"//" if self == HEADER
                        else open(self, "rb").read())
    assert _build._target("field").name != name


# ---------------------------------------------------------------------------
# The callers: every operand the prover hands the field functions is one
# the kernels take
# ---------------------------------------------------------------------------

AUDITED = ["mul", "add", "sub", "neg", "double", "to_monty", "from_monty",
           "from_wrapped_u32", "inv", "inv_batch"]


def test_prover_operands_are_kernel_operands(monkeypatch):
    """A small BasicMachine proved by the eager prover (debug checks on)
    and by the staged prover, and the distributed primitives' LogUp sum,
    with every field call audited: each tensor operand is int32, each
    layout merges to at most 6 dims, and inv_batch sees only canonical
    words."""
    from valida_tpu_torch.core.config import default_config
    from valida_tpu_torch.machine import jit_prover
    from valida_tpu_torch.parallel import mesh as pmesh
    from valida_tpu_torch.parallel.dryrun import alu_loop_machine

    seen = {}

    def audit(name, fn):
        def wrapped(*args):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            for t in tensors:
                assert t.dtype == torch.int32, (name, t.dtype)
            if name == "inv_batch" and args[0].numel():
                assert 0 <= int(args[0].min()) and int(args[0].max()) < P
            if len(tensors) == 2:
                shape = torch.broadcast_shapes(*(t.shape for t in tensors))
                bb._layout(name, 1, shape, *(
                    bb._bstrides(t.shape, t.stride(), shape)
                    for t in tensors))
            seen[name] = seen.get(name, 0) + 1
            return fn(*args)
        return wrapped

    for name in AUDITED:
        monkeypatch.setattr(bb, name, audit(name, getattr(bb, name)))
    for name in ("ext_mul", "ext_inv"):
        monkeypatch.setattr(extf, name, audit(name, getattr(extf, name)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = alu_loop_machine(8)
        m.prove(default_config(device="cpu"))
        jit_prover.prove_jit(m, default_config(debug_checks=False,
                                               device="cpu"))
        rng = np.random.default_rng(0)
        q = from_reference(rng.integers(0, P, (1, 8, 2, 5), dtype=np.uint32))
        counts = from_reference(rng.integers(0, 1 << 32, (1, 8, 2),
                                             dtype=np.uint32))
        monkeypatch.setattr(pmesh, "axis_info",
                            lambda mesh, axis: (1, 0, None))
        monkeypatch.setattr(pmesh, "_all_gather",
                            lambda x, group, n: x[None])
        pmesh._phi(q, counts, None)
    finally:
        torch.set_num_threads(threads)
    assert {"mul", "add", "sub", "to_monty", "from_monty", "inv_batch",
            "ext_mul", "ext_inv"} <= set(seen)


@pytest.fixture
def kernel_branches(emulated, monkeypatch):
    """Every field function takes its kernel branch on CPU tensors, into
    the emulated launch."""
    monkeypatch.setattr(bb, "_plain_side", lambda a, b=None: False)
    monkeypatch.setattr(bb, "inv", bb._inv_kernel)
    monkeypatch.setattr(bb, "inv_batch", bb._inv_kernel)
    monkeypatch.setattr(extf, "ext_mul", extf._ext_mul_kernel)
    monkeypatch.setattr(extf, "ext_inv", extf._ext_inv_kernel)
    return emulated


def test_kernel_branches_prove_the_fixture(kernel_branches):
    """The golden fixture's machine proved with every field operation in
    the kernels' branches (layouts, dispatch and field.cuh's arithmetic,
    the launches emulated) gives the fixture's bytes.  The quotient on
    CPU tensors is `quotient_rows_plain`, which computes with the `*_plain`
    field functions (its kernel branch, whose selector tables invert, is
    held in test_torch_constraint_kernel.py): the prove's other stages
    reach three of the four kernels, the inverse not among them."""
    from tests.test_torch_machine import FIXTURE
    from valida_tpu_torch.core.config import default_config
    from valida_tpu_torch.machine import examples
    from valida_tpu_torch.tooling.serde import serialize_proof

    m = examples.random_mini_machine(48, seed=3)
    proof = m.prove(default_config(num_queries=3, proof_of_work_bits=1,
                                   device="cpu"))
    with open(FIXTURE, "rb") as f:
        assert serialize_proof(proof) == f.read()
    kernels = {fn for fn, _layout in kernel_branches}
    assert kernels == {f"field_{k}_launch" for k in
                       ("elementwise", "ext_mul", "ext_inv")}
