"""The port's tooling (valida_tpu_torch.tooling: assembler, ELF loader,
REPL, CLI) against the JAX package's, as tests/test_tooling.py tests
those: the same machine code from the same assembly, the same program
from the same file, the same debugger session, and a CLI proof file with
the JAX package's bytes.

`reference_cli_digest` makes chip_smoke.py's pin of path (cli)."""

import hashlib
import struct
from pathlib import Path

import pytest
import torch

from tests import test_tooling as rtests
from valida_tpu import backend
from valida_tpu.core import config as rconfig
from valida_tpu.core.advice import FixedAdviceProvider as RAdvice
from valida_tpu.machine.basic import BasicMachine as RBasicMachine
from valida_tpu.tooling import elf as relf
from valida_tpu.tooling import serde as rserde
from valida_tpu.tooling.assembler import assemble as rassemble
from valida_tpu_torch.core.advice import FixedAdviceProvider
from valida_tpu_torch.core.program import ProgramROM
from valida_tpu_torch.machine.basic import BasicMachine
from valida_tpu_torch.tooling import elf
from valida_tpu_torch.tooling.assembler import AssemblyError, assemble
from valida_tpu_torch.tooling.cli import main as cli_main
from valida_tpu_torch.tooling.repl import Repl
from valida_tpu_torch.tooling.serde import cbor_dumps, cbor_loads

PROGRAMS = Path(__file__).resolve().parent / "programs"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's CPU
    operations on one thread each keep them from crowding the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# tests/test_tooling.py's snippets, and the CLI tests' three-instruction
# program (the CLI proves under default_config)
CLI_ASM = """\
main:
    imm32 -4(fp), 0, 0, 0, 42
    write 0(fp), -4(fp), 0, 0, 1
    stop
"""
SNIPPETS = {
    "fib": rtests.FIB_ASM,
    "stop": "main:\n  stop\n",
    "imm_variants": """\
start:
    imm32 -4(fp), 0, 0, 0, 7
    subi -8(fp), -4(fp), 3
    muli -12(fp), -8(fp), 5
    stop
""",
    "cbor": """\
main:
    imm32 -4(fp), 0, 0, 0, 11
    addi -8(fp), -4(fp), 31
    stop
""",
    "cli": CLI_ASM,
    "left_imm_and_field": """\
main:
    imm32 -4(fp), 0, 0, 0, 3
    ilt -8(fp), 5, -4(fp)
    isle -12(fp), 5, -4(fp)
    feadd -16(fp), -4(fp), -4(fp)
    fesub -20(fp), -4(fp), -4(fp)
    femul -24(fp), -4(fp), -4(fp)
    lw -28(fp), -4(fp)
    sw -4(fp), -8(fp)
    loadu8 -32(fp), -4(fp)
    loads8 -36(fp), -4(fp)
    storeu8 -4(fp), -8(fp)
    jalv -40(fp), -4(fp), -8(fp)
    bnei main, -4(fp), 1
    stop
""",
}
SOURCES = {**{p.name: p.read_text() for p in sorted(PROGRAMS.glob("*.val"))},
           **SNIPPETS}


@pytest.mark.parametrize("name", list(SOURCES))
def test_assembler_matches_reference(name):
    code = assemble(SOURCES[name])
    assert code == rassemble(SOURCES[name]) and len(code) % 24 == 0


def test_assembler_rejects_unknown_mnemonic():
    with pytest.raises(AssemblyError, match="Unknown mnemonic frob"):
        assemble("main:\n    frob -4(fp)\n")


def test_elf_loader_takes_raw_machine_code():
    code = assemble(rtests.FIB_ASM)
    program = elf.load_executable_file(code)
    assert program.data == {} and program.initial_program_counter == 0
    assert program.code.to_machine_code() == code


def _elf32(text_addr, text, data_addr, data):
    """A little-endian ELF32 object with a null section, an executable
    text section and a writable data section."""
    shoff = 52 + len(text) + len(data)
    header = b"\x7fELF" + bytes([1, 1, 1]) + bytes(9)
    header += struct.pack("<HHIIIIIHHHHHH", 1, 0, 1, 0, 0, shoff, 0, 52, 0,
                          0, 40, 3, 0)
    sections = bytes(40)
    sections += struct.pack("<IIIIIIIIII", 0, 1, 0x6, text_addr, 52,
                            len(text), 0, 0, 4, 0)
    sections += struct.pack("<IIIIIIIIII", 0, 1, 0x3, data_addr,
                            52 + len(text), len(data), 0, 0, 4, 0)
    return header + text + data + sections


def test_elf_loader_matches_reference():
    """An ELF32 object's text, initial pc and static data words load as the
    JAX package's loader loads them."""
    text = assemble(CLI_ASM)
    blob = _elf32(48, text, 0x400, bytes(range(1, 11)))
    got, want = elf.load_executable_file(blob), relf.load_executable_file(blob)
    assert got.code.to_machine_code() == want.code.to_machine_code()
    assert got.initial_program_counter == want.initial_program_counter == 2
    assert got.data == want.data and len(got.data) == 3


def test_repl_basic_session():
    """tests/test_tooling.py's debugger session, step by step."""
    code = assemble("main:\n  imm32 -4(fp), 0, 0, 0, 9\n  stop\n")

    def make():
        m = BasicMachine()
        m.program().set_program_rom(ProgramROM.from_machine_code(code))
        m.cpu().fp = 0x1000
        m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
        return m

    r = Repl(make, FixedAdviceProvider.empty())
    assert "IMM32" in r.dispatch("l")
    assert "pc=0" in r.dispatch("status")
    r.dispatch("s")
    assert "pc=1" in r.dispatch("status")
    r.dispatch("c")
    assert "stopped=True" in r.dispatch("status")
    assert "9" in r.dispatch("m 0xffc 1")
    assert "breakpoint set at 1" == r.dispatch("b 1")
    r.dispatch("r")
    assert "pc=0" in r.dispatch("status")
    assert r.dispatch("c") == "breakpoint at pc=1 (1 steps)"
    assert r.dispatch("q") is None


def reference_cli_digest(asm=CLI_ASM, advice=b"") -> str:
    """SHA-256 of the proof file `cli prove` writes for the assembled
    program and advice with default flags, as the JAX package's numpy
    path makes it: serialize_proof(proof, default_config()) (chip_smoke.py's
    CLI_GOLDEN for tests/programs/fibonacci.val with advice 25; seconds)."""
    m = RBasicMachine()
    m.program().set_program_rom(
        relf.load_executable_file(rassemble(asm)).code)
    m.cpu().fp = 16777216
    m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
    m.run(advice=RAdvice(advice))
    cfg = rconfig.default_config()
    with backend.use_backend("numpy"):
        proof = m.prove(cfg)
    return hashlib.sha256(rserde.serialize_proof(proof, cfg)).hexdigest()


@pytest.fixture(scope="module")
def cli_proof(tmp_path_factory):
    """(program file, proof file) of `cli prove --device cpu` on the
    three-instruction program."""
    d = tmp_path_factory.mktemp("cli")
    prog, proof = d / "prog.bin", d / "proof.cbor"
    (d / "prog.val").write_text(CLI_ASM)
    assert cli_main(["asm", str(d / "prog.val"), str(prog)]) == 0
    assert prog.read_bytes() == rassemble(CLI_ASM)
    assert cli_main(["prove", str(prog), str(proof), "--device", "cpu"]) == 0
    return prog, proof


def test_cli_run_writes_output_tape(tmp_path):
    prog, out, advice = (tmp_path / "prog.bin", tmp_path / "out.tape",
                         tmp_path / "advice.bin")
    prog.write_bytes(assemble((PROGRAMS / "fibonacci.val").read_text()))
    advice.write_bytes(bytes([25]))
    assert cli_main(["run", str(prog), str(out), str(advice)]) == 0
    assert int.from_bytes(out.read_bytes(), "little") == 75025


def test_cli_prove_matches_reference(cli_proof):
    """The proof file's bytes are the JAX package's
    serialize_proof(proof, config) from its numpy prover on the same
    program and flags."""
    _prog, proof = cli_proof
    blob = proof.read_bytes()
    assert hashlib.sha256(blob).hexdigest() == reference_cli_digest()


def test_cli_verify(cli_proof, tmp_path, capsys):
    prog, proof = cli_proof
    assert cli_main(["verify", str(prog), str(proof), "--device", "cpu"]) == 0
    assert "Proof verified" in capsys.readouterr().out
    bad = bytearray(proof.read_bytes())
    bad[-20] ^= 1  # a late byte: an opened value
    bad_file = tmp_path / "bad.cbor"
    bad_file.write_bytes(bytes(bad))
    assert cli_main(["verify", str(prog), str(bad_file), "--device",
                     "cpu"]) == 1
    assert "Proof verification failed" in capsys.readouterr().out


def test_cli_verify_rejects_scheme_mismatch(cli_proof, tmp_path, capsys):
    """A proof tagged with another Poseidon scheme or hasher fails verify
    with a message naming the prover's flags, before any transcript
    work."""
    prog, proof = cli_proof
    obj = cbor_loads(proof.read_bytes())
    assert obj["meta"]["hasher"] == "keccak"
    obj["meta"]["poseidon"] = "sha256"
    obj["meta"]["hasher"] = "poseidon2"
    tagged = tmp_path / "tagged.cbor"
    tagged.write_bytes(cbor_dumps(obj))
    assert cli_main(["verify", str(prog), str(tagged), "--device",
                     "cpu"]) == 1
    out = capsys.readouterr().out
    assert "transcript configuration" in out
    assert "--poseidon sha256" in out and "--hasher poseidon2" in out
