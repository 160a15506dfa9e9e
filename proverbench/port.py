"""The system under test, `valida_tpu_torch`, as one job drives it: build a
BasicMachine of the job's program, execute it with the C++ core
(`run_native(build_lists=False)`), prove it with the staged prover
(`prove_jit`) and serialize the proof on the host.  A run of the benchmark
imports the port here only (control.py's faults and tools/freeze_config.py
reach it too)."""

from __future__ import annotations

import contextlib

import torch


def build(device: str) -> None:
    """Build or load the port's native libraries: the nvcc kernels (on the
    card) and the g++ interpreter core, into the checkout's build/."""
    from valida_tpu_torch import _build
    from valida_tpu_torch.native import build as native_build

    if torch.device(device).type == "cuda":
        _build.build_all()
    native_build.build()


def prover_config(profile: dict, device: str):
    from valida_tpu_torch.core.config import default_config

    return default_config(num_queries=int(profile["num_queries"]),
                          proof_of_work_bits=int(profile["proof_of_work_bits"]),
                          log_blowup=int(profile["log_blowup"]),
                          hasher=profile["hasher"],
                          debug_checks=bool(profile["debug_checks"]),
                          device=device)


def execute(instructions: list, fp: int):
    """A BasicMachine that has run the program from pc 0 with frame pointer
    fp (op logs as arrays)."""
    from valida_tpu_torch.core import opcodes as OC
    from valida_tpu_torch.core.program import (InstructionWord, Operands,
                                               ProgramROM)
    from valida_tpu_torch.machine.basic import BasicMachine

    m = BasicMachine()
    m.program().set_program_rom(ProgramROM([
        InstructionWord(getattr(OC, op), Operands(tuple(ops)))
        for op, ops in instructions]))
    m.cpu().fp = fp
    m.run_native(build_lists=False)
    return m


def outcome(machine) -> tuple[dict, int]:
    """(final memory, cycles) of an executed machine."""
    return dict(machine.mem().cells), int(machine.cpu().clock)


def prove(machine, config):
    from valida_tpu_torch.machine import jit_prover

    proof = jit_prover.prove_jit(machine, config)
    if config.pcs.device.type == "cuda":
        torch.cuda.synchronize()
    return proof


def warmup(machine, config) -> None:
    from valida_tpu_torch.machine import jit_prover

    jit_prover.warmup_jit(machine, config)
    if config.pcs.device.type == "cuda":
        torch.cuda.synchronize()


def serialize(proof, config) -> bytes:
    from valida_tpu_torch.tooling import serde

    return serde.cbor_dumps(serde.proof_to_obj(proof, config))


def captures() -> int:
    """CUDA graphs the staged prover captured in this process."""
    from valida_tpu_torch.machine import jit_prover

    return int(jit_prover.stats["captures"])


def upload_bytes() -> int:
    """Host-to-device bytes the last prove_jit uploaded."""
    from valida_tpu_torch.machine import jit_prover

    return int(jit_prover.transfer_stats["bytes"])


@contextlib.contextmanager
def stage_times(on: bool):
    """Collect the prover's top-level stages' host seconds (each stage
    waits for the card at its end) into the yielded dict while on."""
    from valida_tpu_torch import utils

    out: dict = {}
    if not on:
        yield out
        return
    utils.start_stage_collection()
    try:
        yield out
    finally:
        out.update({k: v["s"] for k, v in utils.stop_stage_collection().items()})
