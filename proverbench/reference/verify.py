"""The reference's judge of a proof: the frozen copy of the port's verifier
(`frozen/`, plain NumPy and PyTorch on CPU tensors; it imports nothing of
the program) holds the proof's bytes against the job's own program under
the configuration's stated proof profile.

What it checks of each layer: it rebuilds the program's ROM from the job's
instructions and re-commits the preprocessed traces (the proof must be of
this job's program and inputs); it replays the Fiat-Shamir transcript from
the proof's commitments; it checks every queried row of the main,
permutation and quotient commitments against its Merkle path (the trace
builders' and the LDE's outputs as committed), the FRI folding and final
polynomial (the openings and FRI), the proof-of-work witness, the
constraints of every chip and the LogUp permutation argument at the
out-of-domain point against the opened quotient chunks (the quotient and
the permutation traces), and the buses' global balance."""

from __future__ import annotations

from .frozen.core import opcodes as OC
from .frozen.core.config import default_config
from .frozen.core.program import InstructionWord, Operands, ProgramROM
from .frozen.machine.basic import BasicMachine
from .frozen.machine.verifier import VerificationError
from .frozen.tooling.serde import deserialize_proof


def machine_of(instructions: list, fp: int) -> BasicMachine:
    """A BasicMachine holding the program (nothing executed: the verifier
    reads the chips' shapes and the preprocessed traces only)."""
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM([
        InstructionWord(getattr(OC, op), Operands(tuple(ops)))
        for op, ops in instructions]))
    m.cpu().fp = fp
    return m


def profile_config(profile: dict):
    """The configuration's proof profile as the frozen verifier's config
    (plain versions on the CPU)."""
    return default_config(num_queries=int(profile["num_queries"]),
                          proof_of_work_bits=int(profile["proof_of_work_bits"]),
                          log_blowup=int(profile["log_blowup"]),
                          hasher=profile["hasher"], device="cpu")


def judge(proof_bytes: bytes, instructions: list, fp: int, profile: dict
          ) -> str | None:
    """None where the proof verifies, else why it does not."""
    try:
        proof = deserialize_proof(proof_bytes)
        machine_of(instructions, fp).verify(profile_config(profile), proof)
    except VerificationError as e:
        return f"{type(e).__name__}: {e}"
    except (ValueError, KeyError, TypeError, IndexError, EOFError) as e:
        return f"unreadable proof: {type(e).__name__}: {e}"
    return None
