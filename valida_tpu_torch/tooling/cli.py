"""Command-line interface (mirrors `basic/src/bin/valida.rs:40-61`):

    python -m valida_tpu_torch.tooling.cli <run|prove|verify|interactive>
           <program> <action_file> [--stack-height N] [advice]
           [--device cuda|cpu] [--jit]

plus an `asm` subcommand exposing the assembler.

Counterpart of valida_tpu/tooling/cli.py.  `--device` (default `cuda`)
selects where `prove` runs and where `verify` re-commits the preprocessed
traces; `cpu` runs the plain versions.  `--jit` proves once through the
staged prover (machine/jit_prover.py `prove_jit`, no separate warm-up):
its graphs do not outlive the process, so a one-shot prove pays every
stage's capture (PERF.md).  The program is interpreted by the Python step
loop (`BasicMachine.run`), which streams the advice file.
"""

from __future__ import annotations

import argparse
import sys

from ..core.advice import FixedAdviceProvider, GlobalAdviceProvider
from ..core.config import default_config
from ..machine.basic import BasicMachine
from .assembler import assemble
from .elf import load_executable_file
from .repl import Repl
from .serde import deserialize_proof, proof_meta, serialize_proof


def _build_machine(args):
    with open(args.program, "rb") as f:
        program = load_executable_file(f.read())

    def make():
        m = BasicMachine()
        m.program().set_program_rom(program.code)
        m.cpu().fp = args.stack_height
        m.cpu().pc = program.initial_program_counter
        m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
        m.static_data().load(program.data)
        return m

    return make


def _advice(args):
    return (GlobalAdviceProvider(args.advice) if args.advice
            else FixedAdviceProvider.empty())


def main(argv=None):
    parser = argparse.ArgumentParser(prog="valida")
    parser.add_argument("action",
                        choices=["run", "prove", "verify", "interactive", "asm"])
    parser.add_argument("program", help="program file (ELF or machine code; "
                                        "assembly source for `asm`)")
    parser.add_argument("action_file", nargs="?",
                        help="output tape / proof path / asm output")
    parser.add_argument("--stack-height", type=int, default=16777216)
    parser.add_argument("advice", nargs="?", default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where to prove (and re-commit the "
                             "preprocessed traces when verifying)")
    parser.add_argument("--jit", action="store_true",
                        help="prove with the staged prover (each stage a "
                             "captured CUDA graph on the card)")
    parser.add_argument("--hasher", choices=["keccak", "poseidon2"],
                        default="keccak", help="Merkle MMCS hasher")
    parser.add_argument("--log-final", type=int, default=0,
                        help="FRI early stop: ship a 2^N-coefficient final "
                             "polynomial instead of folding to a constant "
                             "(prove and verify must agree)")
    parser.add_argument("--no-debug-checks", action="store_true")
    parser.add_argument("--poseidon", default=None, metavar="SET",
                        help="challenger constant provenance: p3rng "
                             "(default, = p3rng:monty-ee-mj), "
                             "p3rng:<interpret>-<sip>-<mds> selecting one "
                             "of the 8 candidate reference streams, or "
                             "sha256 (the round-1 scheme); prove and "
                             "verify must agree")
    args = parser.parse_args(argv)

    from ..crypto import poseidon

    if args.poseidon:
        poseidon.set_param_set(args.poseidon)

    if args.action == "asm":
        with open(args.program) as f:
            code = assemble(f.read())
        if args.action_file:
            with open(args.action_file, "wb") as f:
                f.write(code)
        else:
            sys.stdout.buffer.write(code)
        return 0

    make = _build_machine(args)

    if args.action == "interactive":
        Repl(make, _advice(args)).run()
        return 0

    machine = make()

    if args.action == "run":
        machine.run(advice=_advice(args))
        with open(args.action_file, "wb") as f:
            f.write(machine.output().bytes())
        return 0

    config = default_config(debug_checks=not args.no_debug_checks,
                            hasher=args.hasher, log_final=args.log_final,
                            device=args.device)

    if args.action == "prove":
        machine.run(advice=_advice(args))
        if args.jit:
            from ..machine.jit_prover import prove_jit

            proof = prove_jit(machine, config)
        else:
            proof = machine.prove(config)
        machine.verify(config, proof)
        with open(args.action_file, "wb") as f:
            f.write(serialize_proof(proof, config))
        print("Proof successful")
        return 0

    # verify.  No execution: verification needs only the program ROM (for
    # the preprocessed commitment) and the proof.  The reference CLI runs
    # the program before every action incl. verify
    # (basic/src/bin/valida.rs:354) — an artifact of its shared main flow;
    # a verifier must not need the (possibly absent) advice tape.
    with open(args.action_file, "rb") as f:
        blob = f.read()
    # Fail a transcript-configuration mismatch with an actionable message
    # instead of an opaque Fiat-Shamir failure.
    meta = proof_meta(blob)
    mismatches = []
    if meta.get("poseidon") and meta["poseidon"] != poseidon.PARAM_SET:
        mismatches.append(
            f"--poseidon {meta['poseidon']} (this run: {poseidon.PARAM_SET})")
    if meta.get("hasher") and meta["hasher"] != args.hasher:
        mismatches.append(
            f"--hasher {meta['hasher']} (this run: {args.hasher})")
    if mismatches:
        print("Proof verification failed: transcript configuration "
              "mismatch — the proof was produced with "
              + ", ".join(mismatches) + "; re-run verify with the "
              "prover's flags.")
        return 1
    try:
        machine.verify(config, deserialize_proof(blob))
    except Exception as e:  # the CLI's boundary: any failure is a rejection
        print(f"Proof verification failed: {e}")
        # A Fiat-Shamir configuration mismatch is indistinguishable from
        # corruption inside the transcript: name the knobs that must match
        # the prover's.
        print(
            "note: the verifier's transcript configuration must match "
            f"the prover's exactly — this run used "
            f"--poseidon {poseidon.PARAM_SET} --hasher {args.hasher} "
            f"--log-final {args.log_final}; a proof produced under "
            "different flags fails verification with no further "
            "diagnostics (e.g. pre-round-4 proofs used "
            "--poseidon sha256).")
        return 1
    print("Proof verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
