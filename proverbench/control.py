"""The control of the benchmark's correctness check, and its faults.

    python3 proverbench/control.py --workload CELL --seeds 1 2 3 [--out FILE]

In one process, after the cell's set-up, for each seed: jobs 0 and 1 of
the seed under the configuration's stated profile (the sound readings);
job 0 proved under each control profile, a step that a later change could
be tempted to take (`CONTROLS`: 39 queries instead of 40; no proof of
work instead of 8 bits), judged by the reference under the stated
profile; and three faults of the timed path, each judged as a run judges
a job: job 1 answered with job 0's proof (a step that returns its state
unchanged), job 0's proof with one opened value altered, and job 0's
final memory with one word altered (answers altered where they are
produced).  Each reading is the pair of numbers a run compares for one
job: results_wrong and proofs_rejected (limit 0 each).  The benchmark's
runs do not run this."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import run
import spec

CONTROLS = {"queries39": {"num_queries": 39},
            "pow0": {"proof_of_work_bits": 0}}


def tamper_proof(data: bytes) -> bytes:
    """The proof with the first opened value of its first chip's main
    trace changed by one in its first coefficient."""
    from valida_tpu_torch.tooling import serde

    proof = serde.deserialize_proof(data)
    ov = proof.chip_proofs[0].opened_values
    v = tuple(ov.trace_local[0])
    ov.trace_local[0] = ((v[0] + 1) % 2013265921,) + v[1:]
    return serde.serialize_proof(proof)


def reading(c: spec.Cell, seed: int, job: run.Job) -> dict:
    same, why = run.judge_job(c, seed, job)
    return {"results_wrong": int(not same), "proofs_rejected": int(why is not None),
            "why": why}


def readings(c: spec.Cell, seeds: list, device: str = "cuda") -> list:
    import port

    port.build(device)
    profile = c.config["profile"]
    cfgs = {"stated": port.prover_config(profile, device)}
    cfgs.update({k: port.prover_config({**profile, **v}, device)
                 for k, v in CONTROLS.items()})
    instructions = spec.job_program(c, seeds[0], -1)
    for cfg in cfgs.values():
        port.warmup(port.execute(instructions, int(c.program["fp"])), cfg)
    out = []
    for seed in seeds:
        a = run.run_job(c, seed, 0, cfgs["stated"], False)
        b = run.run_job(c, seed, 1, cfgs["stated"], False)
        rows = {"sound job 0": reading(c, seed, a),
                "sound job 1": reading(c, seed, b)}
        for k in CONTROLS:
            rows[f"control {k}"] = reading(
                c, seed, run.run_job(c, seed, 0, cfgs[k], False))
        memory = dict(a.memory)
        addr = min(memory)
        memory[addr] ^= 1
        rows["fault: stale proof"] = reading(
            c, seed, dataclasses.replace(b, proof=a.proof))
        rows["fault: opened value altered"] = reading(
            c, seed, dataclasses.replace(a, proof=tamper_proof(a.proof)))
        rows["fault: result altered"] = reading(
            c, seed, dataclasses.replace(a, memory=memory))
        out.append({"seed": seed, "readings": rows})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    c = spec.cell(bench, args.workload)
    res = readings(c, args.seeds)
    for r in res:
        for name, v in r["readings"].items():
            print(f"{c.name} seed {r['seed']} {name}: results_wrong "
                  f"{v['results_wrong']}, proofs_rejected "
                  f"{v['proofs_rejected']} {v['why'] or ''}", flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps({"workload": c.name, "runs": res}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
