"""The benchmark of valida_tpu_torch: one cell, one run.

    python3 proverbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up builds (first run of a checkout) or loads the port's libraries,
executes one job of the cell's shapes and warms the staged prover with it
(`warmup_jit`).  The window then runs jobs back to back, one at a time: a
job draws its program's inputs from the seed and its index, executes the
program with the C++ core, proves it with `prove_jit` and serializes the
proof; the window ends with the last job started before S seconds ran out.
After it, every finished job is judged by the plain reference
(reference/), in processes of their own: the execution's final memory and
cycle count, and the proof's bytes by the frozen verifier under the
configuration's stated profile; every job's chip heights are held to the
configuration's.

With --trace 0 the last line of standard output holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from the
jobs of the window's first seconds under torch.profiler, with the
prover's stage clock on (the whole window runs and is judged as ever).
It exits 2 without the port beside it, 3 without the CUDA devices the cell
asks for, and 4 where JAX or the JAX package was loaded; none of these
prints a result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import concurrent.futures  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import spec  # noqa: E402

PORT = "valida_tpu_torch"
# a traced run profiles the window's first seconds (whole jobs), and its
# per-layer metrics read those jobs; a traffic mix may set fewer
# (`trace_seconds`), since reading the trace takes seconds for every
# hundred thousand device operations
TRACE_SECONDS = 15.0
# top-level module names no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "valida_tpu")
# processes that judge the window's jobs once it has closed
JUDGE_WORKERS = 6


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be above 0")
    return args


@dataclasses.dataclass
class Job:
    index: int
    execute_s: float
    prove_s: float
    serialize_s: float
    cycles: int
    upload_bytes: int
    stages: dict  # top-level stage -> host seconds (traced run only)
    heights: dict  # chip -> log height, from the proof
    memory: dict  # final memory of the execution
    proof: bytes

    @property
    def total_s(self) -> float:
        return self.execute_s + self.prove_s + self.serialize_s


@dataclasses.dataclass
class Window:
    """What a metric's reader reads (metrics/<name>.py `read(ctx)`)."""

    cell: spec.Cell
    jobs: list
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: object = None  # trace.Trace of a traced run


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_job(c: spec.Cell, seed: int, index: int, cfg, traced: bool) -> Job:
    import torch

    import port

    rf = torch.profiler.record_function
    t0 = time.perf_counter()
    with rf("job: execute"):
        instructions = spec.job_program(c, seed, index)
        m = port.execute(instructions, int(c.program["fp"]))
    t1 = time.perf_counter()
    with rf("job: prove"), port.stage_times(traced) as stages:
        proof = port.prove(m, cfg)
    t2 = time.perf_counter()
    with rf("job: serialize"):
        data = port.serialize(proof, cfg)
    t3 = time.perf_counter()
    memory, cycles = port.outcome(m)
    heights = {chip.name: int(cp.log_degree)
               for chip, cp in zip(m.chips(), proof.chip_proofs)}
    return Job(index, t1 - t0, t2 - t1, t3 - t2, cycles, port.upload_bytes(),
               dict(stages), heights, memory, data)


def judge_job(c: spec.Cell, seed: int, job: Job) -> tuple[bool, str | None]:
    """(whether the execution equals the reference's, None where the
    proof verifies or else why not) of one finished job."""
    from reference import interp, verify

    instructions = spec.job_program(c, seed, job.index)
    fp = int(c.program["fp"])
    memory, cycles = interp.run(instructions, fp)
    return ((memory, cycles) == (job.memory, job.cycles),
            verify.judge(job.proof, instructions, fp, c.config["profile"]))


def _judge_worker_init() -> None:
    import torch

    torch.set_num_threads(1)


def _judge_in_worker(c: spec.Cell, seed: int, job: Job
                     ) -> tuple[bool, str | None]:
    try:
        return judge_job(c, seed, job)
    except Exception as e:  # the reference could not read what it was given
        return False, f"the reference raised {type(e).__name__}: {e}"


def judge(c: spec.Cell, seed: int, jobs: list, failed: int) -> dict:
    """The numbers compared, each {"value", "limit"}: every finished job
    judged by the reference, in processes of their own (spawned, so that
    none holds the card or the port), and every job's chip heights."""
    want = {k: v["log_height"] for k, v in c.size["chips"].items()}
    t0 = time.perf_counter()
    workers = max(1, min(JUDGE_WORKERS, len(jobs)))
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_judge_worker_init) as pool:
        verdicts = list(pool.map(_judge_in_worker, [c] * len(jobs),
                                 [seed] * len(jobs), jobs))
    wrong = rejected = 0
    for job, (same, why) in zip(jobs, verdicts):
        if not same:
            wrong += 1
            print(f"job {job.index}: the execution differs from the "
                  f"reference's", file=sys.stderr)
        if why is not None:
            rejected += 1
            print(f"job {job.index}: proof rejected: {why}", file=sys.stderr)
    print(f"judged {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s "
          f"({workers} processes)", file=sys.stderr)
    heights_wrong = sum(j.heights != want for j in jobs)
    return {
        "jobs_failed": {"value": failed, "limit": 0},
        "jobs_judged": {"value": len(jobs), "limit": 1},
        "results_wrong": {"value": wrong, "limit": 0},
        "proofs_rejected": {"value": rejected, "limit": 0},
        "heights_wrong": {"value": heights_wrong, "limit": 0},
    }


def passed(checks: dict) -> bool:
    """jobs_judged is a floor; every other number a ceiling."""
    return all(v["value"] >= v["limit"] if k == "jobs_judged"
               else v["value"] <= v["limit"] for k, v in checks.items())


def read_metrics(bench: dict, cell: str, kind: str, ctx: Window) -> dict:
    out = {}
    for m in spec.metrics_of(bench, cell, kind):
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(bench: dict, c: spec.Cell, seed: int, seconds: float,
             traced: bool, device: str = "cuda") -> dict:
    """Set-up, the window and the judge of one run; the result's fields
    (without the device's)."""
    import torch

    import port
    import trace

    cuda = torch.device(device).type == "cuda"
    port.build(device)
    cfg = port.prover_config(c.config["profile"], device)
    instructions = spec.job_program(c, seed, -1)
    port.warmup(port.execute(instructions, int(c.program["fp"])), cfg)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    captures_before = port.captures()
    setup_s = time.perf_counter() - T_START

    jobs, failed, traced_jobs = [], 0, None
    trace_s = min(float(c.traffic.get("trace_seconds", TRACE_SECONDS)),
                  seconds)
    prof = trace.Profiler() if traced else None
    t0 = time.perf_counter()
    index = 0
    while time.perf_counter() - t0 < seconds:
        try:
            jobs.append(run_job(c, seed, index, cfg, traced))
        except Exception:  # a job that fails is counted, and judged
            failed += 1
            traceback.print_exc()
        index += 1
        if prof is not None and prof.running and (
                time.perf_counter() - t0 >= trace_s):
            prof.stop()
            traced_jobs = list(jobs)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    captures_after = port.captures()
    print(f"captures: {captures_before} before the window, "
          f"{captures_after} after it", flush=True)

    ctx = Window(c, jobs, window_s, setup_s, peak)
    if prof is not None:
        ctx.trace = prof.read()
        ctx.jobs, ctx.window_s = traced_jobs, ctx.trace.window_s
    metrics = read_metrics(bench, c.name,
                           "per_layer" if traced else "end_to_end", ctx)
    checks = judge(c, seed, jobs, failed)
    out = {"correct": passed(checks), "attempted": index, "failed": failed,
           "metrics": metrics, "peak": peak}
    if ctx.trace is not None:
        out["busy_s"] = ctx.trace.busy_s
        out["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if not (ROOT / PORT / "__init__.py").is_file():
        print(f"the program under test ({PORT}/) is not beside "
              f"{HERE.name}/: nothing to run", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    c = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"{c.name} needs {c.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 3
    print(f"device: {power_limit()}", flush=True)
    out = run_cell(bench, c, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": c.chips, "memory_peak_bytes": int(out.pop("peak"))}
    if "busy_s" in out:
        device["busy_s"] = out.pop("busy_s")
        device["window_s"] = out.pop("window_s")
    checks = out.pop("checks")
    result = {**out, "device": device, "checks": checks}
    for k, v in checks.items():
        print(f"{k} {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
