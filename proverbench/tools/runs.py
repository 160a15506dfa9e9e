"""Run one cell several times in a row, a process a run, and summarise.

    python3 proverbench/tools/runs.py --workload CELL --seeds 11 12 13 \
        --seconds 50 [--trace 0|1] [--out chiprun_out/NAME.jsonl]

Each run is `python3 proverbench/run.py ...` from the checkout's root; its
result line (or its exit code and the end of its standard error) goes to
the output file, one JSON line a run.  The summary gives each metric's
values, median and spread (the distance between the first and third
quartiles of `statistics.quantiles(values, n=4)`, as a share of the
median), and the lines that print the capture counts and the checks."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = Path(args.out) if args.out else None
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
    results = []
    for seed in args.seeds:
        cmd = [sys.executable, "proverbench/run.py", "--workload",
               args.workload, "--seed", str(seed), "--seconds",
               str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        rec = {"seed": seed, "rc": p.returncode, "wall_s": wall,
               "notes": [ln for ln in lines[:-1]][-5:],
               "stderr_tail": p.stderr[-3000:]}
        try:
            rec["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            rec["result"] = None
        results.append(rec)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        r = rec["result"]
        print(f"seed {seed}: rc {p.returncode}, {wall:.1f} s, "
              + (f"correct {r['correct']}, attempted {r['attempted']}, "
                 f"failed {r['failed']}, "
                 + ", ".join(f"{k} {v['value']:.6g}"
                             for k, v in r["metrics"].items())
                 + (f", busy {r['device'].get('busy_s')}"
                    f" of {r['device'].get('window_s')}"
                    if "busy_s" in r["device"] else "")
                 if r else "no result")
              + " | " + " / ".join(rec["notes"][-2:]), flush=True)
        if not r or not r["correct"]:
            print(rec["stderr_tail"], flush=True)
    vals: dict = {}
    for rec in results:
        if rec["result"]:
            for k, v in rec["result"]["metrics"].items():
                vals.setdefault(k, []).append(v["value"])
    for k, v in vals.items():
        s = spread(v)
        print(f"{k}: median {statistics.median(v):.6g}, spread "
              f"{'-' if s is None else f'{s:.4f}'}, values "
              + " ".join(f"{x:.6g}" for x in v), flush=True)
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
