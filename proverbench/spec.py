"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root, a configuration's file (the one its entry names, under
`configs/`), a traffic mix (`traffic/<name>.json`), a guest program
(`programs/<name>.json`) and a metric's reader (`metrics/<name>.py`).
Nothing here imports the program under test.

A job is one execution segment: the configuration's program at the traffic
mix's size, with the program's inputs drawn from the run's seed and the
job's index.  Every job of a cell executes the same count of every
operation, so every job has the configuration's chip heights."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the IMM32 instruction's four immediate bytes, most significant first
IMM32 = "IMM32"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` metrics the cell reports: those
    without a `workloads` key and those that list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def metric_reader(name: str):
    """The `read(ctx)` function of `metrics/<name>.py` (a name may hold
    dots: the file is named by the whole name)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"proverbench_metric_{name.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic mix and
    program read from their files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    program: dict
    size: dict  # the configuration's entry for the traffic's job size


def cell(bench: dict, name: str) -> Cell:
    w = workload(bench, name)
    entry = config_entry(bench, w["config"])
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    program = load_json(HERE / "programs" / f"{config['program']}.json")
    sizes = config["sizes"]
    key = str(traffic["log_cycles"])
    if key not in sizes:
        raise KeyError(f"configuration {w['config']!r} has no size "
                       f"2^{key} cycles (traffic {w['traffic']!r})")
    return Cell(name, int(w["chips"]), config, traffic, program, sizes[key])


def job_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of job `index` of a run seeded `seed` (index -1: the
    set-up's warm-up job, a stream of its own)."""
    if index < 0:
        return np.random.default_rng([seed % 2**64, 0])
    return np.random.default_rng([seed % 2**64, 1, index])


def job_inputs(c: Cell, seed: int, index: int) -> dict:
    """{input name: u32 word} of one job: each of the configuration's
    `inputs` drawn uniformly from its inclusive [low, high]."""
    rng = job_rng(seed, index)
    return {name: int(rng.integers(lo, hi, endpoint=True, dtype=np.uint64))
            for name, (lo, hi) in sorted(c.config["inputs"].items())}


def instructions(program: dict, params: dict) -> list:
    """The program's instructions as (opcode name, (a, b, c, d, e)), every
    "$name" operand replaced by params[name]; ["IMM32", a, word] spreads
    the 32-bit word over b..e, most significant byte first."""

    def value(v):
        return int(params[v[1:]]) if isinstance(v, str) else int(v)

    out = []
    for ins in program["instructions"]:
        op, ops = ins[0], [value(v) for v in ins[1:]]
        if op == IMM32:
            a, word = ops
            word &= 0xFFFFFFFF
            ops = [a, word >> 24, (word >> 16) & 255, (word >> 8) & 255,
                   word & 255]
        if len(ops) != 5:
            raise ValueError(f"instruction {ins!r}: five operands expected")
        out.append((op, tuple(ops)))
    return out


def job_program(c: Cell, seed: int, index: int) -> list:
    """The instructions of one job: its inputs and the size's loop
    count."""
    params = job_inputs(c, seed, index)
    params[c.program["loop_count"][1:]] = int(c.size["loop_count"])
    return instructions(c.program, params)
