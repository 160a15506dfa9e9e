"""The benchmark's data: arguments, files found by name, new files picked
up without an edit, and the jobs' inputs."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import run
import spec

ROOT = spec.ROOT


def test_parse_args():
    a = run.parse_args(["--workload", "fibonacci.seg20", "--seed",
                        str(2**33 + 5), "--seconds", "50", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "fibonacci.seg20", 2**33 + 5, 50.0, 1)
    assert run.parse_args(["--workload", "x", "--seed", "1",
                           "--seconds", "2"]).trace == 0
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "x", "--seed", "1", "--seconds", "2",
                        "--trace", "2"])
    with pytest.raises(SystemExit):
        run.parse_args(["--seed", "1", "--seconds", "2"])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_every_file_found_by_name(cell):
    bench = spec.benchmark()
    c = spec.cell(bench, cell)
    assert c.config["program"] and c.program["instructions"]
    assert c.size["cycles"] <= 1 << c.traffic["log_cycles"]
    assert set(c.size["chips"])
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in spec.metrics_of(bench, cell, kind)]
        assert names
        for name in names:
            assert callable(spec.metric_reader(name))
    assert "setup_s" in [m["name"] for m in
                         spec.metrics_of(bench, cell, "end_to_end")]


def _copy_benchmark(tmp_path: Path) -> Path:
    """A checkout holding only BENCHMARK.json and proverbench/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / spec.HERE.name, tmp_path / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_files_need_no_edit(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric are
    each a new file and new entries of BENCHMARK.json: the harness finds
    them with no other file changed."""
    root = _copy_benchmark(tmp_path)
    pb = root / spec.HERE.name
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((pb / "configs" / "fibonacci.json").read_text())
    (pb / "configs" / "fib_b.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "seg20b.json").write_text(json.dumps(
        {"log_cycles": 20}))
    (pb / "metrics" / "jobs_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.jobs))\n")
    bench["configs"].append(dict(bench["configs"][0], name="fib_b",
                                 file="proverbench/configs/fib_b.json"))
    bench["workloads"].append({"name": "fib_b.seg20b",
                               "config": "fib_b", "traffic": "seg20b",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "cycles_per_s",
                               "workloads": ["fib_b.seg20b"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path[:0] = [sys.argv[1]]\n"
        "import run, spec\n"
        "b = spec.benchmark()\n"
        "c = spec.cell(b, 'fib_b.seg20b')\n"
        "ctx = run.Window(c, [1, 2, 3], 1.0, 1.0, 0)\n"
        "print(run.read_metrics(b, c.name, 'per_layer', ctx)['jobs_done'])\n"
        "print(c.size['cycles'])\n")
    out = subprocess.run([sys.executable, "-c", code, str(pb)],
                         capture_output=True, text=True, check=True).stdout
    assert out.split("\n")[:2] == ["{'value': 3.0, 'unit': 'jobs'}",
                                   str(cfg["sizes"]["20"]["cycles"])]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_job_inputs_differ_but_not_the_work(small_cell):
    """Jobs of one seed draw different inputs, and execute the same count
    of every operation: the same cycles and the same trace heights."""
    import port

    seed = 2**35 + 17
    inputs = [spec.job_inputs(small_cell, seed, i) for i in range(-1, 4)]
    assert len({tuple(sorted(d.items())) for d in inputs}) == len(inputs)
    assert spec.job_inputs(small_cell, seed, 2) == inputs[3]
    assert spec.job_inputs(small_cell, seed + 1, 2) != inputs[3]
    shapes = set()
    for i in range(3):
        m = port.execute(spec.job_program(small_cell, seed, i),
                         small_cell.program["fp"])
        heights = []
        for chip in m.chips():
            dti = chip.device_trace_inputs(m)
            heights.append(int(dti[1][1]) if dti is not None else
                           int(chip.generate_trace(m).shape[0]))
        shapes.add((int(m.cpu().clock), tuple(heights)))
    assert len(shapes) == 1
    (cycles, heights), = shapes
    assert cycles == small_cell.size["cycles"]
    assert [h.bit_length() - 1 for h in heights] == [
        v["log_height"] for v in small_cell.size["chips"].values()]


ALU_OPS = ("ADD32", "SUB32", "MUL32", "DIV32", "SHL32", "SHR32", "AND32",
           "OR32", "XOR32", "LT32", "LTE32", "SLT32", "SLE32", "EQ32", "NE32")


def test_reference_interpreter_matches_the_port():
    """The reference's interpreter gives the port's final memory and cycle
    count: on the configurations' programs, and on a program of every
    ALU opcode it knows, on cells and on immediates."""
    import port
    from reference import interp

    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"])
        c.size = dict(c.size, loop_count=61)
        instructions = spec.job_program(c, 99, 3)
        m = port.execute(instructions, c.program["fp"])
        assert interp.run(instructions, c.program["fp"]) == \
            port.outcome(m)
    for x, y in ((0xDEADBEEF, 0x12345), (5, 0xFFFFFFF0), (77, 77)):
        program = [["IMM32", -4, x], ["IMM32", -8, y]]
        for i, op in enumerate(ALU_OPS):
            program += [[op, -12 - 8 * i, -4, -8, 0, 0],
                        [op, -16 - 8 * i, -4, 7, 0, 1]]
        program.append(["STOP", 0, 0, 0, 0, 0])
        instructions = spec.instructions({"instructions": program}, {})
        fp = 1 << 24
        assert interp.run(instructions, fp) == port.outcome(
            port.execute(instructions, fp))
