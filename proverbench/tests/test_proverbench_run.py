"""A run's shape and its judge: the result line, the exits, what the
processes import, and a run with the timed path broken underneath, which
the reference must judge incorrect."""

import json
import subprocess
import sys

import pytest

import port
import run
import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "valida_tpu")
SEED = 2**33 + 101


def test_last_line(monkeypatch, capsys):
    import torch

    checks = {"jobs_failed": {"value": 0, "limit": 0},
              "jobs_judged": {"value": 2, "limit": 1}}
    fake = {"correct": True, "attempted": 3, "failed": 0,
            "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
            "peak": 123, "busy_s": 0.5, "window_s": 2.0,
            "breakdown": {"device_ops": [], "idle_gaps": []},
            "checks": checks}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(run, "power_limit", lambda: "card, 700 W")
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: dict(fake))
    assert run.main(["--workload", "fibonacci.seg20", "--seed", "1",
                     "--seconds", "1", "--trace", "1"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "breakdown", "device", "checks"]
    assert line["device"] == {"platform": "gpu", "kind": "card", "count": 1,
                              "memory_peak_bytes": 123, "busy_s": 0.5,
                              "window_s": 2.0}
    assert err.strip().splitlines()[-2:] == ["jobs_failed 0 (limit 0)",
                                             "jobs_judged 2 (limit 1)"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "fibonacci.seg20", "--seed", "1",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_alone_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and proverbench/."""
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "proverbench/run.py", "--workload",
                        "fibonacci.seg20", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode == 2 and p.stdout == ""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT).stdout
    return set(out.split())


def test_run_imports_neither_jax_nor_the_jax_package(small_cell):
    """A whole run on the CPU (set-up, window, judge) and every metric's
    reader load no module whose top-level name is jax, jaxlib, flax or
    valida_tpu (valida_tpu_torch is the port, a name of its own)."""
    code = (
        "import sys; sys.path[:0] = ['proverbench', '.']\n"
        "import torch; torch.set_num_threads(2)\n"
        "import run, spec, control\n"
        "b = spec.benchmark()\n"
        "c = spec.cell(b, 'fibonacci.short10')\n"
        "out = run.run_cell(b, c, 7, 0.1, False, device='cpu')\n"
        "assert out['correct'], out\n"
        "for kind in ('end_to_end', 'per_layer'):\n"
        "    for m in b[kind]:\n"
        "        spec.metric_reader(m['name'])\n"
        "print(*{m.split('.')[0] for m in sys.modules})\n")
    names = _top_level(code)
    assert "valida_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_port(small_cell, tmp_path):
    """The reference judges a proof with none of the port's modules, JAX
    or the JAX package loaded."""
    cfg = port.prover_config(small_cell.config["profile"], "cpu")
    instructions = spec.job_program(small_cell, SEED, 0)
    m = port.execute(instructions, small_cell.program["fp"])
    path = tmp_path / "proof.cbor"
    path.write_bytes(port.serialize(port.prove(m, cfg), cfg))
    code = (
        "import sys, json; sys.path[:0] = ['proverbench']\n"
        "import torch; torch.set_num_threads(2)\n"
        "from reference import interp, verify\n"
        f"ins = {json.dumps([[op, list(ops)] for op, ops in instructions])}\n"
        f"prof = json.loads({json.dumps(small_cell.config['profile'])!r})\n"
        f"fp = {small_cell.program['fp']}\n"
        "interp.run(ins, fp)\n"
        f"why = verify.judge(open({str(path)!r}, 'rb').read(), ins, fp, prof)\n"
        "assert why is None, why\n"
        "print(*{m.split('.')[0] for m in sys.modules})\n")
    names = _top_level(code)
    assert "reference" in names
    assert not names & (set(FORBIDDEN) | {"valida_tpu_torch"})
    for path in (spec.HERE / "reference").rglob("*.py"):
        for ln in path.read_text().splitlines():
            words = ln.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert not {w.split(".")[0] for w in words[1:]} & (
                    set(FORBIDDEN) | {"valida_tpu_torch"}), (path, ln)


def _stale_prove(monkeypatch):
    """Every prove returns the set-up job's proof: a step that returns its
    state unchanged."""
    real, first = port.prove, []

    def warmup(machine, config):
        first.append(real(machine, config))

    monkeypatch.setattr(port, "warmup", warmup)
    return port, "prove", lambda machine, config: first[0]


def _trace_altered():
    """The CPU chip's trace builder adds one to a word of its trace."""
    from valida_tpu_torch.chips.cpu import CpuChip

    real = CpuChip.build_trace

    def build_trace(self, inputs, meta):
        t = real(self, inputs, meta).clone()
        t[3, 5] += 1
        return t
    return CpuChip, "build_trace", build_trace


def _proof_altered():
    """The proof's bytes with an opened value changed as they are made."""
    import control

    real = port.serialize
    return lambda proof, config: control.tamper_proof(real(proof, config))


def _result_altered():
    """The execution's final memory with one word changed."""
    real = port.outcome

    def outcome(machine):
        memory, cycles = real(machine)
        memory[min(memory)] ^= 4
        return memory, cycles
    return outcome


def _job_raises():
    def serialize(proof, config):
        raise RuntimeError("a job that never comes")
    return port, "serialize", serialize


def _heights_altered(monkeypatch):
    """Every job executes twice its size's loop count."""
    real = spec.job_program

    def job_program(c, seed, index):
        return real(type(c)(**{**c.__dict__, "size": dict(
            c.size, loop_count=2 * c.size["loop_count"])}), seed, index)

    monkeypatch.setattr(spec, "job_program", job_program)
    return port, "execute", port.execute


FAULTS = {
    "sound": None,
    "stale proof": _stale_prove,
    "trace word altered": lambda mp: _trace_altered(),
    "opened value altered": lambda mp: (port, "serialize", _proof_altered()),
    "result altered": lambda mp: (port, "outcome", _result_altered()),
    "job raises": lambda mp: _job_raises(),
    "heights altered": _heights_altered,
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_timed_path_is_incorrect(small_cell, monkeypatch, fault):
    """A run on the CPU, the chip's look skipped, with the timed path
    broken underneath: `correct` comes out false for each fault this cell
    can have (one job at a time on one chip: no batch to halve and no
    exchange between chips), and true without one."""
    if FAULTS[fault] is not None:
        monkeypatch.setattr(*FAULTS[fault](monkeypatch))
    out = run.run_cell(spec.benchmark(), small_cell, SEED, 0.1, False,
                       device="cpu")
    assert out["attempted"] >= 1
    assert out["correct"] is (fault == "sound"), out["checks"]


def test_controls_fail(small_cell):
    """The controls, proofs under a weaker profile than the configuration
    states, are judged incorrect; the sound jobs are not."""
    import control

    (res,) = control.readings(small_cell, [SEED + 1], device="cpu")
    rows = res["readings"]
    for name, v in rows.items():
        bad = v["results_wrong"] + v["proofs_rejected"]
        assert bad == (0 if name.startswith("sound") else 1), (name, v)


@pytest.mark.card
def test_a_cell_on_the_card(card):
    """Two runs of the shortest cell on the card, in processes of their
    own: correct, and the second finds every kernel built."""
    for seed in (SEED, SEED + 1):
        p = subprocess.run([sys.executable, "proverbench/run.py",
                            "--workload", "fibonacci.short10", "--seed",
                            str(seed), "--seconds", "5"], cwd=spec.ROOT,
                           capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["failed"] == 0, line
        (note,) = [ln for ln in p.stdout.splitlines()
                   if ln.startswith("captures: ")]
        words = note.split()
        assert words[1] == words[5], note  # none inside the window
