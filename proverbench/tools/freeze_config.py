"""Write a configuration's frozen shapes and counts into its file.

    python3 proverbench/tools/freeze_config.py CONFIG LOG_CYCLES...

For each size it executes job 0 of seed 0 with the port on the CPU and
records, per chip: the trace's log height, the main, permutation and
preprocessed widths, the quotient's log degree, and the issue slots of one
row of the chip's constraint program (`quotient_slots`, counted as
chip_smoke.py's `constraint_slots` counts them), with the cycle count and
the loop count.  The benchmark reads these numbers and never recomputes
them: the rooflines stay put whatever a later change does to the
constraint programs.  This tool imports the port and is not run by the
benchmark."""

from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import spec  # noqa: E402

# chip_smoke.py's counting of a row program's issue slots: (multiplies,
# all instructions) of each instruction form on canonical operands, a
# canon (3) for each column word the row reads, and the row's end
CANON_OPS = 3
CONSTRAINT_FORM_OPS = {
    ("add", False, False): (0, 3), ("sub", False, False): (0, 3),
    ("neg", False): (0, 3),
    ("add", True, False): (0, 3), ("add", False, True): (0, 3),
    ("add", True, True): (0, 15), ("sub", True, False): (0, 3),
    ("sub", False, True): (0, 15), ("sub", True, True): (0, 15),
    ("neg", True): (0, 15),
    ("mul", False, False): (3, 5), ("mul", True, False): (15, 25),
    ("mul", False, True): (15, 25), ("mul", True, True): (35, 75),
    ("acc", False, False): (1, 3), ("acc", True, False): (5, 15),
    ("acc", False, True): (5, 15), ("acc", True, True): (25, 85),
}
CONSTRAINT_ROW_END_OPS = (5 * 2 + 5 * 3, 5 * 4 + 5 * 5)


def constraint_slots(prog) -> float:
    from valida_tpu_torch.air import program

    muls, ops = CONSTRAINT_ROW_END_OPS
    for form, n in prog.forms.items():
        m, a = CONSTRAINT_FORM_OPS[form]
        muls, ops = muls + n * m, ops + n * a
    words = {program.K_MAIN_L: 1, program.K_MAIN_N: 1, program.K_PREP_L: 1,
             program.K_PREP_N: 1, program.K_PERM_L: 5, program.K_PERM_N: 5}
    read = set()
    for c, _dst, a, b in prog.code[prog.n_uniform:].tolist():
        operands = [((c >> 8) & 15, a)]
        if c & 15 != program.OP_NEG:
            operands.append(((c >> 12) & 15, b))
        read.update(o for o in operands if o[0] in words)
    ops += CANON_OPS * sum(words[kind] for kind, _ in read)
    return max(muls, ops / 2)


def size_entry(c: spec.Cell) -> dict:
    import torch

    import port
    from valida_tpu_torch.air.program import chip_program
    from valida_tpu_torch.air.quotient import get_log_quotient_degree

    torch.set_num_threads(4)
    port.build("cpu")
    instructions = spec.job_program(c, 0, 0)
    m = port.execute(instructions, c.program["fp"])
    chips = {}
    for chip in m.chips():
        dti = chip.device_trace_inputs(m)
        h = (int(dti[1][1]) if dti is not None
             else int(chip.generate_trace(m).shape[0]))
        lh = h.bit_length() - 1
        prep = chip.preprocessed_trace()
        chips[chip.name] = {
            "log_height": lh,
            "main_width": int(chip.width()),
            "perm_width": (len(chip.all_interactions(m)) + 1) * 5,
            "prep_width": 0 if prep is None else int(prep.shape[1]),
            "log_qd": int(get_log_quotient_degree(m, chip)),
            "quotient_slots": constraint_slots(chip_program(m, chip, lh)),
        }
    return {"loop_count": int(c.size["loop_count"]),
            "cycles": int(m.cpu().clock), "chips": chips}


def main(argv) -> int:
    name, sizes = argv[0], [int(x) for x in argv[1:]]
    bench = spec.benchmark()
    entry = spec.config_entry(bench, name)
    path = spec.ROOT / entry["file"]
    config = spec.load_json(path)
    for k in sizes:
        c = spec.Cell(name, 1, config, {"log_cycles": k},
                      spec.load_json(spec.HERE / "programs"
                                     / f"{config['program']}.json"),
                      config["sizes"][str(k)])
        config["sizes"][str(k)] = size_entry(c)
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
