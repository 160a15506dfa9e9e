"""Write the guest `programs/sha2_chain.json`: the iterated SHA-256 chain of
a16z's zkVM benchmark suite (`sha2-chain`, https://github.com/a16z/
zkvm-benchmarks), h <- SHA-256(h) on a 32-byte value, in Valida's
instruction set.

    python3 proverbench/tools/sha2_chain.py

Each step hashes the chain's 8-word value as one padded 64-byte block
(the 8 words, 0x80000000, six zero words and the bit length 256) by one
FIPS 180-4 compression from the initial hash value.  The 48-word message schedule and the 64 rounds are
unrolled at fixed frame offsets, since the instruction set has no indexed
load; ROTR is SHR, SHL and OR, and NOT is XOR with the immediate
0xFFFFFFFF, since it has no rotate and no not.  Every step executes the
same instructions whatever the data.  The start words are the inputs
$h0..$h7 and the loop runs $n_steps steps (at least one); the digest then
stands at the offsets `digest` lists.  The benchmark reads the file and
does not run this tool."""

from __future__ import annotations

import json
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "programs" / "sha2_chain.json"
BYTES_PER_INSTR = 24
FP = 0x1000000

# FIPS 180-4 §4.2.2: the round constants
K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
# FIPS 180-4 §5.3.3: the initial hash value
IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c,
      0x1f83d9ab, 0x5be0cd19]
# the padded block's words 8-15 for a 256-bit message
PADDING = [0x80000000, 0, 0, 0, 0, 0, 0, 256]


def _imm(word: int) -> int:
    """A 32-bit immediate as the instruction's signed operand."""
    return word - (1 << 32) if word >= 1 << 31 else word


class _Writer:
    """Instructions and the frame's cells: cell k is at fp - 4(k + 1)."""

    def __init__(self):
        self.ins: list = []
        self.cells = 0

    def cell(self) -> int:
        self.cells += 1
        return -4 * self.cells

    def op(self, name: str, a: int, b: int, c: int, imm: bool = False):
        self.ins.append([name, a, b, c, 0, 1 if imm else 0])

    def rotr(self, dst: int, x: int, n: int, t0: int, t1: int) -> None:
        self.op("SHR32", t0, x, n, imm=True)
        self.op("SHL32", t1, x, 32 - n, imm=True)
        self.op("OR32", dst, t0, t1)

    def sigma(self, dst: int, x: int, rots: tuple, shr: int | None,
              t: list) -> None:
        """dst = ROTR^r0(x) ^ ROTR^r1(x) ^ (ROTR^r2(x), or SHR^shr(x))."""
        t0, t1, r0, r1 = t
        self.rotr(r0, x, rots[0], t0, t1)
        self.rotr(r1, x, rots[1], t0, t1)
        self.op("XOR32", dst, r0, r1)
        if shr is None:
            self.rotr(r0, x, rots[2], t0, t1)
        else:
            self.op("SHR32", r0, x, shr, imm=True)
        self.op("XOR32", dst, dst, r0)


def program() -> dict:
    w = _Writer()
    h = [w.cell() for _ in range(8)]  # the chain's value, and W[0..7]
    iv = [w.cell() for _ in range(8)]
    sched = h + [w.cell() for _ in range(56)]  # W[0..63]
    step, n = w.cell(), w.cell()
    t = [w.cell() for _ in range(4)]
    s0, s1, x0, x1, t1, t2 = (w.cell() for _ in range(6))

    for i in range(8):
        w.ins.append(["IMM32", h[i], f"$h{i}"])
    for i, word in enumerate(IV):
        w.ins.append(["IMM32", iv[i], word])
    for i, word in enumerate(PADDING):
        w.ins.append(["IMM32", sched[8 + i], word])
    w.ins.append(["IMM32", step, 0])
    w.ins.append(["IMM32", n, "$n_steps"])
    fixed = len(w.ins) + 1  # with the closing STOP
    loop = len(w.ins)

    # the message schedule, FIPS 180-4 §6.2.2 step 1
    for j in range(16, 64):
        w.sigma(s0, sched[j - 15], (7, 18), 3, t)
        w.sigma(s1, sched[j - 2], (17, 19), 10, t)
        w.op("ADD32", sched[j], s1, sched[j - 7])
        w.op("ADD32", sched[j], sched[j], s0)
        w.op("ADD32", sched[j], sched[j], sched[j - 16])

    # the 64 rounds (steps 2-3): each writes fresh cells for a and e; the
    # other six working variables are the previous round's cells renamed
    a, b, c, d, e, f, g, hh = iv
    for j in range(64):
        w.sigma(s1, e, (6, 11, 25), None, t)
        w.op("AND32", x0, e, f)
        w.op("XOR32", x1, e, -1, imm=True)
        w.op("AND32", x1, x1, g)
        w.op("XOR32", x0, x0, x1)
        w.op("ADD32", t1, hh, s1)
        w.op("ADD32", t1, t1, x0)
        w.op("ADD32", t1, t1, _imm(K[j]), imm=True)
        w.op("ADD32", t1, t1, sched[j])
        w.sigma(s0, a, (2, 13, 22), None, t)
        w.op("AND32", x0, a, b)
        w.op("AND32", x1, a, c)
        w.op("XOR32", x0, x0, x1)
        w.op("AND32", x1, b, c)
        w.op("XOR32", x0, x0, x1)
        w.op("ADD32", t2, s0, x0)
        new_e, new_a = w.cell(), w.cell()
        w.op("ADD32", new_e, d, t1)
        w.op("ADD32", new_a, t1, t2)
        a, b, c, d, e, f, g, hh = new_a, a, b, c, new_e, e, f, g

    # step 4: the hash value, the chain's next value
    for i, v in enumerate((a, b, c, d, e, f, g, hh)):
        w.op("ADD32", h[i], v, _imm(IV[i]), imm=True)
    w.op("ADD32", step, step, 1, imm=True)
    w.ins.append(["BNE", BYTES_PER_INSTR * loop, step, n, 0, 0])
    per_step = len(w.ins) - loop
    w.ins.append(["STOP", 0, 0, 0, 0, 0])
    return {
        "about": ("a16z zkvm-benchmarks' sha2-chain: $n_steps times h <- "
                  "SHA-256(h) on the 32-byte value h (start words $h0..$h7, "
                  "big-endian), one padded block and one FIPS 180-4 "
                  "compression a step: the 48-word schedule and the 64 rounds "
                  "unrolled at fixed frame offsets, ROTR as SHR, SHL, OR and "
                  "NOT as XOR with 0xFFFFFFFF; written by "
                  "tools/sha2_chain.py"),
        "fp": FP,
        "fixed_cycles": fixed,
        "cycles_per_iter": per_step,
        "loop_count": "$n_steps",
        "digest": h,
        "instructions": w.ins,
    }


def main() -> int:
    p = program()
    with open(OUT, "w") as f:
        f.write("{\n")
        for k, v in p.items():
            if k != "instructions":
                f.write(f"  {json.dumps(k)}: {json.dumps(v)},\n")
        f.write('  "instructions": [\n')
        f.write(",\n".join(f"    {json.dumps(i)}"
                           for i in p["instructions"]))
        f.write("\n  ]\n}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
