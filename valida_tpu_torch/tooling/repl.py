"""Interactive debugger REPL (mirrors the `interactive` action of
`basic/src/bin/valida.rs:105-328`): stepping, breakpoints, frame and memory
inspection, disassembly listing, reset.

Counterpart of valida_tpu/tooling/repl.py.
"""

from __future__ import annotations

from ..core import opcodes as OC
from ..core.advice import AdviceProvider
from ..core.program import disassemble
from ..machine.basic import BasicMachine, DID_STOP

HELP = """commands:
  s [n]        step n instructions (default 1)
  c            continue to breakpoint / stop
  b <pc>       toggle breakpoint at pc
  f [n]        show current frame (n words around fp, default 8)
  m <addr> [n] show n memory words from addr (default 8)
  l            list program disassembly around pc
  status       machine status (pc / fp / clock)
  r            reset machine
  q            quit
"""


class Repl:
    def __init__(self, make_machine, advice: AdviceProvider):
        self.make_machine = make_machine
        self.advice = advice
        self.machine: BasicMachine = make_machine()
        self.breakpoints: set[int] = set()
        self.stopped = False

    def _status(self) -> str:
        cpu = self.machine.cpu()
        return f"pc={cpu.pc} fp={cpu.fp} clk={cpu.clock} stopped={self.stopped}"

    def _step(self, n: int = 1) -> str:
        out = []
        for _ in range(n):
            if self.stopped:
                out.append("machine has stopped")
                break
            iw = self.machine.program().program_rom.get_instruction(
                self.machine.cpu().pc
            )
            out.append(f"[{self.machine.cpu().pc}] {disassemble(iw)}")
            if self.machine.step(self.advice) == DID_STOP:
                self.stopped = True
                out.append("STOP")
                break
        return "\n".join(out)

    def _continue(self) -> str:
        steps = 0
        while not self.stopped:
            if self.machine.step(self.advice) == DID_STOP:
                self.stopped = True
                return f"stopped after {steps} steps"
            steps += 1
            if self.machine.cpu().pc in self.breakpoints:
                return f"breakpoint at pc={self.machine.cpu().pc} ({steps} steps)"
            if steps > 100_000_000:
                return "step limit reached"
        return "machine has stopped"

    def _frame(self, n: int = 8) -> str:
        fp = self.machine.cpu().fp
        lines = []
        for i in range(n, -n - 1, -1):
            addr = (fp + 4 * i) & 0xFFFFFFFF
            lines.append(f"  {4*i:+6d}(fp) [{addr:#010x}] = "
                         f"{self.machine.mem().examine(addr)}")
        return "\n".join(lines)

    def _memory(self, addr: int, n: int = 8) -> str:
        return "\n".join(
            f"  [{addr + 4*i:#010x}] = {self.machine.mem().examine(addr + 4*i)}"
            for i in range(n)
        )

    def _list(self, window: int = 8) -> str:
        rom = self.machine.program().program_rom
        pc = self.machine.cpu().pc
        lines = []
        for i in range(max(0, pc - window), min(len(rom), pc + window + 1)):
            mark = "=>" if i == pc else "  "
            bp = "*" if i in self.breakpoints else " "
            lines.append(f"{mark}{bp}{i:5d}: {disassemble(rom.get_instruction(i))}")
        return "\n".join(lines)

    def dispatch(self, line: str) -> str | None:
        parts = line.split()
        if not parts:
            return ""
        cmd, args = parts[0], parts[1:]
        if cmd == "q":
            return None
        if cmd == "s":
            return self._step(int(args[0]) if args else 1)
        if cmd == "c":
            return self._continue()
        if cmd == "b":
            pc = int(args[0])
            if pc in self.breakpoints:
                self.breakpoints.discard(pc)
                return f"breakpoint removed at {pc}"
            self.breakpoints.add(pc)
            return f"breakpoint set at {pc}"
        if cmd == "f":
            return self._frame(int(args[0]) if args else 8)
        if cmd == "m":
            return self._memory(int(args[0], 0), int(args[1]) if len(args) > 1 else 8)
        if cmd == "l":
            return self._list()
        if cmd == "status":
            return self._status()
        if cmd == "r":
            self.machine = self.make_machine()
            self.stopped = False
            return "machine reset"
        return HELP

    def run(self):
        print("valida interactive debugger; 'q' to quit, '?' for help")
        while True:
            try:
                line = input("(valida) ")
            except EOFError:
                break
            out = self.dispatch(line)
            if out is None:
                break
            print(out)
