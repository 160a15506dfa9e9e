"""Advice tape providers (mirrors the Rust `machine/src/advice.rs`).

Counterpart of valida_tpu/core/advice.py."""

from __future__ import annotations

import sys


class AdviceProvider:
    def get_advice(self):
        raise NotImplementedError


class FixedAdviceProvider(AdviceProvider):
    def __init__(self, data: bytes):
        self.data = list(data)
        self.pos = 0

    def get_advice(self):
        if self.pos >= len(self.data):
            return None
        b = self.data[self.pos]
        self.pos += 1
        return b

    @staticmethod
    def empty():
        return FixedAdviceProvider(b"")


class StdinAdviceProvider(AdviceProvider):
    def get_advice(self):
        b = sys.stdin.buffer.read(1)
        return b[0] if b else None


class GlobalAdviceProvider(AdviceProvider):
    """File-backed if a path is given, else stdin."""

    def __init__(self, path: str | None = None):
        if path:
            with open(path, "rb") as f:
                self._inner = FixedAdviceProvider(f.read())
        else:
            self._inner = StdinAdviceProvider()

    def get_advice(self):
        return self._inner.get_advice()
