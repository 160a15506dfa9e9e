"""Duplex challenger (Fiat-Shamir) over BabyBear with Poseidon-16.

Counterpart of valida_tpu/crypto/challenger.py, with p3-challenger's
DuplexChallenger semantics:
  * observe(v): clear the output buffer, push v to the input buffer;
    duplex when the input buffer holds WIDTH values.
  * duplex: overwrite the state's prefix with the buffered inputs, permute,
    output buffer := the whole state.
  * sample(): duplex if inputs are pending or no output is left; pop from
    the end of the output buffer.
  * sample_bits(b): the low b bits of a sampled element's canonical value.
  * sample_ext: D successive samples as coefficients.

It runs on the host: the state is 16 words and strictly sequential, and
each duplex is one call of the module's `permute_host` (C++).
"""

from __future__ import annotations

from ..field import babybear as bb
from ..field import ext as extf
from .poseidon import WIDTH, permute_host


class DuplexChallenger:
    def __init__(self):
        self.state = [0] * WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger()
        c.state = list(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplex(self):
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        self.state = permute_host(self.state).tolist()
        self.output_buffer = list(self.state)

    def observe(self, value: int):
        self.output_buffer.clear()
        self.input_buffer.append(int(value) % bb.P)
        if len(self.input_buffer) == WIDTH:
            self._duplex()

    def observe_wrapped_u32(self, value: int):
        """Observe an arbitrary u32 (a Keccak digest word, say) mod p."""
        self.observe(int(value) % bb.P)

    def observe_digest(self, digest):
        for w in digest:
            self.observe_wrapped_u32(int(w))

    def observe_ext(self, e):
        for c in e:
            self.observe(int(c))

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def sample_ext(self):
        return tuple(self.sample() for _ in range(extf.D))

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int, max_iters: int = 1 << 24) -> int:
        """The smallest witness w with sample_bits(bits) == 0 after
        observing w, by a host loop; commit/fri.py's `grind_device`
        searches in batches."""
        for w in range(max_iters):
            c = self.clone()
            c.observe(w)
            if c.sample_bits(bits) == 0:
                self.observe(w)
                if self.sample_bits(bits) != 0:
                    raise RuntimeError("grind: witness does not replay")
                return w
        raise RuntimeError("grind failed")
