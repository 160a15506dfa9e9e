"""The provenance of the challenger's Poseidon constants.

Own copy of valida_tpu/crypto/p3_rng.py (pure python, no array library).
The Valida reference prover builds its challenger permutation as
    ``Perm16::new_from_rng(4, 22, CosetMds::default(),
                           Seeder::from("validia seed").make_rng::<Pcg64>())``
so the 480 round constants come from a deterministic chain:

    "validia seed" --Hash(SipHash-1-3)--> SipRng --fill 32 B--> Pcg64
    (rand_seeder 0.2.3)                          (rand_pcg 0.3.1, Lcg128Xsl64)
    --> 16*30 BabyBear samples (rejection: u32 >> 1, accept < p)

and the MDS matrix is ``CosetMds::<BabyBear, 16>::default()`` (p3-mds): the
Reed-Solomon map "evaluations over subgroup H -> N * evaluations over coset
31*H", with the closed form M[m][j] = (31^16 - 1) / (31 * w^(m-j) - 1), w
the order-16 two-adic generator.

Three points of that chain are ambiguous without the crates at hand (the
SipRng finalisation marker, whether a sample is a Montgomery or a
canonical residue, the orientation of the MDS matrix), so each is a
parameter, and the 2 x 2 x 2 candidate streams are addressable as
"<interpret>-<sip>-<mds>".  The port must give the same words as the JAX
package for every variant; tests/test_torch_challenger.py holds it to
that.
"""

from __future__ import annotations

from ..field import babybear as bb

_M64 = (1 << 64) - 1
_M128 = (1 << 128) - 1


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _M64


def _sipround(v0, v1, v2, v3):
    """The SipHash quarter-round block (siphash reference, rust core)."""
    v0 = (v0 + v1) & _M64
    v1 = _rotl(v1, 13)
    v1 ^= v0
    v0 = _rotl(v0, 32)
    v2 = (v2 + v3) & _M64
    v3 = _rotl(v3, 16)
    v3 ^= v2
    v0 = (v0 + v3) & _M64
    v3 = _rotl(v3, 21)
    v3 ^= v0
    v2 = (v2 + v1) & _M64
    v1 = _rotl(v1, 17)
    v1 ^= v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


class SipHasher:
    """Streaming SipHash-c-d over little-endian 8-byte words (rust-core
    SipHasher13 layout: running length, 8-byte tail buffer)."""

    def __init__(self, k0: int = 0, k1: int = 0, c_rounds: int = 1,
                 d_rounds: int = 3):
        self.c_rounds = c_rounds
        self.d_rounds = d_rounds
        self.length = 0
        self.v = (
            k0 ^ 0x736F6D6570736575,
            k1 ^ 0x646F72616E646F6D,
            k0 ^ 0x6C7967656E657261,
            k1 ^ 0x7465646279746573,
        )
        self.tail = 0
        self.ntail = 0

    def _absorb(self, m: int):
        v0, v1, v2, v3 = self.v
        v3 ^= m
        for _ in range(self.c_rounds):
            v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= m
        self.v = (v0, v1, v2, v3)

    def write(self, data: bytes):
        self.length += len(data)
        i = 0
        if self.ntail:
            need = 8 - self.ntail
            take = min(len(data), need)
            self.tail |= int.from_bytes(data[:take], "little") << (
                8 * self.ntail
            )
            if len(data) < need:
                self.ntail += len(data)
                return
            self._absorb(self.tail)
            self.tail = 0
            self.ntail = 0
            i = need
        while i + 8 <= len(data):
            self._absorb(int.from_bytes(data[i : i + 8], "little"))
            i += 8
        rem = data[i:]
        self.tail = int.from_bytes(rem, "little")
        self.ntail = len(rem)

    def write_u8(self, b: int):
        self.write(bytes([b]))

    def finish(self) -> int:
        """Standard SipHash finalisation (64-bit digest) — used only to
        KAT the round function against the SipHash-2-4 vectors."""
        v0, v1, v2, v3 = self.v
        b = ((self.length & 0xFF) << 56) | self.tail
        v3 ^= b
        for _ in range(self.c_rounds):
            v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= b
        v2 ^= 0xFF
        for _ in range(self.d_rounds):
            v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        return v0 ^ v1 ^ v2 ^ v3

    def hash_str(self, s: str):
        """Rust ``impl Hash for str``: the bytes, then a 0xff terminator."""
        self.write(s.encode())
        self.write_u8(0xFF)


class SipRng:
    """rand_seeder 0.2.3 SipRng: the hasher is finalised without a
    compression (b = len<<56 | tail; v3 ^= b; 1 round; v0 ^= b; v2 ^=
    marker; 3 rounds), then generates in counter mode.  The marker byte is
    selectable: variant "ee" (default) is the SipHash-128 marker 0xEE,
    variant "ff" the SipHash-64 marker 0xFF."""

    MARKERS = {"ee": 0xEE, "ff": 0xFF}

    def __init__(self, hasher: SipHasher, variant: str = "ee"):
        v0, v1, v2, v3 = hasher.v
        b = ((hasher.length & 0xFF) << 56) | hasher.tail
        v3 ^= b
        for _ in range(hasher.c_rounds):
            v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= b
        v2 ^= self.MARKERS[variant]
        for _ in range(hasher.d_rounds):
            v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        self.v = (v0, v1, v2, v3)
        self.ctr = 0

    def next_u64(self) -> int:
        c = self.ctr
        self.ctr = (self.ctr + 1) & _M64
        v0, v1, v2, v3 = self.v
        v3 ^= c
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= c
        self.v = (v0, v1, v2, v3)
        return v0 ^ v1 ^ v2 ^ v3

    def fill_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += self.next_u64().to_bytes(8, "little")
        return bytes(out[:n])


PCG_MULTIPLIER = 0x2360ED051FC65DA44385DF649FCCF645


class Pcg64:
    """rand_pcg 0.3.1 ``Lcg128Xsl64`` (XSL-RR 128/64 output function).

    Matches the crate's published known-answer test (see tests)."""

    def __init__(self, state: int, increment: int):
        # from_state_incr: move away from the initial value, then step
        self.increment = increment | 1
        self.state = (state + self.increment) & _M128
        self._step()

    @classmethod
    def new(cls, state: int, stream: int) -> "Pcg64":
        return cls(state, (stream << 1) | 1)

    @classmethod
    def from_seed(cls, seed: bytes) -> "Pcg64":
        if len(seed) != 32:
            raise ValueError("Pcg64 seed must be 32 bytes")
        state = int.from_bytes(seed[:16], "little")
        incr = int.from_bytes(seed[16:32], "little")
        return cls(state, incr | 1)

    def _step(self):
        self.state = (self.state * PCG_MULTIPLIER + self.increment) & _M128

    def next_u64(self) -> int:
        self._step()
        s = self.state
        rot = s >> 122
        xsl = ((s >> 64) ^ s) & _M64
        return ((xsl >> rot) | (xsl << (64 - rot))) & _M64

    def next_u32(self) -> int:
        return self.next_u64() & 0xFFFFFFFF


def seeder_pcg64(seed: str = "validia seed",
                 sip_variant: str = "ee") -> Pcg64:
    """``Seeder::from(seed).make_rng::<Pcg64>()``: SipHash-1-3 the string
    (rust str hashing), convert to SipRng, fill a 32-byte seed, and seed
    the Lcg128Xsl64."""
    h = SipHasher()
    h.hash_str(seed)
    rng = SipRng(h, variant=sip_variant)
    return Pcg64.from_seed(rng.fill_bytes(32))


def sample_babybear(rng: Pcg64) -> int:
    """p3-baby-bear ``Standard`` sampling: u32 >> 1, rejected unless < p.

    Returns the raw accepted u31 — the stored ``value`` field; see
    `poseidon_round_constants` for the monty/canonical interpretation."""
    while True:
        x = rng.next_u32() >> 1
        if x < bb.P:
            return x


def poseidon_round_constants(n: int, seed: str = "validia seed",
                             interpret: str = "monty",
                             sip_variant: str = "ee") -> list[int]:
    """First n BabyBear round constants of the reference stream, as
    CANONICAL ints.

    interpret="monty": the sampled u31 is the Montgomery residue (p3
    BabyBear post-Monty-refactor) -> canonical = value * 2^-32 mod p.
    interpret="canonical": the sampled u31 is the canonical value.
    sip_variant: SipRng conversion marker ("ee" | "ff" — see SipRng)."""
    rng = seeder_pcg64(seed, sip_variant=sip_variant)
    raw = [sample_babybear(rng) for _ in range(n)]
    if interpret == "canonical":
        return raw
    if interpret != "monty":
        raise ValueError(f"unknown interpretation {interpret!r}")
    rinv = pow(1 << 32, bb.P - 2, bb.P)
    return [x * rinv % bb.P for x in raw]


def coset_mds_matrix(width: int = 16,
                     orientation: str = "mj") -> list[list[int]]:
    """``CosetMds::<BabyBear, W>::default()`` as an explicit matrix.

    p3-mds CosetMds: unscaled inverse DFT over the order-W subgroup H,
    scale coefficient k by shift^k (shift = BabyBear generator 31),
    forward DFT — i.e. N * (evaluations over 31*H of the interpolant).
    Closed form: M[m][j] = sum_k (31 * w^(m-j))^k = (31^W - 1) /
    (31 * w^(m-j) - 1), w = two_adic_generator(log2 W).

    orientation: "mj" (default, exponent m-j) or "jm" (the transpose,
    exponent j-m) — the row/column convention of the matvec is the third
    documented transcript ambiguity; both are pinned by KATs."""
    log_n = width.bit_length() - 1
    if 1 << log_n != width:
        raise ValueError("MDS width must be a power of two")
    w = bb.two_adic_generator(log_n)
    s = bb.GENERATOR
    num = (pow(s, width, bb.P) - 1) % bb.P
    if orientation not in ("mj", "jm"):
        raise ValueError(f"unknown orientation {orientation!r}")
    mat = [
        [
            num * pow((s * pow(w, (m - j) % width, bb.P) - 1) % bb.P,
                      bb.P - 2, bb.P) % bb.P
            for j in range(width)
        ]
        for m in range(width)
    ]
    if orientation == "jm":
        mat = [list(row) for row in zip(*mat)]
    return mat


# the 2 (interpret) x 2 (sip_variant) x 2 (mds orientation) = 8 candidate
# parameter streams, addressable as "<interpret>-<sip>-<mds>"
P3RNG_VARIANTS = [
    f"{interp}-{sip}-{mds}"
    for interp in ("monty", "canonical")
    for sip in ("ee", "ff")
    for mds in ("mj", "jm")
]
P3RNG_DEFAULT_VARIANT = "monty-ee-mj"


def p3rng_params(n_constants: int, variant: str = P3RNG_DEFAULT_VARIANT,
                 width: int = 16, seed: str = "validia seed"):
    """(round_constants, mds_matrix) for one of the 8 candidate streams."""
    interp, sip, mds = variant.split("-")
    rc = poseidon_round_constants(n_constants, seed=seed, interpret=interp,
                                  sip_variant=sip)
    return rc, coset_mds_matrix(width, orientation=mds)
