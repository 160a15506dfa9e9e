"""The eight programs of tests/test_golden_programs.py (the Rust
reference's `basic/tests/test_prover.rs` and `test_static_data.rs`, and
the JAX package's signed-ALU and byte-op programs), run and proved by the
port on the CPU: each with the memory cells that test asserts, verified by
the port, and its proof held by SHA-256 to the JAX package's bytes
(constants made by tests/test_torch_basic.py::reference_basic_digest, so
the suite does not rerun eight reference proves)."""

import hashlib

import pytest
import torch

from tests.test_torch_basic import GOLDEN, port_machine, reference_basic_digest
from valida_tpu_torch.core import config
from valida_tpu_torch.tooling import serde

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's CPU
    operations on one thread each keep them from crowding the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# JAX_PLATFORMS=cpu python -c "from tests.test_torch_basic import
# reference_basic_digest as r; print(r('loadfp'))"
DIGESTS = {
    "left_imm_ops":
        "62cbc799e9f3e1d745ed96841dad7b16c1adf2915f90ac6cb67e29270d190ba4",
    "signed_inequality":
        "9d7b8ecb2b1ca89ea36958cd9e740c48a200d8862ce7d1f172b9faefc7650515",
    "loadfp":
        "2b4dbaf3bde351d2304f27da2825ee78512586e685edf5ea41f86a29c6b5d383",
    "static_data":
        "949d8bbd1be23f8fb125c4088cddd8a586e6066f9f2b12ebfda90f4e462ef54f",
    "storeu8_fresh_address":
        "5e2c53f349cb627ef223bb55340728d556785479076b182cde0d34c6b188d626",
    "byte_ops_every_slot":
        "d12f58d4432cc3dd4d62d085dc2c05dcd538fec1d195f89db5d8fea8c083c368",
    "signed_alu":
        "d5c4d28da24b8f1e9757d8433be4d7d78e298e16ed9d33bf68b6f77dce25a8a6",
    "alu_mix":
        "b3880503c90fd4f927a2c4393dbe537b47e71fb2837c23b6a517e6452d54daae",
}


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_program(name):
    m = port_machine(name)
    _rows, _static, cells = GOLDEN[name]
    for off, want in cells.items():
        if off == "abs":
            for addr, w in want.items():
                assert m.mem().cells[addr] == w, f"address {addr:#x}"
        else:
            assert m.mem().cells[0x1000 + off] == want, f"offset {off}"
    cfg = config.test_config(device="cpu")
    proof = m.prove(cfg)
    m.verify(cfg, proof)
    assert hashlib.sha256(serde.serialize_proof(proof)).hexdigest() \
        == DIGESTS[name]


def test_reference_digest_helper():
    """The helper that made DIGESTS still makes them (the cheapest
    program, proved live by the JAX package)."""
    assert reference_basic_digest("loadfp") == DIGESTS["loadfp"]
