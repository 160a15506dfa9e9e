"""The reader of the port's proof-serialization counter
(proverbench/metrics/serialize_int_words_per_job.py) on set values of the
counter, and on a port without it."""

import pytest

import spec


def test_serialize_int_words_read_the_ports_counter(monkeypatch):
    """serialize_int_words_per_job is the port's serialization counter,
    int words over serializations; None where the port has no such counter
    or serialized nothing."""
    from valida_tpu_torch.tooling import serde

    read = spec.metric_reader("serialize_int_words_per_job")
    monkeypatch.setattr(serde, "stats",
                        {"serializations": 4, "int_words": 4 * 17 + 2})
    assert read(None) == pytest.approx((4 * 17 + 2) / 4)
    monkeypatch.setattr(serde, "stats", {"serializations": 0, "int_words": 0})
    assert read(None) is None
    monkeypatch.delattr(serde, "stats")
    assert read(None) is None
