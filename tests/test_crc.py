import numpy as np

from x3_tpu.ops.crc import crc16, crc16_many, update_crc16


def test_crc_header_vector(golden):
    """Golden vector from reference crc.rs:78-92."""
    header = bytes(golden["crc_header"])
    assert crc16(header[0:16]) == 0xADDB


def test_crc_payload_vector(golden):
    """Golden vector from reference crc.rs:94-105."""
    assert crc16(bytes(golden["crc_payload"])) == 2073


def test_update_crc16_matches_crc16():
    data = bytes(range(256))
    crc = 0xFFFF
    for b in data:
        crc = update_crc16(crc, b)
    assert crc == crc16(data)


def test_crc16_many_matches_scalar(rng):
    n, max_len = 17, 97
    rows = rng.integers(0, 256, (n, max_len)).astype(np.uint8)
    lengths = rng.integers(0, max_len + 1, n)
    lengths[0] = 0
    lengths[1] = max_len
    got = crc16_many(rows, lengths)
    want = [crc16(bytes(rows[i, : lengths[i]])) for i in range(n)]
    assert got.tolist() == want


def test_crc16_empty():
    assert crc16(b"") == 0xFFFF
