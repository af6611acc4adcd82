"""Decode error-class parity: each corruption class raises the SAME
exception type across all three engines (reference: error.rs:27-62,
decoder.rs:141-235)."""

import pytest

from tests.conftest import make_hydrophone
from x3_tpu.errors import (
    FrameDecodeInvalidBPF,
    FrameDecodeUnexpectedEnd,
    OutOfBoundsInverse,
)
from x3_tpu.models import oracle
from x3_tpu.models.decoder import decode_frame, decode_frames_batch
from x3_tpu.ops.bitio import BitWriter
from x3_tpu.params import Parameters

P = Parameters()
ENGINES = ["jax", "numpy", "native"]


def _decode(payload: bytes, n: int, engine: str):
    if engine == "native":
        from x3_tpu import native

        if not native.available():
            pytest.skip("native toolchain unavailable")
        return native.decode_frame(payload, P, n)
    return decode_frame(payload, P, n, engine=engine)


def _payload_invalid_bfp() -> bytes:
    """ftype 0 block header with num_bits=3 <= 5 (decoder.rs:209-212)."""
    bw = BitWriter()
    bw.write_bits(0, 16)  # raw first sample
    bw.write_bits(0, 2)  # ftype 0 (BFP)
    bw.write_bits(2, 4)  # 4-bit field -> num_bits = 3 (invalid)
    bw.word_align()
    return bw.getvalue()


def _payload_oob_inverse() -> bytes:
    """ftype 1 code whose unary run exceeds RICE0's inv_len=16
    (decoder.rs:156-166)."""
    bw = BitWriter()
    bw.write_bits(0, 16)  # raw first sample
    bw.write_bits(1, 2)  # ftype 1 (Rice r1)
    bw.write_bits(1, 21)  # 20 zeros then stop bit: index 20 >= 16
    bw.word_align()
    return bw.getvalue()


@pytest.mark.parametrize("engine", ENGINES)
def test_invalid_bfp_same_class_across_engines(engine):
    with pytest.raises(FrameDecodeInvalidBPF):
        _decode(_payload_invalid_bfp(), 21, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_oob_inverse_same_class_across_engines(engine):
    with pytest.raises(OutOfBoundsInverse):
        _decode(_payload_oob_inverse(), 21, engine)


def test_kernel_error_codes():
    """The batched kernel reports distinct ERR_* codes per corruption class."""
    from x3_tpu.ops.decode_kernel import ERR_INVALID_BPF, ERR_OOB_INVERSE

    outs, errs = decode_frames_batch(
        [_payload_invalid_bfp(), _payload_oob_inverse()], [21, 21], P
    )
    assert errs[0] == ERR_INVALID_BPF
    assert errs[1] == ERR_OOB_INVERSE


def test_first_error_wins(rng):
    """A frame with a good block then an invalid-BFP block reports BFP (the
    error the reference would hit first when decoding sequentially)."""
    from x3_tpu.ops.decode_kernel import ERR_INVALID_BPF

    wav = make_hydrophone(rng, 41)  # 1 + 2 blocks of 20
    # first sample + one good rice block + one invalid BFP header
    bw = BitWriter()
    bw.write_bits(int(wav[0]) & 0xFFFF, 16)
    bw.write_bits(1, 2)
    for _ in range(20):
        bw.write_bits(1, 1)  # zero-diff rice codes (index 0)
    bw.write_bits(0, 2)  # block 2: ftype 0
    bw.write_bits(1, 4)  # num_bits = 2 (invalid)
    bw.word_align()
    outs, errs = decode_frames_batch([bw.getvalue()], [41], P)
    assert errs[0] == ERR_INVALID_BPF


def test_oversized_payload_same_class_across_engines():
    """A payload longer than the default-geometry worst case (up to the
    format's 0x7fe0 cap) must not crash the pipeline OR diverge from the
    reference: an all-zero payload decodes to the same invalid-BFP error on
    every engine (a zero block header is ftype 0, num_bits=1 <= 5,
    decoder.rs:209-212) — the buffer escalates to hold the whole payload
    (models/decoder.decode_geometry)."""
    from x3_tpu.ops.encode_kernel import frame_geometry

    S, B, L, W = frame_geometry(P)
    big = bytes(W * 4 + 1000)
    with pytest.raises(FrameDecodeInvalidBPF):
        oracle.decode_frame(big, P, S)
    for engine in ("jax", "numpy"):
        with pytest.raises(FrameDecodeInvalidBPF):
            decode_frame(big, P, S, engine=engine)


def test_excess_sample_count_decodes_like_reference():
    """Headers may claim more samples than params.samples_per_frame
    (blocks_per_frame is not in the archive XML, decodefile.rs:295-300);
    the decode walk follows the header count, so this payload hits the
    same invalid-BFP error as the reference, not a geometry clamp."""
    from x3_tpu.ops.decode_kernel import ERR_INVALID_BPF
    from x3_tpu.ops.encode_kernel import frame_geometry

    S, B, L, W = frame_geometry(P)
    payload = _payload_invalid_bfp()
    with pytest.raises(FrameDecodeInvalidBPF):
        oracle.decode_frame(payload, P, S + 999)
    outs, errs = decode_frames_batch([payload], [S + 999], P)
    assert errs[0] == ERR_INVALID_BPF
