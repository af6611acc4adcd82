"""Frame-parallel JAX decode vs oracle encode/decode: bit-exact roundtrips."""

import numpy as np
import pytest

from tests.conftest import make_hydrophone, make_mixed
from x3_tpu.models import oracle
from x3_tpu.models.decoder import decode_frame, decode_frames_batch
from x3_tpu.params import Parameters

P = Parameters()


def frames_of(wav):
    """Oracle-encode wav and split into (payload, n_samples) frames."""
    stream = oracle.encode(wav, P)
    out, pos = [], 0
    while pos < len(stream):
        h = stream[pos : pos + 20]
        ns = int.from_bytes(h[4:6], "big")
        pl = int.from_bytes(h[6:8], "big")
        out.append((stream[pos + 20 : pos + 20 + pl], ns))
        pos += 20 + pl
    return out


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 9_999, 10_000, 10_001, 25_000])
def test_decode_hydrophone_sizes(rng, n):
    wav = make_hydrophone(rng, n)
    frames = frames_of(wav)
    outs, err = decode_frames_batch([p for p, _ in frames], [s for _, s in frames], P)
    assert not err.any()
    np.testing.assert_array_equal(np.concatenate(outs), wav)


def test_decode_mixed(rng):
    wav = make_mixed(rng, 34_567)
    frames = frames_of(wav)
    outs, err = decode_frames_batch([p for p, _ in frames], [s for _, s in frames], P)
    assert not err.any()
    np.testing.assert_array_equal(np.concatenate(outs), wav)


def test_decode_white_noise(rng):
    wav = rng.integers(-32768, 32768, 12_345).astype(np.int16)
    frames = frames_of(wav)
    outs, err = decode_frames_batch([p for p, _ in frames], [s for _, s in frames], P)
    assert not err.any()
    np.testing.assert_array_equal(np.concatenate(outs), wav)


def test_decode_silence():
    wav = np.zeros(20_000, dtype=np.int16)
    frames = frames_of(wav)
    outs, err = decode_frames_batch([p for p, _ in frames], [s for _, s in frames], P)
    assert not err.any()
    np.testing.assert_array_equal(np.concatenate(outs), wav)


def test_decode_golden_frame(golden):
    frame = bytes(golden["frame_expected"])
    ns = int.from_bytes(frame[4:6], "big")
    out = decode_frame(frame[20:], P, ns)
    np.testing.assert_array_equal(out, golden["frame_wav"])


def test_decode_corrupt_flags_error(rng):
    wav = make_hydrophone(rng, 5_000)
    (payload, ns), = frames_of(wav)
    # Invalid BFP header: ftype=0, field=2 -> num_bits=3 (<=5 is invalid).
    bad = bytearray(payload)
    bad[2] = 0b00_0010_00
    _, err = decode_frames_batch([bytes(bad)], [ns], P)
    assert err[0]


def test_decode_vs_oracle_per_frame(rng):
    wav = make_mixed(rng, 10_000)
    (payload, ns), = frames_of(wav)
    want = oracle.decode_frame(payload, P, ns)
    got = decode_frame(payload, P, ns)
    np.testing.assert_array_equal(got, want)


def test_decode_frames_checked_crc(rng):
    """Device-fused CRC: matches the true payload CRC; flags corruption."""
    from x3_tpu.ops.crc import crc16
    from x3_tpu.ops.decode_kernel import decode_frames_checked
    from x3_tpu.ops.encode_kernel import frame_geometry

    S, B, L, W = frame_geometry(P)
    wav = make_hydrophone(rng, 10_000)
    payload, want_crc = oracle.encode_frame_payload(wav, P)
    bad = bytearray(payload)
    bad[7] ^= 0x10
    buf = np.zeros((2, W * 4), np.uint8)
    buf[0, : len(payload)] = np.frombuffer(payload, np.uint8)
    buf[1, : len(bad)] = np.frombuffer(bytes(bad), np.uint8)
    ns = np.array([10_000, 10_000], np.int32)
    plens = np.array([len(payload), len(bad)], np.int32)
    out, err, crc = decode_frames_checked(buf, ns, plens, P)
    crc = np.asarray(crc)
    assert crc[0] == want_crc == crc16(payload)
    assert crc[1] == crc16(bytes(bad)) != want_crc
    np.testing.assert_array_equal(np.asarray(out)[0], wav)


def test_decode_width_rung_independent(rng):
    """decode_frames infers W from the buffer shape; a compact rung must
    give identical samples, error codes, and device CRCs to the full
    width — on clean AND corrupt payloads (overrun verdicts are pinned to
    the format's worst-case width, not the buffer width)."""
    from x3_tpu.ops.decode_kernel import decode_frames_checked
    from x3_tpu.ops.encode_kernel import frame_geometry, width_rungs

    S, B, L, W = frame_geometry(P)
    rungs = width_rungs(P)
    assert rungs[0] < W
    wav = make_hydrophone(rng, 20_000)
    frames = frames_of(wav)
    payloads = [np.frombuffer(p, np.uint8) for p, _ in frames]
    # corrupt lane: bit flips deep in the stream (drives the walk off
    # course without breaking the raw first sample)
    bad = payloads[1].copy()
    bad[50:60] ^= 0xFF
    payloads.append(bad)
    ns = np.array([s for _, s in frames] + [frames[1][1]], np.int32)
    plens = np.array([len(a) for a in payloads], np.int32)

    def run(w):
        buf = np.zeros((len(payloads), w * 4), np.uint8)
        for i, a in enumerate(payloads):
            buf[i, : len(a)] = a
        return decode_frames_checked(buf, ns, plens, P)

    w_fit = next(r for r in rungs if max(len(a) for a in payloads) <= r * 4)
    assert w_fit < W
    out_c, err_c, crc_c = run(w_fit)
    out_f, err_f, crc_f = run(W)
    np.testing.assert_array_equal(np.asarray(out_c), np.asarray(out_f))
    np.testing.assert_array_equal(np.asarray(err_c), np.asarray(err_f))
    np.testing.assert_array_equal(np.asarray(crc_c), np.asarray(crc_f))
