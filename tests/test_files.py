"""File layer + CLI: archive format, roundtrips, error behavior."""

import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import REPO_ROOT, make_hydrophone, make_mixed
from x3_tpu import archive
from x3_tpu.errors import FrameHeaderInvalidPayloadCRC
from x3_tpu.files import X3aReader, wav_to_x3a, x3a_to_wav
from x3_tpu.params import Parameters
from x3_tpu.utils.wav import read_wav, write_wav
from x3_tpu.utils.xmlmeta import build_xml, parse_xml


def test_xml_roundtrip():
    p = Parameters()
    xml = build_xml(96000, p)
    fs, params = parse_xml(xml)
    assert fs == 96000
    assert params == p
    # Exact reference XML bytes (encodefile.rs:93-117).
    assert xml.startswith(b'<X3ARCH PROG="x3new.m" VERSION="2.0" />')
    assert b'<CODES N="4">RICE0,RICE1,RICE3,BFP</CODES>' in xml
    assert b'<T N="3">3,8,20</T>' in xml


def test_archive_header_roundtrip():
    p = Parameters()
    hdr = archive.build_archive_header(44100, p)
    assert hdr[:8] == b"X3ARCHIV"
    assert len(hdr) % 2 == 0
    spec, size = archive.parse_archive_header(hdr)
    assert size == len(hdr)
    assert spec.sample_rate == 44100
    assert spec.params == p


def test_wav_io_roundtrip(tmp_path, rng):
    wav = make_hydrophone(rng, 4321)
    path = tmp_path / "t.wav"
    write_wav(path, wav, 44100)
    got, rate = read_wav(path)
    assert rate == 44100
    np.testing.assert_array_equal(got, wav)


@pytest.mark.parametrize("engine", ["jax", "numpy"])
def test_file_roundtrip(tmp_path, rng, engine):
    wav = make_mixed(rng, 25_000)
    wav_path = tmp_path / "in.wav"
    x3a_path = tmp_path / "out.x3a"
    back_path = tmp_path / "back.wav"
    write_wav(wav_path, wav, 44100)
    wav_to_x3a(wav_path, x3a_path, engine=engine)
    errors = x3a_to_wav(x3a_path, back_path, engine=engine)
    assert errors == 0
    got, rate = read_wav(back_path)
    assert rate == 44100
    np.testing.assert_array_equal(got, wav)


def test_x3a_reader(tmp_path, rng):
    wav = make_hydrophone(rng, 23_456)
    wav_path = tmp_path / "in.wav"
    x3a_path = tmp_path / "out.x3a"
    write_wav(wav_path, wav, 96000)
    wav_to_x3a(wav_path, x3a_path)

    reader = X3aReader.open(x3a_path)
    assert reader.spec.sample_rate == 96000
    assert len(reader) == 3
    chunks = []
    while (chunk := reader.decode_next_frame()) is not None:
        chunks.append(chunk)
    assert reader.frame_errors == 0
    np.testing.assert_array_equal(np.concatenate(chunks), wav)


def test_payload_crc_error_raises(tmp_path, rng):
    wav = make_hydrophone(rng, 12_000)
    wav_path = tmp_path / "in.wav"
    x3a_path = tmp_path / "out.x3a"
    write_wav(wav_path, wav, 44100)
    wav_to_x3a(wav_path, x3a_path)
    data = bytearray(x3a_path.read_bytes())
    data[-10] ^= 0xFF  # corrupt last frame's payload
    x3a_path.write_bytes(bytes(data))
    with pytest.raises(FrameHeaderInvalidPayloadCRC):
        x3a_to_wav(x3a_path, tmp_path / "back.wav")


def test_resync_skips_corrupt_frame(tmp_path, rng):
    wav = make_hydrophone(rng, 30_000)  # 3 frames
    wav_path = tmp_path / "in.wav"
    x3a_path = tmp_path / "out.x3a"
    write_wav(wav_path, wav, 44100)
    wav_to_x3a(wav_path, x3a_path)
    data = bytearray(x3a_path.read_bytes())
    # Corrupt the middle frame's payload.
    hdr = archive.parse_archive_header(bytes(data))[1]
    index = list(archive.walk_frames(bytes(data), hdr))
    off1, h1 = index[1]
    data[off1 + 5] ^= 0xFF
    x3a_path.write_bytes(bytes(data))
    errors = x3a_to_wav(x3a_path, tmp_path / "back.wav", resync=True)
    assert errors == 1
    got, _ = read_wav(tmp_path / "back.wav")
    np.testing.assert_array_equal(got, np.concatenate([wav[:10_000], wav[20_000:]]))


def test_find_sync(rng):
    wav = make_hydrophone(rng, 5000)
    from x3_tpu.models import oracle

    frame = oracle.encode(wav, Parameters())
    data = b"\x99" * 137 + frame
    assert archive.find_sync(data, 0) == 137


def test_x3a_info(tmp_path, rng):
    from x3_tpu.files import x3a_info

    wav = make_hydrophone(rng, 25_000)  # 3 frames (last one short)
    wav_path, x3a_path = tmp_path / "in.wav", tmp_path / "out.x3a"
    write_wav(wav_path, wav, 96_000)
    wav_to_x3a(wav_path, x3a_path, engine="numpy")
    info = x3a_info(x3a_path)
    assert info["sample_rate"] == 96_000
    assert info["n_frames"] == 3
    assert info["n_samples"] == 25_000
    assert info["archive_bytes"] == x3a_path.stat().st_size
    assert info["pcm_bytes"] == 50_000
    # header index accounts for every byte: archive header + frame
    # headers + payloads == file size
    assert (
        info["archive_header_bytes"] + info["frame_header_bytes"] + info["payload_bytes"]
        == info["archive_bytes"]
    )
    assert info["compression_ratio"] > 1.5  # hydrophone class compresses ~3x
    assert info["duration_s"] == pytest.approx(25_000 / 96_000, abs=1e-3)

    # info stays usable on a damaged archive (resync walk): destroying
    # frame 1's sync byte drops it from the stats instead of raising
    data = bytearray(x3a_path.read_bytes())
    hdr = archive.parse_archive_header(bytes(data))[1]
    index = list(archive.walk_frames(bytes(data), hdr))
    off1, _ = index[1]
    data[off1 - 20] ^= 0xFF
    dmg = tmp_path / "dmg.x3a"
    dmg.write_bytes(bytes(data))
    dinfo = x3a_info(dmg)
    assert dinfo["n_frames"] == 2
    assert dinfo["n_samples"] < 25_000


@pytest.mark.parametrize("engine", ["numpy", "jax"])
def test_verify_x3a(tmp_path, rng, engine):
    from x3_tpu.files import verify_x3a

    wav = make_hydrophone(rng, 30_000)  # 3 frames
    wav_path, x3a_path = tmp_path / "in.wav", tmp_path / "out.x3a"
    write_wav(wav_path, wav, 44100)
    wav_to_x3a(wav_path, x3a_path, engine="numpy")

    report = verify_x3a(x3a_path, engine=engine)
    assert report["ok"]
    assert report["n_frames"] == 3
    assert report["frame_errors"] == 0
    assert report["n_samples_ok"] == 30_000
    assert report["skipped_bytes"] == 0

    # Corrupt the MIDDLE frame's payload: verify reports it but still checks
    # (and passes) the final frame — unlike the reference's stop-at-first-bad.
    data = bytearray(x3a_path.read_bytes())
    hdr = archive.parse_archive_header(bytes(data))[1]
    index = list(archive.walk_frames(bytes(data), hdr))
    off1, _ = index[1]
    data[off1 + 5] ^= 0xFF
    bad = tmp_path / "bad.x3a"
    bad.write_bytes(bytes(data))
    report = verify_x3a(bad, engine=engine)
    assert not report["ok"]
    assert report["n_frames"] == 3
    assert report["frame_errors"] == 1
    assert report["n_samples_ok"] == 20_000

    # Truncate mid-payload: the lost tail shows up as skipped bytes.
    trunc = tmp_path / "trunc.x3a"
    trunc.write_bytes(x3a_path.read_bytes()[:-64])
    report = verify_x3a(trunc, engine=engine)
    assert not report["ok"]
    assert report["n_frames"] == 2
    assert report["skipped_bytes"] > 0


def test_cli_info_verify(tmp_path, rng):
    from x3_tpu.cli import main as cli_main

    wav = make_hydrophone(rng, 12_000)
    wav_path, x3a_path = tmp_path / "in.wav", tmp_path / "out.x3a"
    write_wav(wav_path, wav, 44100)
    wav_to_x3a(wav_path, x3a_path, engine="numpy")

    # --info and --verify need no --output and exit 0 on a clean archive
    assert cli_main(["-i", str(x3a_path), "--info", "--engine", "numpy"]) == 0
    assert cli_main(["-i", str(x3a_path), "--verify", "--engine", "numpy"]) == 0

    # damaged archive -> exit 1
    data = bytearray(x3a_path.read_bytes())
    data[-10] ^= 0xFF
    x3a_path.write_bytes(bytes(data))
    assert cli_main(["-i", str(x3a_path), "--verify", "--engine", "numpy", "-q"]) == 1

    # still rejects a .wav input, and conversion still demands --output
    with pytest.raises(SystemExit):
        cli_main(["-i", str(wav_path), "--info"])
    with pytest.raises(SystemExit):
        cli_main(["-i", str(wav_path)])


def test_cli_roundtrip(tmp_path, rng):
    wav = make_hydrophone(rng, 15_000)
    wav_path = tmp_path / "in.wav"
    x3a_path = tmp_path / "out.x3a"
    back_path = tmp_path / "back.wav"
    write_wav(wav_path, wav, 44100)
    env = {
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": str(REPO_ROOT),
        "PATH": "/usr/bin:/bin:/usr/local/bin",
    }
    r1 = subprocess.run(
        [sys.executable, "-m", "x3_tpu", "--input", str(wav_path), "--output", str(x3a_path)],
        capture_output=True, text=True, env=env,
    )
    assert r1.returncode == 0, r1.stderr
    assert "Statistics:" in r1.stdout
    r2 = subprocess.run(
        [sys.executable, "-m", "x3_tpu", "-i", str(x3a_path), "-o", str(back_path)],
        capture_output=True, text=True, env=env,
    )
    assert r2.returncode == 0, r2.stderr
    assert "sample rate: 44100" in r2.stdout
    got, _ = read_wav(back_path)
    np.testing.assert_array_equal(got, wav)
    # Same-type in/out must fail (bin/x3.rs:74-76).
    r3 = subprocess.run(
        [sys.executable, "-m", "x3_tpu", "-i", str(wav_path), "-o", str(wav_path)],
        capture_output=True, text=True, env=env,
    )
    assert r3.returncode != 0


def test_cli_range_extract(tmp_path, rng):
    """--range START[:COUNT] decodes a sample window via the frame index
    (random access, our extension over bin/x3.rs)."""
    from x3_tpu.cli import main as cli_main

    wav = np.clip(np.cumsum(rng.integers(-4, 5, 25_000)), -30000, 30000).astype(np.int16)
    wp, xp = tmp_path / "r.wav", tmp_path / "r.x3a"
    write_wav(wp, wav, 48000)
    assert cli_main(["-i", str(wp), "-o", str(xp), "-q", "--engine", "numpy"]) == 0

    out = tmp_path / "mid.wav"
    assert cli_main(
        ["-i", str(xp), "-o", str(out), "--engine", "numpy", "--range", "9990:40"]
    ) == 0
    got, rate = read_wav(out)
    assert rate == 48000
    np.testing.assert_array_equal(got, wav[9990:10030])

    # START: (to end), clamped at the archive bound
    out2 = tmp_path / "tail.wav"
    assert cli_main(["-i", str(xp), "-o", str(out2), "--engine", "numpy", "--range", "24000:"]) == 0
    got2, _ = read_wav(out2)
    np.testing.assert_array_equal(got2, wav[24000:])

    # --range only makes sense decoding an archive
    with pytest.raises(SystemExit):
        cli_main(["-i", str(wp), "-o", str(xp), "--range", "0:10"])
    with pytest.raises(SystemExit):
        cli_main(["-i", str(xp), "-o", str(out), "--range", "abc"])


def test_wav_to_str(tmp_path):
    wav = np.arange(-8, 28, dtype=np.int16)
    path = tmp_path / "t.wav"
    write_wav(path, wav, 22050)
    from x3_tpu import wav_to_str
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        wav_to_str.main(["--wav", str(path)])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "bits_per_sample: 16"
    assert lines[1] == "channels: 1"
    assert lines[2] == "sample_rate: 22050"
    assert lines[3].split() == [str(v) for v in wav[:16]]
    assert lines[4].split() == [str(v) for v in wav[16:32]]


def test_file_roundtrip_native_engine(tmp_path, rng):
    from x3_tpu import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    wav = make_mixed(rng, 15_000)
    wav_path, x3a_path, back_path = tmp_path / "i.wav", tmp_path / "o.x3a", tmp_path / "b.wav"
    write_wav(wav_path, wav, 44100)
    wav_to_x3a(wav_path, x3a_path, engine="native")
    assert x3a_to_wav(x3a_path, back_path, engine="native") == 0
    got, _ = read_wav(back_path)
    np.testing.assert_array_equal(got, wav)


def test_reader_stops_at_decode_error(tmp_path, rng):
    """A frame whose payload CRC is valid but whose bitstream is invalid
    triggers the reference's count-and-stop behavior (decodefile.rs:128-135):
    decode_next_frame returns None at that frame, frame_errors increments,
    and no further frames are produced."""
    from x3_tpu.models.encoder import build_frame_headers
    from x3_tpu.models import oracle
    from x3_tpu.ops.crc import crc16

    wav = make_hydrophone(rng, 30_000)  # 3 frames
    wav_path, x3a_path = tmp_path / "i.wav", tmp_path / "o.x3a"
    write_wav(wav_path, wav, 44100)
    wav_to_x3a(wav_path, x3a_path)
    data = bytearray(x3a_path.read_bytes())
    hdr_size = archive.parse_archive_header(bytes(data))[1]
    index = list(archive.walk_frames(bytes(data), hdr_size))
    off1, h1 = index[1]
    # Invalid BFP header (ftype 0, num_bits 3) at the start of frame 1's
    # bitstream, with the payload CRC re-stamped so only decode fails.
    data[off1 + 2] = 0b00_0010_00
    new_crc = crc16(bytes(data[off1 : off1 + h1.payload_len]))
    hdr = np.asarray(
        build_frame_headers(
            np.asarray([h1.samples]), 1, np.asarray([h1.payload_len]), np.asarray([new_crc])
        )
    )[0]
    data[off1 - 20 : off1] = hdr.tobytes()
    x3a_path.write_bytes(bytes(data))

    reader = X3aReader.open(x3a_path, batch_frames=2)
    first = reader.decode_next_frame()
    np.testing.assert_array_equal(first, wav[:10_000])
    assert reader.decode_next_frame() is None  # stops at the bad frame
    assert reader.frame_errors == 1
    assert reader.decode_next_frame() is None  # stays stopped
    assert reader.frame_errors == 1


def test_cli_numpy_engine(tmp_path, rng):
    wav = make_hydrophone(rng, 2_000)
    wav_path, x3a_path, back = tmp_path / "i.wav", tmp_path / "o.x3a", tmp_path / "b.wav"
    write_wav(wav_path, wav, 44100)
    from x3_tpu.cli import main

    main(["-i", str(wav_path), "-o", str(x3a_path), "--engine", "numpy", "-q"])
    main(["-i", str(x3a_path), "-o", str(back), "--engine", "numpy", "-q"])
    got, _ = read_wav(back)
    np.testing.assert_array_equal(got, wav)


def test_stereo_wav_rejected(tmp_path):
    import wave

    from x3_tpu.errors import MoreThanOneChannel

    path = tmp_path / "stereo.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes(b"\x00" * 400)
    with pytest.raises(MoreThanOneChannel):
        wav_to_x3a(path, tmp_path / "o.x3a")


def test_8bit_wav_rejected(tmp_path):
    import wave

    from x3_tpu.errors import X3Error

    path = tmp_path / "8bit.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(44100)
        w.writeframes(b"\x00" * 100)
    with pytest.raises(X3Error):
        wav_to_x3a(path, tmp_path / "o.x3a")


# ---- X3aReader random access (beyond-reference capability) ----


def _random_access_archive(tmp_path, rng):
    spf = Parameters().samples_per_frame
    wav = make_hydrophone(rng, 3 * spf + spf // 2)  # 4 frames, partial tail
    wp, xp = tmp_path / "ra.wav", tmp_path / "ra.x3a"
    write_wav(wp, wav, 96000)
    wav_to_x3a(wp, xp, engine="numpy")
    return wav, xp, spf


@pytest.mark.parametrize("engine", ["jax", "numpy"])
def test_reader_random_access(tmp_path, rng, engine):
    wav, xp, spf = _random_access_archive(tmp_path, rng)
    with X3aReader(xp, engine=engine, batch_frames=2) as r:
        assert len(r) == 4
        assert r.n_samples == len(wav)
        np.testing.assert_array_equal(
            r.sample_offsets, [0, spf, 2 * spf, 3 * spf, len(wav)]
        )
        # out-of-order frame access
        np.testing.assert_array_equal(r.decode_frame_at(2), wav[2 * spf : 3 * spf])
        np.testing.assert_array_equal(r[0], wav[:spf])
        np.testing.assert_array_equal(r[-1], wav[3 * spf :])
        with pytest.raises(IndexError):
            r.decode_frame_at(4)
        # arbitrary sample ranges, including a frame-boundary crossing
        np.testing.assert_array_equal(
            r.read_samples(spf - 7, 20), wav[spf - 7 : spf + 13]
        )
        np.testing.assert_array_equal(r.read_samples(0, 3), wav[:3])
        # clamped past EOF; empty range
        np.testing.assert_array_equal(r.read_samples(len(wav) - 5, 999), wav[-5:])
        assert r.read_samples(len(wav) + 10, 4).size == 0
        # seek + sequential resumes from the sought frame
        r.seek_frame(3)
        assert r.tell_frame() == 3
        np.testing.assert_array_equal(r.decode_next_frame(), wav[3 * spf :])
        assert r.decode_next_frame() is None


def test_reader_random_access_isolates_damage(tmp_path, rng):
    """A payload-CRC-corrupt frame raises only for ITSELF; its batch
    neighbours still decode, and seeking past it works."""
    wav, xp, spf = _random_access_archive(tmp_path, rng)
    data = bytearray(xp.read_bytes())
    _, hdr_end = archive.parse_archive_header(bytes(data))
    idx = list(archive.walk_frames(bytes(data), hdr_end))
    po1, h1 = idx[1]
    data[po1 + 5] ^= 0x10  # corrupt frame 1's payload (CRC now mismatches)
    bad = tmp_path / "bad.x3a"
    bad.write_bytes(bytes(data))
    with X3aReader(bad, engine="jax", batch_frames=4) as r:
        np.testing.assert_array_equal(r.decode_frame_at(0), wav[:spf])
        with pytest.raises(FrameHeaderInvalidPayloadCRC):
            r.decode_frame_at(1)
        np.testing.assert_array_equal(r.decode_frame_at(2), wav[2 * spf : 3 * spf])
        # sequential read raises on the CRC-bad frame (reference parity,
        # decodefile.rs:93-103); seeking past it resumes cleanly
        r.seek_frame(1)
        with pytest.raises(FrameHeaderInvalidPayloadCRC):
            r.decode_next_frame()
        r.seek_frame(2)
        np.testing.assert_array_equal(r.decode_next_frame(), wav[2 * spf : 3 * spf])


def test_overwrite_longer_outputs_truncated(tmp_path, rng):
    """Outputs are opened without O_TRUNC (utils/io.open_overwrite saves
    tens of ms re-truncating a large existing file); the close path must
    truncate, so overwriting a LONGER previous output leaves no stale tail
    in either direction (.x3a or .wav)."""
    import os

    long_wav = make_hydrophone(rng, 6 * 1024)
    short_wav = make_hydrophone(rng, 2 * 1024)
    wp_long, wp_short = tmp_path / "long.wav", tmp_path / "short.wav"
    xp, bp = tmp_path / "out.x3a", tmp_path / "back.wav"
    write_wav(wp_long, long_wav, 44100)
    write_wav(wp_short, short_wav, 44100)

    for engine in ("numpy", "native"):
        # encode long, then overwrite with short: archive must parse cleanly
        # end-to-end and match a fresh encode byte-for-byte
        wav_to_x3a(wp_long, xp, engine=engine)
        wav_to_x3a(wp_short, xp, engine=engine)
        fresh = tmp_path / "fresh.x3a"
        wav_to_x3a(wp_short, fresh, engine=engine)
        assert xp.read_bytes() == fresh.read_bytes()

        # decode long output, then overwrite with the short conversion
        wav_to_x3a(wp_long, fresh, engine=engine)
        assert x3a_to_wav(fresh, bp, engine=engine) == 0
        assert x3a_to_wav(xp, bp, engine=engine) == 0
        back, _ = read_wav(bp)
        np.testing.assert_array_equal(back, short_wav)
        assert os.path.getsize(bp) == 44 + 2 * len(short_wav)
