"""CI corpus gate (the reference's test_wavs.sh analogue, promoted into
pytest) + structured per-block-type bitstream mutation fuzz.

One command runs the full gate: `python -m pytest tests/test_corpus_gate.py`.
Failures reproduce from the printed seed."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import REPO_ROOT
from x3_tpu.errors import X3Error
from x3_tpu.models import oracle
from x3_tpu.models.decoder import decode_frames_batch
from x3_tpu.params import Parameters

P = Parameters()


@pytest.mark.slow
def test_corpus_gate_synthetic():
    """All synthetic corpus classes, all engines, cross-engine archive
    identity — the round-trip ground truth gate."""
    r = subprocess.run(
        [sys.executable, str(REPO_ROOT / "tools" / "roundtrip_corpus.py"), "--synthetic"],
        capture_output=True,
        text=True,
        env={
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": str(REPO_ROOT),
            "PATH": "/usr/bin:/bin:/usr/local/bin",
        },
        timeout=500,
    )
    assert r.returncode == 0, f"corpus gate failed:\n{r.stdout[-4000:]}\n{r.stderr[-2000:]}"
    assert "ALL BIT-EXACT" in r.stdout


# ---------------------------------------------------------------------------
# Structured bitstream mutators: build a valid frame dominated by one block
# type, then mutate a structured field of that block type and check that all
# engines agree — identical samples when nobody errors, and errors together
# otherwise (the reference discards output on any decode error, so only the
# accept/reject agreement and accepted bytes are observable behavior).
# ---------------------------------------------------------------------------


def _frame_of_type(rng, kind: str, n_blocks: int = 6):
    """A valid payload whose blocks are all of the requested type."""
    L = P.block_len
    n = 1 + n_blocks * L
    if kind == "rice1":
        wav = np.clip(np.cumsum(rng.integers(-2, 3, n)), -3000, 3000)
    elif kind == "rice2":
        wav = np.clip(np.cumsum(rng.integers(-7, 8, n)), -3000, 3000)
    elif kind == "rice3":
        wav = np.clip(np.cumsum(rng.integers(-18, 19, n)), -3000, 3000)
    elif kind == "bfp":
        wav = np.clip(np.cumsum(rng.integers(-400, 401, n)), -20000, 20000)
    else:  # literal / pass-through
        wav = rng.integers(-32768, 32768, n)
    wav = np.asarray(wav, dtype=np.int16)
    payload, _ = oracle.encode_frame_payload(wav, P)
    return wav, payload


def _decode_all(payload: bytes, n: int):
    """(outcome, samples) per engine.  outcome is 'ok' or the error class
    name."""
    from x3_tpu import native
    from x3_tpu.errors import decode_error

    results = {}
    try:
        results["numpy"] = ("ok", oracle.decode_frame(payload, P, n))
    except X3Error as e:
        results["numpy"] = (type(e).__name__, None)
    outs, errs = decode_frames_batch([payload], [n], P)
    if errs[0]:
        results["jax"] = (type(decode_error(errs[0])).__name__, None)
    else:
        results["jax"] = ("ok", outs[0])
    if native.available():
        try:
            results["native"] = ("ok", native.decode_frame(payload, P, n))
        except X3Error as e:
            results["native"] = (type(e).__name__, None)
    return results


MUTATORS = {
    # (description, byte-level mutation of the payload)
    "flip_payload_bit": lambda rng, b: _flip_bit(rng, b, lo=2),  # inside the bitstream
    "corrupt_first_sample": lambda rng, b: _flip_bit(rng, b, lo=0, hi=2),
    "truncate_tail": lambda rng, b: b[: max(2, int(rng.integers(2, len(b))))],
    "zero_tail": lambda rng, b: b[: max(2, len(b) // 2)] + bytes(len(b) - max(2, len(b) // 2)),
    "extend_unary": lambda rng, b: _zero_run(rng, b),
}


def _flip_bit(rng, b: bytes, lo=0, hi=None):
    arr = bytearray(b)
    hi = hi if hi is not None else len(arr)
    if hi <= lo:
        return bytes(arr)
    i = int(rng.integers(lo, hi))
    arr[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(arr)


def _zero_run(rng, b: bytes):
    """Overwrite a span with zeros — inside a Rice block this manufactures
    an over-long unary run (the OOB-inverse class)."""
    arr = bytearray(b)
    if len(arr) < 8:
        return bytes(arr)
    i = int(rng.integers(2, len(arr) - 4))
    for j in range(i, min(i + 4, len(arr))):
        arr[j] = 0
    return bytes(arr)


@pytest.mark.slow
def test_differential_fuzz_campaign():
    """Cross-engine differential fuzz across parameter geometries, signal
    classes, edge lengths, and random corruption (tools/fuzz_differential)."""
    sys.path.insert(0, str(REPO_ROOT / "tools"))
    from fuzz_differential import run_campaign

    assert run_campaign(trials=21, seed=0xD1FF) == 0


@pytest.mark.slow
def test_differential_fuzz_soak():
    """Long soak of the same campaign (reproduces from the printed seed).
    X3_FUZZ_SOAK_TRIALS overrides the count (>=1000 for a full soak run;
    the CI default keeps suite time bounded while still cycling every
    geometry x signal class pair many times)."""
    sys.path.insert(0, str(REPO_ROOT / "tools"))
    from fuzz_differential import run_campaign

    trials = int(os.environ.get("X3_FUZZ_SOAK_TRIALS", "180"))
    assert run_campaign(trials=trials, seed=0x50AC) == 0


def test_header_field_mutation_fuzz(tmp_path):
    """Frame-HEADER field mutation (samples / payload_len claims, restamped
    header CRC so only the claim is wrong): the archive walk and decode must
    fail cleanly with the right error class — never crash or emit silently
    wrong output."""
    from x3_tpu import archive
    from x3_tpu.errors import (
        FrameHeaderInvalidPayloadLen,
        FrameDecodeUnexpectedEnd,
        X3Error,
    )
    from x3_tpu.files import wav_to_x3a, x3a_to_wav
    from x3_tpu.utils.wav import write_wav

    seed = 0xBEEF
    rng = np.random.default_rng(seed)
    wav = np.clip(np.cumsum(rng.integers(-5, 6, 25_000)), -30000, 30000).astype(np.int16)
    wav_path, x3a_path = tmp_path / "h.wav", tmp_path / "h.x3a"
    write_wav(wav_path, wav, 44100)
    wav_to_x3a(wav_path, x3a_path)
    clean = x3a_path.read_bytes()
    hdr_size = archive.parse_archive_header(clean)[1]
    index = list(archive.walk_frames(clean, hdr_size))

    def restamp(data, frame_idx, samples=None, payload_len=None):
        """Rewrite a header field and fix the header CRC (CRC-valid lie)."""
        from x3_tpu.ops.crc import crc16

        arr = bytearray(data)
        off, h = index[frame_idx]
        hoff = off - 20
        if samples is not None:
            arr[hoff + 4 : hoff + 6] = int(samples).to_bytes(2, "big")
        if payload_len is not None:
            arr[hoff + 6 : hoff + 8] = int(payload_len).to_bytes(2, "big")
        hc = crc16(bytes(arr[hoff : hoff + 16]))
        arr[hoff + 16 : hoff + 18] = hc.to_bytes(2, "big")
        return bytes(arr)

    # payload_len overrunning EOF -> FrameHeaderInvalidPayloadLen on walk.
    bad = restamp(clean, len(index) - 1, payload_len=0x7fd0)
    (tmp_path / "over.x3a").write_bytes(bad)
    with pytest.raises(FrameHeaderInvalidPayloadLen):
        x3a_to_wav(tmp_path / "over.x3a", tmp_path / "o.wav")

    # samples claim exceeding the frame geometry -> clean typed failure.
    bad = restamp(clean, 0, samples=0xFFFF)
    (tmp_path / "ns.x3a").write_bytes(bad)
    with pytest.raises((FrameDecodeUnexpectedEnd, X3Error)):
        # walk succeeds (payload length intact); decode must flag, and the
        # payload CRC no longer matching the altered header is also a valid
        # clean failure for engines that check CRC against the header copy.
        errs = x3a_to_wav(tmp_path / "ns.x3a", tmp_path / "n.wav")
        if errs == 0:
            raise AssertionError("oversized sample claim silently accepted")
        raise X3Error("counted")  # counted+stopped is also clean behavior

    # random header-byte corruption (CRC not restamped) -> header CRC raise
    # without resync; with resync the remaining frames are recovered.
    arr = bytearray(clean)
    off0, _ = index[1]
    arr[off0 - 20 + 9] ^= 0xFF  # timestamp field -> CRC mismatch
    (tmp_path / "hc.x3a").write_bytes(bytes(arr))
    with pytest.raises(X3Error):
        x3a_to_wav(tmp_path / "hc.x3a", tmp_path / "x.wav")
    errs = x3a_to_wav(tmp_path / "hc.x3a", tmp_path / "r.wav", resync=True)
    assert errs == 0  # frame 1's header is bad but sync-scan recovers frames


@pytest.mark.parametrize("kind", ["rice1", "rice2", "rice3", "bfp", "literal"])
def test_structured_mutation_fuzz(kind):
    """Per-block-type structured mutation: engines agree on accept/reject
    and on the samples whenever they accept."""
    # Fixed per-kind seeds (hash() is salted per process — not reproducible).
    seed = 0xF0F0 + {"rice1": 1, "rice2": 2, "rice3": 3, "bfp": 4, "literal": 5}[kind]
    rng = np.random.default_rng(seed)
    wav, payload = _frame_of_type(rng, kind)
    n = len(wav)

    # Sanity: the unmutated frame roundtrips identically everywhere.
    base = _decode_all(payload, n)
    for eng, (outcome, got) in base.items():
        assert outcome == "ok", f"{kind}/{eng} clean decode failed ({outcome}) seed={seed}"
        np.testing.assert_array_equal(got, wav, err_msg=f"{kind}/{eng} seed={seed}")

    for mname, mut in MUTATORS.items():
        for trial in range(6):
            mutant = mut(rng, payload)
            results = _decode_all(mutant, n)
            ok_engines = {e for e, (o, _) in results.items() if o == "ok"}
            err_engines = {e: o for e, (o, _) in results.items() if o != "ok"}
            ctx = f"kind={kind} mutator={mname} trial={trial} seed={seed}"
            # All engines must agree on accept vs reject.
            assert not ok_engines or not err_engines, (
                f"accept/reject divergence ({ctx}): ok={ok_engines} err={err_engines}"
            )
            if ok_engines:
                sample_sets = [results[e][1] for e in sorted(ok_engines)]
                for s in sample_sets[1:]:
                    np.testing.assert_array_equal(sample_sets[0], s, err_msg=ctx)
            else:
                # Same error class across engines (kernel codes map to the
                # reference error classes).
                classes = set(err_engines.values())
                assert len(classes) == 1, f"error-class divergence ({ctx}): {err_engines}"
