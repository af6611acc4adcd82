"""Multi-channel container convention: N mono archives + a sidecar manifest.

The X3 wire format is strictly mono (the reference rejects >1 channel,
error.rs MoreThanOneChannel / encoder.rs:55-57), so a multi-channel capture
becomes one `.x3a` archive per channel plus a tiny `.x3m` JSON manifest that
names them — a convention this framework adds on top of the format (the
archives remain plain, individually decodable X3 files).

All channels' frames share device batches during encode (multifile), which
is exactly the batched multi-file shape the device pipeline likes.
"""

from __future__ import annotations

import json
import wave
from pathlib import Path

import numpy as np

from .errors import X3Error
from .params import Parameters

MANIFEST_VERSION = 1


def encode_multichannel(
    samples_2d,
    sample_rate: int,
    base_path,
    params: Parameters | None = None,
    mesh=None,
):
    """Encode a [C, n] capture to base.ch<k>.x3a files + base.x3m manifest.

    Returns the manifest path."""
    from . import archive
    from .multifile import encode_streams

    samples_2d = np.atleast_2d(np.asarray(samples_2d, dtype=np.int16))
    base = Path(base_path)
    if base.suffix == ".x3m":
        base = base.with_suffix("")
    params = params or Parameters()
    results = encode_streams(list(samples_2d), params, mesh=mesh)
    files = []
    for k, res in enumerate(results):
        p = base.with_suffix(f".ch{k}.x3a")
        with open(p, "wb") as f:
            f.write(archive.build_archive_header(sample_rate, params))
            f.write(res.data)
        files.append(p.name)
    manifest = {
        "format": "x3m",
        "version": MANIFEST_VERSION,
        "channels": len(files),
        "sample_rate": sample_rate,
        "samples": int(samples_2d.shape[1]),
        "files": files,  # relative to the manifest's directory
    }
    mpath = base.with_suffix(".x3m")
    mpath.write_text(json.dumps(manifest, indent=1))
    return mpath


def decode_multichannel(manifest_path, engine: str = "auto", batch_frames: int | None = None):
    """Decode a .x3m manifest back to ([C, n] int16 samples, sample_rate).

    Channels stream through files.X3aReader (header-index + per-batch seek
    reads), so beyond the output array only one decode batch is resident —
    the compressed archives are never held in memory, and the engine choice
    is honored per channel."""
    from .files import X3aReader

    manifest, mpath = _load_manifest(manifest_path)
    rate = manifest["sample_rate"]
    chans = []
    for name in manifest["files"]:
        with X3aReader(mpath.parent / name, engine=engine, batch_frames=batch_frames) as r:
            if r.spec.sample_rate != rate:
                raise X3Error("manifest/archive sample rate mismatch")
            chans.append(r.read_samples(0, r.n_samples))
    n = manifest.get("samples")
    out = np.stack(chans)
    if n is not None and out.shape[1] != n:
        raise X3Error(f"decoded {out.shape[1]} samples, manifest says {n}")
    return out, rate


def read_wav_multichannel(path):
    """Read a WAV of any channel count; returns ([C, n] int16, rate)."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise X3Error(f"only 16-bit WAV supported, got {8 * w.getsampwidth()}-bit")
        c = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    flat = np.frombuffer(raw, dtype="<i2").astype(np.int16)
    return flat.reshape(-1, c).T.copy(), rate


def write_wav_multichannel(path, samples_2d, sample_rate: int) -> None:
    """Write [C, n] int16 samples as an interleaved multi-channel WAV."""
    samples_2d = np.atleast_2d(np.asarray(samples_2d, dtype="<i2"))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples_2d.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.ascontiguousarray(samples_2d.T).tobytes())


def wav_to_x3m(wav_path, base_path, params: Parameters | None = None, mesh=None):
    """Multi-channel WAV -> per-channel archives + manifest."""
    chans, rate = read_wav_multichannel(wav_path)
    return encode_multichannel(chans, rate, base_path, params, mesh)


def x3m_to_wav(manifest_path, wav_path, engine: str = "auto", batch_frames: int | None = None) -> int:
    """Manifest -> multi-channel WAV.  Returns the channel count.

    Streaming: each channel reads through files.X3aReader and the WAV is
    written in frame-aligned sample windows, so peak RSS is O(channels x
    batch) regardless of capture length — the bounded-memory invariant the
    mono decode paths honor (decodefile.rs:44-45 parity;
    tests/test_bounded_memory.py)."""
    from .engine import resolve_engine
    from .files import X3aReader, resolve_batch_frames

    manifest, mpath = _load_manifest(manifest_path)
    rate = manifest["sample_rate"]
    readers = [
        X3aReader(mpath.parent / name, engine=engine, batch_frames=batch_frames)
        for name in manifest["files"]
    ]
    try:
        for r in readers:
            if r.spec.sample_rate != rate:
                raise X3Error("manifest/archive sample rate mismatch")
        total = readers[0].n_samples
        for r in readers[1:]:
            if r.n_samples != total:
                raise X3Error("channel archives disagree on sample count")
        want = manifest.get("samples")
        if want is not None and total != want:
            raise X3Error(f"decoded {total} samples, manifest says {want}")
        # One decode batch of whole frames per window: read_samples never
        # splits a cached batch, so each payload is decoded exactly once.
        bf = resolve_batch_frames(batch_frames, resolve_engine(engine), decode=True)
        win = max(1, bf) * readers[0].spec.params.samples_per_frame
        with wave.open(str(wav_path), "wb") as w:
            w.setnchannels(len(readers))
            w.setsampwidth(2)
            w.setframerate(rate)
            for start in range(0, total, win):
                n = min(win, total - start)
                block = np.stack([r.read_samples(start, n) for r in readers])
                w.writeframes(np.ascontiguousarray(block.T.astype("<i2")).tobytes())
        return len(readers)
    finally:
        for r in readers:
            r.close()


def _load_manifest(manifest_path) -> tuple[dict, Path]:
    """Parse + validate an .x3m manifest (format marker and version gate —
    shared by every manifest consumer so a future-version manifest is never
    inspected or verified under wrong semantics)."""
    mpath = Path(manifest_path)
    manifest = json.loads(mpath.read_text())
    if manifest.get("format") != "x3m":
        raise X3Error(f"not an x3m manifest: {manifest_path}")
    if manifest.get("version", 0) > MANIFEST_VERSION:
        raise X3Error(f"unsupported x3m version {manifest['version']}")
    return manifest, mpath


def x3m_info(manifest_path) -> dict:
    """Manifest metadata + per-channel x3a_info (header-index only)."""
    from .files import x3a_info

    manifest, mpath = _load_manifest(manifest_path)
    per_channel = [x3a_info(mpath.parent / name) for name in manifest["files"]]
    total = sum(i["archive_bytes"] for i in per_channel)
    pcm = sum(i["pcm_bytes"] for i in per_channel)
    return {
        "channels": manifest["channels"],
        "sample_rate": manifest["sample_rate"],
        "samples_per_channel": manifest.get("samples"),
        "archive_bytes": total,
        "pcm_bytes": pcm,
        "compression_ratio": round(pcm / total, 3) if total else 0.0,
        "files": list(manifest["files"]),
        "per_channel": per_channel,
    }


def verify_x3m(manifest_path, engine: str = "auto", verbose: bool = False) -> dict:
    """Integrity-check every channel archive of a manifest (verify_x3a per
    channel, plus manifest consistency: channel count and sample counts).
    Failures carry a ``reason`` (printed when verbose) so a FAILED verdict
    with zero frame errors is never silent; ``engine`` reports the engine
    actually used (the per-channel resolution, not the 'auto' alias)."""
    from .engine import resolve_engine
    from .files import verify_x3a

    manifest, mpath = _load_manifest(manifest_path)
    reports = []
    ok = True
    reason = None
    if len(manifest["files"]) != manifest["channels"]:
        ok = False
        reason = (
            f"manifest lists {len(manifest['files'])} files "
            f"but says channels={manifest['channels']}"
        )
        if verbose:
            print(reason)
    want = manifest.get("samples")
    for name in manifest["files"]:
        rep = verify_x3a(mpath.parent / name, engine=engine, verbose=verbose)
        rep["file"] = name
        if want is not None and rep["n_samples_ok"] != want:
            rep["ok"] = False
            rep.setdefault("reason", f"sample count {rep['n_samples_ok']} != manifest {want}")
            if verbose:
                print(f"{name}: {rep['reason']}")
        ok = ok and rep["ok"]
        reports.append(rep)
    out = {
        "ok": ok,
        "channels": len(reports),
        "engine": reports[0]["engine"] if reports else resolve_engine(engine),
        "frame_errors": sum(r["frame_errors"] for r in reports),
        "skipped_bytes": sum(r["skipped_bytes"] for r in reports),
        "per_channel": reports,
    }
    if reason is None:
        # Surface the first failed channel's reason (if any) at the top level.
        reason = next((r.get("reason") for r in reports if not r["ok"] and r.get("reason")), None)
    if reason is not None:
        out["reason"] = reason
    return out
