"""File-level API: wav_to_x3a / x3a_to_wav / X3aReader.

Parity surface with the reference's encodefile.rs / decodefile.rs, built on
the batched device pipelines: a whole file's frames are encoded or decoded in
a few large device calls instead of one frame at a time.

Memory is bounded in BOTH directions (the reference streams with a 24 KiB
read buffer and ~163 MB peak RSS on any archive size, decodefile.rs:44-45):
encode reads the WAV in batch-size chunks; decode walks frame headers with
seeks, reads payloads a batch at a time, and appends to the WAV
incrementally.  Peak RSS is O(batch_frames), independent of file size.

Behavior parity notes (decodefile.rs:105-136):
* header or payload CRC mismatches raise (they propagate in the reference);
* frame *decode* errors are counted and decoding stops at the first bad
  frame, like the reference's swallowed Ok(None);
* with resync=True (our extension, enabled by the format's self-contained
  frames), corrupt frames are skipped via the sync scanner instead.

engine="auto" (default) routes file conversion to the fastest engine for a
host-I/O workload — see engine.resolve_engine.
"""

from __future__ import annotations

import wave

import numpy as np

from . import archive
from .engine import resolve_engine
from .errors import (
    FrameHeaderInvalidPayloadCRC,
    FrameHeaderInvalidPayloadLen,
    MoreThanOneChannel,
    X3Error,
)
from .models.decoder import decode_frames_batch
from .models.encoder import EncodeResult
from .models import oracle
from .params import Parameters, X3aSpec
from .utils.io import prefetch_iter
from .utils.wav import WavWriter

DEFAULT_BATCH_FRAMES = 256
# Batch sizes for the jax engine: wide enough to fill the device, small
# enough to keep the file paths' memory bounded (~41 MB of decoded samples
# per decode batch).  On an NVIDIA H100 80GB HBM3 at 700 W
# (tools/geometry_ab.py), encode ran at the same rate at F=768 and F=1536
# (0.612 and 1.218 ms); decode took 12.4 ms at F=2048 and 10.4 ms at
# F=6144, so wider decode batches are nearly free on the device, but they
# pad to a power of two in decode_frames_batch and multiply host memory.
JAX_ENCODE_BATCH_FRAMES = 768
JAX_DECODE_BATCH_FRAMES = 2048


def resolve_batch_frames(batch_frames: int | None, engine: str, decode: bool) -> int:
    """Engine-shaped default batch size (None = pick for the engine)."""
    if batch_frames is not None:
        return batch_frames
    if engine == "jax":
        return JAX_DECODE_BATCH_FRAMES if decode else JAX_ENCODE_BATCH_FRAMES
    return DEFAULT_BATCH_FRAMES


def wav_to_x3a(
    wav_filename,
    x3a_filename,
    params: Parameters | None = None,
    engine: str = "auto",
    verbose: bool = False,
    batch_frames: int | None = None,
) -> EncodeResult:
    """Convert a mono 16-bit .wav file to an .x3a archive
    (parity: encodefile.rs:48-77).  Bounded memory: the WAV is read and
    encoded in batch_frames-frame chunks (the IterChannel analogue,
    encoder.rs:67-74)."""
    from .streaming import StreamEncoder

    engine = resolve_engine(engine, decode=False)
    batch_frames = resolve_batch_frames(batch_frames, engine, decode=False)
    params = params or Parameters()
    with wave.open(str(wav_filename), "rb") as w:
        if w.getsampwidth() != 2:
            raise X3Error(f"only 16-bit WAV supported, got {8 * w.getsampwidth()}-bit")
        if w.getnchannels() != 1:
            raise MoreThanOneChannel(f"only mono WAV supported, got {w.getnchannels()} channels")
        rate = w.getframerate()
        with StreamEncoder(x3a_filename, rate, params, engine, batch_frames) as enc:
            chunk_samples = batch_frames * params.samples_per_frame

            def _chunks():
                while True:
                    raw = w.readframes(chunk_samples)
                    if not raw:
                        return
                    yield raw

            # Read-ahead thread: the NEXT chunk's WAV read overlaps the
            # current chunk's encode (the output side already overlaps via
            # StreamEncoder's AsyncWriter).  Memory stays bounded: depth
            # chunks of batch_frames frames each.
            for raw in prefetch_iter(_chunks(), depth=1):
                enc.write(np.frombuffer(raw, dtype="<i2"))
            result = enc.close()
    if verbose:
        print(result.format_stats())
    return result


def _decode_payload_batch(payloads, headers, params: Parameters, engine: str, resync: bool):
    """Decode one batch of frame payloads with CRC verification.

    Returns (outs list, errs array).  Without resync a payload-CRC mismatch
    raises (decodefile.rs:93-103); with resync CRC-failed frames are marked
    as errors so the caller skips and counts them."""
    ns = [h.samples for h in headers]
    want_crcs = [h.payload_crc for h in headers]

    if engine == "native":
        from . import native as native_mod

        if not native_mod.available():
            raise X3Error("native engine requested but the toolchain is unavailable")

    if engine == "jax":
        # CRC verified on device, fused into the decode batch.
        outs, errs, crc_ok = decode_frames_batch(payloads, ns, params, check_crcs=want_crcs)
        if not crc_ok.all():
            if not resync:
                bad = int(np.nonzero(~crc_ok)[0][0])
                raise FrameHeaderInvalidPayloadCRC(f"frame {bad} payload CRC mismatch")
            errs = np.where(~crc_ok, 4, errs)  # 4 = payload CRC
        return outs, errs

    def _native_fused(expected_crcs):
        from . import native as native_mod

        blob = b"".join(payloads)
        idx, pos = [], 0
        for p, h in zip(payloads, headers):
            idx.append((pos, h.samples, len(p)))
            pos += len(p)
        flat = native_mod.decode_frames_mt(blob, idx, params, expected_crcs=expected_crcs)
        outs, pos = [], 0
        for h in headers:
            outs.append(flat[pos : pos + h.samples])
            pos += h.samples
        return outs, np.zeros(len(payloads), bool)

    if engine == "native" and not resync:
        # Fast path: one threaded native pass fuses the payload CRC check
        # (raises on mismatch, decodefile.rs:93-103) with the decode.
        try:
            return _native_fused(want_crcs)
        except FrameHeaderInvalidPayloadCRC:
            raise
        except X3Error:
            pass  # decode error: fall through for per-frame accounting

    crc_ok = archive.verify_payload_crcs_parts(payloads, want_crcs)
    if not resync and not crc_ok.all():
        bad = int(np.nonzero(~crc_ok)[0][0])
        raise FrameHeaderInvalidPayloadCRC(f"frame {bad} payload CRC mismatch")

    if engine == "native":
        from . import native as native_mod

        # Resync fast path — only when every payload CRC checked out, so
        # CRC-failed frames are never silently included.
        if resync and crc_ok.all():
            try:
                return _native_fused(None)
            except X3Error:
                pass  # fall through to per-frame decode for error accounting
        dec = lambda p, n: native_mod.decode_frame(p, params, n)
    else:
        dec = lambda p, n: oracle.decode_frame(p, params, n)

    outs, errs = [], []
    for p, n in zip(payloads, ns):
        try:
            outs.append(dec(p, n))
            errs.append(False)
        except X3Error:
            outs.append(np.zeros(0, np.int16))
            errs.append(True)
    errs = np.asarray(errs)
    if resync:
        errs = errs | ~crc_ok
    return outs, errs


# Sequential read size for the chunked native decode path: large enough to
# amortize the per-call ctypes/thread cost over ~600 frames, small enough to
# keep peak RSS flat (bounded-memory invariant) on any archive size.
_NATIVE_CHUNK_BYTES = 4 << 20


def _x3a_to_wav_native_stream(f, wout, start: int, params: Parameters) -> int:
    """Chunked native decode: sequential reads, native header walk
    (x3_index_frames validates header CRCs at clmul speed), and one threaded
    native decode per chunk with the payload-CRC check fused — no per-frame
    Python.  Accept/reject parity with the walk_frames_file path: chunk
    tails that the native walk stops at are re-parsed with
    archive.read_frame_header, which raises the walker's exact error class
    (header CRC/key/length/channels), and a payload overrunning the file
    end raises FrameHeaderInvalidPayloadLen with the walker's message."""
    from . import native as native_mod

    f.seek(0, 2)
    n = f.tell()

    def _reads():
        # Sequential chunk reads on a read-ahead thread (prefetch_iter):
        # the next 4 MB read overlaps the current chunk's native decode.
        # Only this generator touches `f` once the loop below starts.
        p = start
        while p < n:
            f.seek(p)
            chunk = f.read(_NATIVE_CHUNK_BYTES)
            if not chunk:
                return
            p += len(chunk)
            yield chunk

    reads = prefetch_iter(_reads(), depth=1)
    pos = start
    carry = b""
    base = 0  # global frame number of the first frame in the current blob
    while True:
        chunk = next(reads, None)
        if chunk is not None:
            pos += len(chunk)
            eof = pos >= n
            blob = carry + chunk if carry else chunk
        else:
            eof = True
            blob = carry
        if not blob:
            return 0
        idx = native_mod.index_frames(blob, 0)
        consumed = (idx[-1][0] + idx[-1][2]) if idx else 0
        if idx:
            crcs = [int.from_bytes(blob[o - 2 : o], "big") for o, _, _ in idx]
            try:
                flat = native_mod.decode_frames_mt(blob, idx, params, expected_crcs=crcs)
            except FrameHeaderInvalidPayloadCRC:
                payloads = [blob[o : o + l] for o, _, l in idx]
                bad = int(np.nonzero(~archive.verify_payload_crcs_parts(payloads, crcs))[0][0])
                raise FrameHeaderInvalidPayloadCRC(f"frame {base + bad} payload CRC mismatch")
            except X3Error:
                # A frame failed to decode: per-frame fallback for the
                # reference's stop-at-first-bad accounting (decodefile.rs
                # swallowed Ok(None) — see x3a_to_wav's generic path).
                for i, (o, s, l) in enumerate(idx):
                    try:
                        wout.write(native_mod.decode_frame(blob[o : o + l], params, s))
                    except X3Error:
                        print(f"Frame error: frame {base + i} failed to decode")
                        return 1
                raise  # mt failed but every frame decodes alone: real bug
            wout.write(flat)
            base += len(idx)
        carry = blob[consumed:]
        if eof:
            # Walker parity at the stream tail (walk_frames_file): <= 20
            # trailing bytes end the walk silently; anything longer is a
            # frame the native walk rejected — re-parse for the exact error.
            if len(carry) <= 20:
                return 0
            header = archive.read_frame_header(carry[:20])  # raises key/CRC/len/channels
            at = n - len(carry)
            raise FrameHeaderInvalidPayloadLen(
                f"frame at {at}: payload {header.payload_len} B overruns "
                f"the remaining {len(carry) - 20} B"
            )
        if not idx and len(carry) > 20 + 0x7FE0:
            # No frame can span this much carry (payloads cap at 0x7fe0,
            # x3.rs:145): the leading header is genuinely bad — re-parse to
            # raise the walker's error class rather than buffering to EOF.
            archive.read_frame_header(carry[:20])
            raise FrameHeaderInvalidPayloadLen(  # pragma: no cover - defensive
                f"frame at {n - len(carry)}: unindexable valid header"
            )


def _read_payloads(f, batch):
    out = []
    for off, h in batch:
        f.seek(off)
        out.append(f.read(h.payload_len))
    return out


def x3a_to_wav(
    x3a_filename,
    wav_filename,
    engine: str = "auto",
    verbose: bool = False,
    resync: bool = False,
    batch_frames: int | None = None,
) -> int:
    """Convert an .x3a archive back to a .wav file
    (parity: decodefile.rs:189-212).  Returns the number of frame errors.

    Streaming: frames are indexed with header-only seeks and decoded a batch
    at a time into an incrementally-written WAV, so peak memory is bounded by
    batch_frames regardless of archive size (decodefile.rs:44-45)."""
    engine = resolve_engine(engine, decode=True)
    batch_frames = resolve_batch_frames(batch_frames, engine, decode=True)
    frame_errors = 0
    with open(x3a_filename, "rb") as f:
        spec, header_size = archive.read_archive_header_file(f)
        if verbose:
            print(f"sample rate: {spec.sample_rate}")
            print(f"block length: {spec.params.block_len}")
            codes = spec.params.codes
            print(f"Rice codes: RICE{codes[0]},RICE{codes[1]},RICE{codes[2]},BFP")
            t = spec.params.thresholds
            print(f"thresholds: {t[0]},{t[1]},{t[2]}")

        if engine == "native" and not resync:
            from . import native as native_mod

            if native_mod.available():
                with WavWriter(wav_filename, spec.sample_rate) as wout:
                    return _x3a_to_wav_native_stream(f, wout, header_size, spec.params)

        with WavWriter(wav_filename, spec.sample_rate) as wout:
            walker = archive.walk_frames_file(f, header_size, resync=resync)
            base = 0
            stop = False
            while not stop:
                batch = []
                for entry in walker:
                    batch.append(entry)
                    if len(batch) >= batch_frames:
                        break
                if not batch:
                    break
                payloads = _read_payloads(f, batch)
                outs, errs = _decode_payload_batch(
                    payloads, [h for _, h in batch], spec.params, engine, resync
                )
                if not np.any(errs):
                    # Common case: one bulk write per batch (per-frame
                    # writes cost a Python call + small I/O per 20 KB).
                    wout.write(np.concatenate(outs) if len(outs) > 1 else outs[0])
                else:
                    for i, (out, err) in enumerate(zip(outs, errs)):
                        if err:
                            frame_errors += 1
                            print(f"Frame error: frame {base + i} failed to decode")
                            if not resync:
                                stop = True  # reference stops at the first bad frame
                                break
                            continue
                        wout.write(out)
                base += len(batch)
    return frame_errors


def x3a_info(x3a_filename) -> dict:
    """Archive metadata and frame statistics from the header index alone —
    no payload byte is read or decoded (our extension, enabled by the
    seek-based header walk; the same index X3aReader holds).  The walk uses
    the resync scanner so damaged archives can still be inspected (the
    statistics then cover the walkable frames; run verify_x3a for a full
    integrity report)."""
    from . import constants

    with open(x3a_filename, "rb") as f:
        spec, header_size = archive.read_archive_header_file(f)
        index = list(archive.walk_frames_file(f, header_size, resync=True))
        f.seek(0, 2)
        size = f.tell()
    n_samples = int(sum(h.samples for _, h in index))
    payload_bytes = int(sum(h.payload_len for _, h in index))
    pcm_bytes = 2 * n_samples
    return {
        "sample_rate": spec.sample_rate,
        "block_len": spec.params.block_len,
        "codes": list(spec.params.codes),
        "thresholds": list(spec.params.thresholds),
        "n_frames": len(index),
        "n_samples": n_samples,
        "duration_s": round(n_samples / spec.sample_rate, 3) if spec.sample_rate else None,
        "archive_bytes": size,
        "archive_header_bytes": header_size,
        "frame_header_bytes": len(index) * constants.FRAME_HEADER_LENGTH,
        "payload_bytes": payload_bytes,
        "pcm_bytes": pcm_bytes,
        "compression_ratio": round(pcm_bytes / size, 3) if size else 0.0,
    }


def verify_x3a(
    x3a_filename,
    engine: str = "auto",
    batch_frames: int | None = None,
    verbose: bool = False,
) -> dict:
    """Integrity-check an archive without producing output (the `flac -t`
    analogue; our extension).  Every frame is walked with the resync
    scanner — so damage PAST the first bad frame is still found, unlike the
    reference's stop-at-first-error decode — every payload CRC is verified,
    and every frame is decoded through the selected engine.

    Returns a report dict; report["ok"] is True iff the archive is clean:
    zero frame errors and every byte between the archive header and EOF
    accounted for by a valid frame (bytes the sync scanner skipped, or an
    unwalkable tail, count as skipped_bytes)."""
    from . import constants

    engine = resolve_engine(engine, decode=True)
    batch_frames = resolve_batch_frames(batch_frames, engine, decode=True)
    n_frames = 0
    n_samples_ok = 0
    frame_errors = 0
    skipped = 0
    with open(x3a_filename, "rb") as f:
        try:
            spec, header_size = archive.read_archive_header_file(f)
        except X3Error as e:
            # A damaged ARCHIVE header still yields a clean FAILED report —
            # inspecting damaged files is the tool's purpose (a raise here
            # would turn `--verify` into a traceback).
            return {
                "ok": False,
                "n_frames": 0,
                "n_samples_ok": 0,
                "frame_errors": 0,
                "skipped_bytes": 0,
                "engine": engine,
                "reason": f"archive header invalid: {e}",
            }
        f.seek(0, 2)
        size = f.tell()
        walker = archive.walk_frames_file(f, header_size, resync=True)
        expect = header_size  # where the next frame header should start
        while True:
            batch = []
            for entry in walker:
                batch.append(entry)
                if len(batch) >= batch_frames:
                    break
            if not batch:
                break
            for off, h in batch:
                hstart = off - constants.FRAME_HEADER_LENGTH
                if hstart != expect:
                    skipped += hstart - expect
                    if verbose:
                        print(f"skipped {hstart - expect} bytes at {expect} (sync rescue)")
                expect = off + h.payload_len
            payloads = _read_payloads(f, batch)
            outs, errs = _decode_payload_batch(
                payloads, [h for _, h in batch], spec.params, engine, resync=True
            )
            for i, ((_, h), err) in enumerate(zip(batch, errs)):
                if err:
                    frame_errors += 1
                    if verbose:
                        print(f"Frame error: frame {n_frames + i} failed to decode")
                else:
                    n_samples_ok += h.samples
            n_frames += len(batch)
        if size - expect > 0:
            skipped += size - expect  # trailing bytes no valid frame covers
            if verbose:
                print(f"skipped {size - expect} trailing bytes at {expect}")
    return {
        "ok": frame_errors == 0 and skipped == 0,
        "n_frames": n_frames,
        "n_samples_ok": int(n_samples_ok),
        "frame_errors": frame_errors,
        "skipped_bytes": int(skipped),
        "engine": engine,
    }


class X3aReader:
    """Streaming frame-by-frame reader (parity: decodefile.rs:47-137).

    Holds only the header index (20 B/frame) and the current decoded batch
    in memory; payloads are read with seeks per batch."""

    def __init__(self, filename, engine: str = "auto", batch_frames: int | None = None):
        self._f = open(filename, "rb")
        self._spec, header_size = archive.read_archive_header_file(self._f)
        self._index = list(archive.walk_frames_file(self._f, header_size))
        self._cursor = 0
        self._engine = resolve_engine(engine, decode=True)
        self._batch_frames = resolve_batch_frames(batch_frames, self._engine, decode=True)
        self._cache: dict[int, np.ndarray | None] = {}
        self.frame_errors = 0
        self._stopped = False

    @classmethod
    def open(cls, filename, **kw) -> "X3aReader":
        return cls(filename, **kw)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def spec(self) -> X3aSpec:
        return self._spec

    def __len__(self) -> int:
        return len(self._index)

    def _decode_batch(self, base: int):
        batch = self._index[base : base + self._batch_frames]
        payloads = _read_payloads(self._f, batch)
        # Payload CRC mismatches raise like the reference
        # (decodefile.rs:93-103); decode errors become None entries.
        outs, errs = _decode_payload_batch(
            payloads, [h for _, h in batch], self._spec.params, self._engine, resync=False
        )
        self._cache = {}  # keep only the current batch resident
        for i, (out, err) in enumerate(zip(outs, errs)):
            self._cache[base + i] = None if err else out

    def decode_next_frame(self) -> np.ndarray | None:
        """Next frame's samples, or None at EOF / after the first bad frame
        (reference behavior: decodefile.rs:128-135)."""
        if self._stopped or self._cursor >= len(self._index):
            return None
        i = self._cursor
        if i not in self._cache:
            base = (i // self._batch_frames) * self._batch_frames
            self._decode_batch(base)
        # Keep the entry resident (the cache is replaced wholesale at the
        # next batch, so memory stays O(batch_frames)): popping here made
        # decode_next_frame/decode_frame_at interleavings re-decode the
        # whole batch per frame.
        out = self._cache[i]
        if out is None:
            self.frame_errors += 1
            print(f"Frame error: frame {i} failed to decode")
            self._stopped = True
            return None
        self._cursor += 1
        return out

    # ---- random access (beyond the reference: enabled by the format's
    # self-contained frames + the header index the reader already holds) ----

    def tell_frame(self) -> int:
        """Index of the frame the next decode_next_frame() returns."""
        return self._cursor

    def seek_frame(self, i: int) -> None:
        """Position the sequential cursor at frame i (clears the
        stop-at-first-bad-frame latch: seeking past damage is the point
        of random access)."""
        if not 0 <= i <= len(self._index):
            raise IndexError(f"frame {i} out of range 0..{len(self._index)}")
        self._cursor = i
        self._stopped = False

    @property
    def sample_offsets(self) -> np.ndarray:
        """int64 [n_frames + 1] cumulative sample offsets (from the header
        index only — no payload decode)."""
        if not hasattr(self, "_offsets"):
            counts = np.asarray([h.samples for _, h in self._index], dtype=np.int64)
            self._offsets = np.concatenate([[0], np.cumsum(counts)])
        return self._offsets

    @property
    def n_samples(self) -> int:
        """Total samples in the archive (header index only)."""
        return int(self.sample_offsets[-1])

    def decode_frame_at(self, i: int) -> np.ndarray:
        """Decode frame i directly (batched around it for device
        efficiency).  Raises the frame's X3Error on damage; other frames'
        damage in the same batch does not leak (single-frame fallback)."""
        if not 0 <= i < len(self._index):
            raise IndexError(f"frame {i} out of range 0..{len(self._index) - 1}")
        if i not in self._cache or self._cache[i] is None:
            base = (i // self._batch_frames) * self._batch_frames
            try:
                self._decode_batch(base)
            except X3Error:
                # another frame in the batch may have raised (e.g. its
                # payload CRC): decode just frame i.  The batch raised
                # before it could reset the cache, so drop entries from the
                # previous batch first — otherwise a sweep over an archive
                # with one bad frame per batch accretes one entry per good
                # frame, breaking the bounded-memory invariant
                # (tests/test_bounded_memory.py).
                self._cache = {}
                self._decode_single(i)
        out = self._cache.get(i)
        if out is None:
            self._decode_single(i)  # raises the frame's own error
            out = self._cache[i]
        return out

    def _decode_single(self, i: int) -> None:
        """Decode exactly frame i, raising its own error class (payload CRC
        checked first, then the engine's decode error classes)."""
        from .errors import decode_error

        (payload,) = _read_payloads(self._f, self._index[i : i + 1])
        h = self._index[i][1]
        if not archive.verify_payload_crcs_parts([payload], [h.payload_crc])[0]:
            raise FrameHeaderInvalidPayloadCRC(f"frame {i} payload CRC mismatch")
        params = self._spec.params
        if self._engine == "jax":
            outs, errs = decode_frames_batch([payload], [h.samples], params)
            if errs[0]:
                raise decode_error(int(errs[0]), f"frame {i} failed to decode")
            out = outs[0]
        elif self._engine == "native":
            from . import native as native_mod

            out = native_mod.decode_frame(payload, params, h.samples)
        else:
            out = oracle.decode_frame(payload, params, h.samples)
        self._cache[i] = out

    def __getitem__(self, i: int) -> np.ndarray:
        if i < 0:
            i += len(self._index)
        return self.decode_frame_at(i)

    def read_samples(self, start: int, count: int) -> np.ndarray:
        """Decode an arbitrary [start, start+count) sample range, touching
        only the frames that cover it."""
        off = self.sample_offsets
        total = int(off[-1])
        start = max(0, min(start, total))
        stop = max(start, min(start + count, total))
        if start == stop:
            return np.zeros(0, np.int16)
        f0 = int(np.searchsorted(off, start, side="right")) - 1
        f1 = int(np.searchsorted(off, stop, side="left"))  # exclusive
        parts = [self.decode_frame_at(i) for i in range(f0, f1)]
        chunk = np.concatenate(parts)
        base = int(off[f0])
        return chunk[start - base : stop - base]
