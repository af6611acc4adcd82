"""Public encode API: the batched device pipeline with host frame assembly.

Mirrors the reference's `encoder::encode` surface (encoder.rs:51-111): takes
a mono int16 sample stream, emits the concatenated frame stream (headers +
payloads, no archive header), and accumulates code-usage statistics.  Frames
are batched onto the device in large groups so launch overhead amortizes
(SURVEY.md §7 "host/device boundary hygiene")."""

from __future__ import annotations

import numpy as np

from .. import constants
from ..errors import MoreThanOneChannel
from ..ops.crc import crc16_many
from ..params import Parameters
from . import oracle

DEFAULT_BATCH_FRAMES = 256


def build_frame_headers(n_samples: np.ndarray, source_id: int, payload_lens: np.ndarray, payload_crcs: np.ndarray) -> np.ndarray:
    """Vectorized 20-byte frame headers for many frames at once
    (reference: write_frame_header, encoder.rs:122-162, including the
    channels-byte quirk)."""
    f = len(n_samples)
    h = np.zeros((f, constants.FRAME_HEADER_LENGTH), dtype=np.uint8)
    h[:, 0] = 0x78
    h[:, 1] = 0x33
    h[:, constants.P_SOURCE_ID] = source_id
    h[:, constants.P_CHANNELS] = source_id
    h[:, constants.P_SAMPLES] = (n_samples >> 8) & 0xFF
    h[:, constants.P_SAMPLES + 1] = n_samples & 0xFF
    h[:, constants.P_PAYLOAD_SIZE] = (payload_lens >> 8) & 0xFF
    h[:, constants.P_PAYLOAD_SIZE + 1] = payload_lens & 0xFF
    hcrc = crc16_many(h[:, : constants.P_HEADER_CRC], np.full(f, constants.P_HEADER_CRC))
    h[:, constants.P_HEADER_CRC] = (hcrc >> 8) & 0xFF
    h[:, constants.P_HEADER_CRC + 1] = hcrc & 0xFF
    h[:, constants.P_PAYLOAD_CRC] = (payload_crcs >> 8) & 0xFF
    h[:, constants.P_PAYLOAD_CRC + 1] = payload_crcs & 0xFF
    return h


class EncodeResult:
    """Encoded stream plus statistics (structured replacement for the
    reference's stdout statistics, encoder.rs:96-108).

    Streaming APIs write frames to a file as they go; they return data=b""
    and set nbytes to the total frame-stream size written."""

    def __init__(self, data: bytes, stats: np.ndarray, nbytes: int | None = None):
        self.data = data
        self.stats = stats  # int64 [6]
        self.nbytes = len(data) if nbytes is None else nbytes
        self.width_used: int | None = None  # jax engine: final adaptive rung
        self.block_width_used: int | None = None  # final block-buffer rung

    def format_stats(self) -> str:
        t = max(1, int(self.stats.sum()))
        pct = [100.0 * s / t for s in self.stats]
        return (
            "\nStatistics:\n"
            f"  Rice-0: {pct[0]:.4f}%\n"
            f"  Rice-1: {pct[1]:.4f}%\n"
            f"  Rice-2: {pct[2]:.4f}%\n"
            f"  Rice-3: {pct[3]:.4f}%\n"
            f"  BFP: {pct[4]:.4f}%\n"
            f"  Pass-through {pct[5]:.4f}%\n"
        )


def _frames_of(samples: np.ndarray, spf: int):
    n = len(samples)
    n_frames = -(-n // spf) if n else 0
    return n_frames


def encode(
    samples,
    params: Parameters | None = None,
    engine: str = "jax",
    batch_frames: int = DEFAULT_BATCH_FRAMES,
    source_id: int = 1,
    width_hint: int | None = None,
    block_width_hint: int | None = None,
) -> EncodeResult:
    """Encode a mono int16 stream into a frame stream (no archive header).

    engine: "jax" (batched device pipeline), "native" (C++ host core),
    "numpy" (oracle), or "auto" (routed by workload shape — engine.py).
    width_hint: start the adaptive payload-width ladder at the smallest rung
    covering this many words (callers with cross-call context, e.g. the
    stream encoder, avoid re-discovering the rung every batch).  The result
    carries the final rung in `width_used`.
    block_width_hint: same for the block-buffer width ladder
    (`block_width_used` on the result)."""
    if engine == "auto":
        from ..engine import resolve_engine

        engine = resolve_engine(engine)
    params = params or Parameters()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    if samples.ndim != 1:
        raise MoreThanOneChannel("expected a mono 1-D sample array")

    stats = np.zeros(6, dtype=np.int64)
    if engine == "numpy":
        st = [0] * 6
        data = oracle.encode(samples, params, st)
        stats += np.asarray(st, dtype=np.int64)
        return EncodeResult(data, stats)
    if engine == "native":
        from .. import native

        st = [0] * 6
        # All cores: frame ranges encode in parallel with byte-identical
        # output (frames are self-contained).
        data = native.encode(samples, params, st, nthreads=0)
        stats += np.asarray(st, dtype=np.int64)
        return EncodeResult(data, stats)
    if engine != "jax":
        raise ValueError(f"unknown engine {engine!r}")

    from ..ops.encode_kernel import (
        block_width_rungs,
        encode_frames,
        fits_block_width,
        fits_width,
        width_rungs,
    )

    spf = params.samples_per_frame
    n = len(samples)
    n_frames = _frames_of(samples, spf)
    out_parts: list[bytes] = []

    def make_batch(base):
        f_batch = min(batch_frames, n_frames - base)
        batch = np.zeros((batch_frames, spf), dtype=np.int16)
        n_valid = np.zeros(batch_frames, dtype=np.int32)
        # Bulk-fill the full frames with one reshape; only a trailing
        # partial frame needs special casing.
        start = base * spf
        n_full = min(f_batch, (n - start) // spf)
        if n_full:
            batch[:n_full] = samples[start : start + n_full * spf].reshape(n_full, spf)
            n_valid[:n_full] = spf
        if n_full < f_batch:
            tail = samples[start + n_full * spf :]
            batch[n_full, : len(tail)] = tail
            n_valid[n_full] = len(tail)
        return f_batch, batch, n_valid

    # Adaptive width specializations: encode at compact payload-width (W)
    # and block-buffer-width (NW) rungs — the packing stages scale with
    # both statics — and escalate each independently (sticky, so
    # incompressible material pays the double dispatch at most once per
    # call) when a batch overflows.  `nbytes` and `blockfit_bits` are
    # derived from the code lengths, not the packed words, so the overflow
    # checks are reliable even for truncated frames.
    rungs = width_rungs(params)
    nw_rungs = block_width_rungs(params)
    rung = 0
    nw_rung = 0
    if width_hint is not None:
        while rung < len(rungs) - 1 and rungs[rung] < width_hint:
            rung += 1
    if block_width_hint is not None:
        while nw_rung < len(nw_rungs) - 1 and nw_rungs[nw_rung] < block_width_hint:
            nw_rung += 1

    bases = list(range(0, n_frames, batch_frames))
    pending = None  # (f_batch, n_valid, async device result, width, nw, batch)
    for base in bases + [None]:
        if base is not None:
            f_batch, batch, n_valid = make_batch(base)
            # Dispatch is async: the H2D transfer and device compute of this
            # batch overlap the host-side materialization/assembly of the
            # previous one below.
            w, nw = rungs[rung], nw_rungs[nw_rung]
            res = encode_frames(batch, n_valid, params, "block", w, nw)
            prev, pending = pending, (f_batch, n_valid, res, w, nw, batch)
        else:
            prev, pending = pending, None
        if prev is None:
            continue
        f_batch, n_valid, res, w, nw, batch_np = prev
        nbytes = np.asarray(res["nbytes"])
        need_w = not fits_width(nbytes[:f_batch], w, params)
        need_nw = not fits_block_width(
            np.asarray(res["blockfit_bits"])[:f_batch], nw, params
        )
        if need_w or need_nw:
            while need_w and rung < len(rungs) - 1:
                rung += 1
                if fits_width(nbytes[:f_batch], rungs[rung], params):
                    break
            if need_nw:
                bf = np.asarray(res["blockfit_bits"])[:f_batch]
                while nw_rung < len(nw_rungs) - 1:
                    nw_rung += 1
                    if fits_block_width(bf, nw_rungs[nw_rung], params):
                        break
            w, nw = rungs[rung], nw_rungs[nw_rung]
            res = encode_frames(batch_np, n_valid, params, "block", w, nw)
            nbytes = np.asarray(res["nbytes"])
        # Transfer only the populated word columns: payload buffers are
        # sized for incompressible input (W words) but typical frames fill
        # ~W/6 — slicing on device (power-of-two buckets keep the compile
        # cache small) cuts D2H traffic accordingly.
        maxw = max(1, (int(nbytes[:f_batch].max(initial=0)) + 3) // 4)
        wcols = min(w, 1 << (maxw - 1).bit_length())
        words = np.ascontiguousarray(res["payload_words"][:, :wcols])
        payload = words.byteswap().view(np.uint8)  # big-endian bytes, zero-copy-ish
        crc = np.asarray(res["crc"])
        stats += np.asarray(res["stats"])[:f_batch].sum(axis=0, dtype=np.int64)

        headers = build_frame_headers(n_valid[:f_batch], source_id, nbytes[:f_batch], crc[:f_batch])
        out_parts.append(_assemble(headers, payload[:f_batch], nbytes[:f_batch]))

    result = EncodeResult(b"".join(out_parts), stats)
    result.width_used = rungs[rung]
    result.block_width_used = nw_rungs[nw_rung]
    return result


def _assemble(headers: np.ndarray, payload: np.ndarray, nbytes: np.ndarray) -> bytes:
    """Concatenate (header || payload[:nbytes]) across frames — native
    memcpy pass when available, python fallback otherwise."""
    try:
        from .. import native

        if native.available():
            return native.assemble_frames(headers, payload, nbytes)
    except Exception:
        pass
    total = int((constants.FRAME_HEADER_LENGTH + nbytes).sum())
    buf = np.zeros(total, dtype=np.uint8)
    pos = 0
    for i in range(len(headers)):
        buf[pos : pos + 20] = headers[i]
        pos += 20
        nb = int(nbytes[i])
        buf[pos : pos + nb] = payload[i, :nb]
        pos += nb
    return buf.tobytes()
