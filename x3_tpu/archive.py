"""Archive container: header build/parse, frame indexing, sync-word rescue.

Covers the reference's container responsibilities (encodefile.rs:82-138,
decodefile.rs:142-176) plus the dormant frame-resync scanner the reference
carries as dead code (bytereader.rs:62-79) — here implemented as a vectorized
search so corrupt frames can be skipped rather than aborting the decode."""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants
from .errors import (
    ArchiveHeaderXMLInvalidKey,
    FrameDecodeUnexpectedEnd,
    FrameHeaderInvalidHeaderCRC,
    FrameHeaderInvalidKey,
    FrameHeaderInvalidPayloadLen,
    FrameLength,
    MoreThanOneChannel,
)
from .models.oracle import write_frame_header
from .ops.crc import crc16 as _crc16_py, crc16_many
from .params import Parameters, X3aSpec
from .utils.xmlmeta import build_xml, parse_xml

crc16 = _crc16_py  # re-export for existing callers/tests


def _crc16(data) -> int:
    """CRC16 routed to the native core when built (the header walk calls
    this once per frame; the pure-Python fallback dominates archive
    indexing otherwise).  Self-replacing: the first call resolves the
    engine and rebinds the module attribute."""
    global _crc16
    try:
        from . import native

        if native.available():
            _crc16 = native.crc16
            return native.crc16(data)
    except Exception:
        pass
    _crc16 = _crc16_py
    return _crc16_py(data)


@dataclasses.dataclass
class FrameHeader:
    source_id: int
    channels: int
    samples: int
    payload_len: int
    payload_crc: int


def read_frame_header(data: bytes, validate: bool = True) -> FrameHeader:
    """Parse and validate a 20-byte frame header (decoder.rs:69-118)."""
    if len(data) < constants.FRAME_HEADER_LENGTH:
        raise FrameDecodeUnexpectedEnd(f"{len(data)} bytes < header length")
    if validate:
        expected = int.from_bytes(data[16:18], "big")
        if _crc16(data[0:16]) != expected:
            raise FrameHeaderInvalidHeaderCRC("frame header CRC mismatch")
    if data[0:2] != constants.FRAME_KEY_BYTES:
        raise FrameHeaderInvalidKey(f"bad frame key {data[0:2]!r}")
    channels = data[constants.P_CHANNELS]
    if channels > 1:
        raise MoreThanOneChannel(f"{channels} channels")
    payload_len = int.from_bytes(data[6:8], "big")
    if payload_len >= constants.FRAME_MAX_LENGTH:
        raise FrameLength(f"payload {payload_len} >= {constants.FRAME_MAX_LENGTH}")
    return FrameHeader(
        source_id=data[constants.P_SOURCE_ID],
        channels=channels,
        samples=int.from_bytes(data[4:6], "big"),
        payload_len=payload_len,
        payload_crc=int.from_bytes(data[18:20], "big"),
    )


def build_archive_header(sample_rate: int, params: Parameters) -> bytes:
    """'X3ARCHIV' magic, pseudo frame header (samples=0, id=0), XML metadata
    padded to even length (encodefile.rs:82-138)."""
    xml = build_xml(sample_rate, params)
    payload = xml + (b"\x00" if len(xml) % 2 else b"")
    header = write_frame_header(0, 0, len(payload), crc16(payload))
    return constants.ARCHIVE_ID + header + payload


def parse_archive_header(data: bytes) -> tuple[X3aSpec, int]:
    """Parse the archive header; returns (spec, total header size in bytes)."""
    if data[: constants.ARCHIVE_ID_LEN] != constants.ARCHIVE_ID:
        raise ArchiveHeaderXMLInvalidKey(f"bad magic {data[:8]!r}")
    pos = constants.ARCHIVE_ID_LEN
    header = read_frame_header(data[pos : pos + constants.FRAME_HEADER_LENGTH])
    pos += constants.FRAME_HEADER_LENGTH
    xml_payload = data[pos : pos + header.payload_len]
    sample_rate, params = parse_xml(xml_payload)
    spec = X3aSpec(sample_rate=sample_rate, params=params, channels=header.channels)
    return spec, pos + header.payload_len


def walk_frames(data: bytes, start: int, resync: bool = False):
    """Sequentially index frames: yields (payload_offset, FrameHeader).

    Stops cleanly when at most a header's worth of bytes remain
    (decodefile.rs:107-109).  Without resync, header errors propagate and a
    valid header whose payload extends past the end of the data raises
    FrameHeaderInvalidPayloadLen — both parity with the reference
    (decodefile.rs:112-121).  With resync=True, either triggers a sync-word
    scan to the next plausible frame instead."""
    pos = start
    n = len(data)
    while n - pos > constants.FRAME_HEADER_LENGTH:
        try:
            header = read_frame_header(data[pos : pos + constants.FRAME_HEADER_LENGTH])
        except Exception:
            if not resync:
                raise
            nxt = find_sync(data, pos + 1)
            if nxt < 0:
                return
            pos = nxt
            continue
        payload_off = pos + constants.FRAME_HEADER_LENGTH
        if n - payload_off < header.payload_len:
            if not resync:
                raise FrameHeaderInvalidPayloadLen(
                    f"frame at {pos}: payload {header.payload_len} B overruns "
                    f"the remaining {n - payload_off} B"
                )
            nxt = find_sync(data, pos + 1)
            if nxt < 0:
                return
            pos = nxt
            continue
        yield payload_off, header
        pos = payload_off + header.payload_len


def read_archive_header_file(f) -> tuple[X3aSpec, int]:
    """Parse the archive header from an open binary file (bounded reads).
    Returns (spec, total header size); leaves the file positioned at the
    first frame."""
    f.seek(0)
    head = f.read(constants.ARCHIVE_ID_LEN + constants.FRAME_HEADER_LENGTH)
    if head[: constants.ARCHIVE_ID_LEN] != constants.ARCHIVE_ID:
        raise ArchiveHeaderXMLInvalidKey(f"bad magic {head[:8]!r}")
    header = read_frame_header(head[constants.ARCHIVE_ID_LEN :])
    xml_payload = f.read(header.payload_len)
    sample_rate, params = parse_xml(xml_payload)
    spec = X3aSpec(sample_rate=sample_rate, params=params, channels=header.channels)
    return spec, constants.ARCHIVE_ID_LEN + constants.FRAME_HEADER_LENGTH + header.payload_len


def walk_frames_file(f, start: int, resync: bool = False):
    """Seek-based frame indexing over an open binary file: yields
    (payload_offset, FrameHeader) reading only the 20-byte headers (payloads
    are skipped with seeks), so memory stays bounded on any archive size —
    the streaming counterpart of walk_frames (decodefile.rs:44-45 streams
    with a 24 KiB buffer).  Same error semantics as walk_frames."""
    f.seek(0, 2)
    n = f.tell()
    pos = start
    while n - pos > constants.FRAME_HEADER_LENGTH:
        f.seek(pos)
        try:
            header = read_frame_header(f.read(constants.FRAME_HEADER_LENGTH))
        except Exception:
            if not resync:
                raise
            nxt = find_sync_file(f, pos + 1, n)
            if nxt < 0:
                return
            pos = nxt
            continue
        payload_off = pos + constants.FRAME_HEADER_LENGTH
        if n - payload_off < header.payload_len:
            if not resync:
                raise FrameHeaderInvalidPayloadLen(
                    f"frame at {pos}: payload {header.payload_len} B overruns "
                    f"the remaining {n - payload_off} B"
                )
            nxt = find_sync_file(f, pos + 1, n)
            if nxt < 0:
                return
            pos = nxt
            continue
        yield payload_off, header
        pos = payload_off + header.payload_len


def find_sync_file(f, start: int, n: int | None = None, chunk: int = 1 << 20) -> int:
    """find_sync over an open file: windowed scan with bounded memory."""
    if n is None:
        f.seek(0, 2)
        n = f.tell()
    pos = start
    while pos < n:
        f.seek(pos)
        data = f.read(chunk + constants.FRAME_HEADER_LENGTH)
        if len(data) < constants.FRAME_HEADER_LENGTH:
            return -1
        r = find_sync(data, 0)
        if r >= 0:
            return pos + r
        if pos + len(data) >= n:
            return -1
        pos += chunk
    return -1


def find_sync(data: bytes, start: int) -> int:
    """Vectorized scan for the next byte offset whose bytes look like a valid
    frame header ('x3' key + valid header CRC).  Vectorized replacement for the
    reference's dormant find_le_u16 scanner (bytereader.rs:62-79)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    if n - start < constants.FRAME_HEADER_LENGTH:
        return -1
    window = arr[start:]
    cand = np.nonzero((window[:-1] == 0x78) & (window[1:] == 0x33))[0] + start
    cand = cand[cand + constants.FRAME_HEADER_LENGTH <= n]
    if len(cand) == 0:
        return -1
    # Validate header CRCs of all candidates at once (sliding windows are a
    # strided view — no python loop even on adversarial candidate counts).
    windows = np.lib.stride_tricks.sliding_window_view(arr, 16)
    rows = windows[cand]
    crcs = crc16_many(rows, np.full(len(cand), 16))
    stored = (arr[cand + 16].astype(np.uint16) << 8) | arr[cand + 17]
    ok = np.nonzero(crcs == stored)[0]
    return int(cand[ok[0]]) if len(ok) else -1


def verify_payload_crcs_parts(payloads, want_crcs) -> np.ndarray:
    """Batched payload CRC check over a list of payload byte strings.
    Returns a bool array, True where the CRC matches the expected value."""
    if not payloads:
        return np.zeros(0, bool)
    try:
        from . import native

        if native.available():
            return np.asarray(
                [native.crc16(p) == w for p, w in zip(payloads, want_crcs)], dtype=bool
            )
    except Exception:
        pass
    max_len = max(len(p) for p in payloads)
    rows = np.zeros((len(payloads), max_len), dtype=np.uint8)
    lens = np.zeros(len(payloads), dtype=np.int64)
    for i, p in enumerate(payloads):
        rows[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
    return crc16_many(rows, lens) == np.asarray(want_crcs, dtype=np.uint16)


def verify_payload_crcs(data: bytes, index: list) -> np.ndarray:
    """Batched payload CRC check for an entire frame index.  Returns a bool
    array, True where the payload CRC matches (decodefile.rs:93-103).

    Uses the native CRC core when available (C table walk, ~GB/s); falls
    back to the row-vectorized numpy CRC."""
    if not index:
        return np.zeros(0, bool)
    try:
        from . import native

        if native.available():
            return np.asarray(
                [native.crc16(data[off : off + h.payload_len]) == h.payload_crc for off, h in index],
                dtype=bool,
            )
    except Exception:
        pass
    max_len = max(h.payload_len for _, h in index)
    arr = np.frombuffer(data, dtype=np.uint8)
    rows = np.zeros((len(index), max_len), dtype=np.uint8)
    lens = np.zeros(len(index), dtype=np.int64)
    want = np.zeros(len(index), dtype=np.uint16)
    for i, (off, h) in enumerate(index):
        rows[i, : h.payload_len] = arr[off : off + h.payload_len]
        lens[i] = h.payload_len
        want[i] = h.payload_crc
    return crc16_many(rows, lens) == want
