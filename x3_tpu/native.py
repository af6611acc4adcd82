"""ctypes bindings to the native host-side codec core (native/x3core.cpp).

The reference's runtime is entirely native; this module exposes the
framework's C++ equivalent as the "native" engine.  The library is built on
demand from native/x3core.cpp with `make -C native` and loaded lazily;
everything degrades gracefully to the Python oracle when no toolchain is
available.

The build uses -march=native, so a library built on one CPU may fault on
another.  Each host therefore builds its own copy, under native/build/ with
a name keyed by the CPU's model and feature flags; a checkout copied to
another machine rebuilds instead of loading a foreign binary."""

from __future__ import annotations

import ctypes
import hashlib
import platform
import subprocess
from pathlib import Path

import numpy as np

from .errors import (
    FrameDecodeInvalidBPF,
    FrameHeaderInvalidPayloadCRC,
    OutOfBoundsInverse,
    X3Error,
)
from .params import Parameters

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"


def host_tag() -> str:
    """Short fingerprint of this host's CPU: architecture, model name and
    feature flags (what -march=native compiles for)."""
    fields = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    fields.append(line.strip())
                if line.strip() == "":  # first processor's block is enough
                    break
    except OSError:
        fields.append(platform.processor())
    return hashlib.sha1("\n".join(fields).encode()).hexdigest()[:12]


_LIB_PATH = _NATIVE_DIR / "build" / f"libx3core-{host_tag()}.so"
_lib = None


class _CParams(ctypes.Structure):
    _fields_ = [
        ("block_len", ctypes.c_int32),
        ("blocks_per_frame", ctypes.c_int32),
        ("codes", ctypes.c_int32 * 3),
        ("thresholds", ctypes.c_int32 * 3),
    ]


def _cparams(params: Parameters) -> _CParams:
    c = _CParams()
    c.block_len = params.block_len
    c.blocks_per_frame = params.blocks_per_frame
    for i in range(3):
        c.codes[i] = params.codes[i]
        c.thresholds[i] = params.thresholds[i]
    return c


_build_failed = False


def build(force: bool = False) -> bool:
    """Build this host's library (make is a fast no-op when the source is
    unchanged, and rebuilds stale binaries after source edits; force=True
    rebuilds unconditionally).  Returns True when the library exists; a
    failed build is cached so the make subprocess is not retried on every
    call."""
    global _build_failed
    if _build_failed and not force:
        return _LIB_PATH.exists()
    lib = _LIB_PATH.relative_to(_NATIVE_DIR)
    cmd = ["make", "-C", str(_NATIVE_DIR), f"LIB={lib}"] + (["-B"] if force else [])
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        _build_failed = True
    return _LIB_PATH.exists()


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.x3_crc16.restype = ctypes.c_uint16
    lib.x3_crc16.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.x3_encode.restype = ctypes.c_int64
    lib.x3_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(_CParams),
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.x3_decode_frame.restype = ctypes.c_int32
    lib.x3_decode_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(_CParams),
        ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.x3_encode_mt.restype = ctypes.c_int64
    lib.x3_encode_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(_CParams),
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.x3_decode_frames_mt.restype = ctypes.c_int32
    lib.x3_decode_frames_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.POINTER(_CParams), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.x3_decode_frames_mt_crc.restype = ctypes.c_int32
    lib.x3_decode_frames_mt_crc.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(_CParams),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.x3_assemble_frames.restype = ctypes.c_int64
    lib.x3_assemble_frames.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.x3_index_frames.restype = ctypes.c_int64
    lib.x3_index_frames.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def crc16(data: bytes) -> int:
    lib = load()
    if lib is None:
        raise X3Error("native library unavailable")
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(lib.x3_crc16(buf.ctypes.data_as(ctypes.c_void_p), len(buf)))


def encode(samples, params: Parameters | None = None, stats=None, nthreads: int = 1) -> bytes:
    """Native scalar encode of a full stream (frames incl. headers).

    nthreads > 1 (or 0 = all cores) encodes frame ranges in parallel with
    byte-identical output (frames are self-contained)."""
    lib = load()
    if lib is None:
        raise X3Error("native library unavailable")
    params = params or Parameters()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    n = len(samples)
    if n == 0:
        return b""
    # Worst case (incompressible input) expands: 16 bits/sample payload,
    # a 6-bit header per block, and per-frame header/align overhead.
    n_frames = n // params.samples_per_frame + 2
    n_blocks = n // params.block_len + n_frames
    cap = 2 * n + n_blocks + 64 * n_frames + 1024
    out = np.zeros(cap, dtype=np.uint8)
    st = np.zeros(6, dtype=np.int64)
    if nthreads == 1:
        wrote = lib.x3_encode(
            samples.ctypes.data_as(ctypes.c_void_p), n, ctypes.byref(_cparams(params)),
            out.ctypes.data_as(ctypes.c_void_p), cap, st.ctypes.data_as(ctypes.c_void_p),
        )
    else:
        wrote = lib.x3_encode_mt(
            samples.ctypes.data_as(ctypes.c_void_p), n, ctypes.byref(_cparams(params)),
            out.ctypes.data_as(ctypes.c_void_p), cap, st.ctypes.data_as(ctypes.c_void_p),
            nthreads,
        )
    if wrote < 0:
        raise X3Error("native encode overflow")
    if stats is not None:
        for i in range(6):
            stats[i] += int(st[i])
    return out[:wrote].tobytes()


def decode_frames_mt(
    data: bytes, index, params: Parameters, nthreads: int = 0, expected_crcs=None
) -> np.ndarray:
    """Frame-parallel native decode of an indexed frame stream.

    index: list of (payload_offset, samples, payload_len) as returned by
    index_frames.  Returns the concatenated int16 samples.

    expected_crcs: optional per-frame payload CRC16s, verified in the same
    threaded pass (decodefile.rs:93-103); a mismatch raises
    FrameHeaderInvalidPayloadCRC."""
    lib = load()
    if lib is None:
        raise X3Error("native library unavailable")
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    offs = np.asarray([o for o, _, _ in index], dtype=np.int64)
    samp = np.asarray([s for _, s, _ in index], dtype=np.int32)
    plens = np.asarray([l for _, _, l in index], dtype=np.int32)
    total = int(samp.sum())
    wav = np.zeros(total, dtype=np.int16)
    err_frame = np.zeros(1, dtype=np.int64)
    if expected_crcs is None:
        crc_ptr = None
    else:
        crcs = np.ascontiguousarray(expected_crcs, dtype=np.uint16)
        crc_ptr = crcs.ctypes.data_as(ctypes.c_void_p)
    rc = lib.x3_decode_frames_mt_crc(
        buf.ctypes.data_as(ctypes.c_void_p), offs.ctypes.data_as(ctypes.c_void_p),
        samp.ctypes.data_as(ctypes.c_void_p), plens.ctypes.data_as(ctypes.c_void_p),
        crc_ptr, len(index), ctypes.byref(_cparams(params)),
        wav.ctypes.data_as(ctypes.c_void_p),
        err_frame.ctypes.data_as(ctypes.c_void_p), nthreads,
    )
    if rc == -2:
        raise FrameDecodeInvalidBPF(f"native decode: invalid BFP (frame {int(err_frame[0])})")
    if rc == -3:
        raise OutOfBoundsInverse(f"native decode: inverse OOB (frame {int(err_frame[0])})")
    if rc == -4:
        raise FrameHeaderInvalidPayloadCRC(
            f"native decode: payload CRC mismatch (frame {int(err_frame[0])})"
        )
    if rc != 0:
        raise X3Error(f"native decode failed ({rc})")
    return wav


def decode_frame(payload: bytes, params: Parameters, samples: int) -> np.ndarray:
    lib = load()
    if lib is None:
        raise X3Error("native library unavailable")
    buf = np.frombuffer(bytes(payload), dtype=np.uint8)
    wav = np.zeros(samples, dtype=np.int16)
    rc = lib.x3_decode_frame(
        buf.ctypes.data_as(ctypes.c_void_p), len(buf), ctypes.byref(_cparams(params)),
        samples, wav.ctypes.data_as(ctypes.c_void_p),
    )
    if rc == -2:
        raise FrameDecodeInvalidBPF("native decode: invalid BFP")
    if rc == -3:
        raise OutOfBoundsInverse("native decode: inverse index out of bounds")
    if rc != 0:
        raise X3Error(f"native decode failed ({rc})")
    return wav


def assemble_frames(headers: np.ndarray, payloads: np.ndarray, nbytes: np.ndarray) -> bytes:
    """Concatenate (header || payload[:nbytes]) over frames in C
    (the device pipeline's host-epilogue assembly; one memcpy pass)."""
    lib = load()
    if lib is None:
        raise X3Error("native library unavailable")
    headers = np.ascontiguousarray(headers, dtype=np.uint8)
    payloads = np.ascontiguousarray(payloads).view(np.uint8).reshape(len(headers), -1)
    nbytes = np.ascontiguousarray(nbytes, dtype=np.int32)
    total = int(nbytes.sum()) + 20 * len(headers)
    out = np.empty(total, dtype=np.uint8)
    wrote = lib.x3_assemble_frames(
        headers.ctypes.data_as(ctypes.c_void_p), payloads.ctypes.data_as(ctypes.c_void_p),
        nbytes.ctypes.data_as(ctypes.c_void_p), len(headers), payloads.shape[1],
        out.ctypes.data_as(ctypes.c_void_p), total,
    )
    if wrote != total:
        raise X3Error(f"native assemble failed ({wrote} != {total})")
    return out.tobytes()


def index_frames(data: bytes, start: int, max_frames: int | None = None):
    """Native frame walk: [(payload_offset, samples, payload_len), ...]."""
    lib = load()
    if lib is None:
        raise X3Error("native library unavailable")
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if max_frames is None:
        max_frames = len(buf) // 22 + 2  # a frame is >= 22 bytes, so exact bound
    offs = np.zeros(max_frames, dtype=np.int64)
    samp = np.zeros(max_frames, dtype=np.int32)
    plens = np.zeros(max_frames, dtype=np.int32)
    n = lib.x3_index_frames(
        buf.ctypes.data_as(ctypes.c_void_p), len(buf), start,
        offs.ctypes.data_as(ctypes.c_void_p), samp.ctypes.data_as(ctypes.c_void_p),
        plens.ctypes.data_as(ctypes.c_void_p), max_frames,
    )
    return [(int(offs[i]), int(samp[i]), int(plens[i])) for i in range(n)]
