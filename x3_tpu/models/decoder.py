"""Public decode API: batched frame-parallel decode with host padding.

Mirrors the reference's `decoder::decode_frame` surface (decoder.rs:36-58)
but takes *many* frame payloads at once — the format's self-contained frames
are the parallel axis (SURVEY.md §2 decoder row)."""

from __future__ import annotations

import numpy as np

from ..errors import decode_error
from ..params import Parameters
from . import oracle

DEFAULT_BATCH_FRAMES = 256


def decode_geometry(params: Parameters, n_samples, payload_lens):
    """Static (n_blocks, w_words) decode specialization for a batch.

    The reference decoder is geometry-general: its block loop runs off the
    caller-supplied sample count alone (decoder.rs:36-58), and the archive
    XML does not serialize blocks_per_frame (decodefile.rs:295-300), so
    valid archives may carry frames LARGER than params.samples_per_frame.
    The kernel's static shapes therefore follow the DATA:

    * n_blocks: None (params geometry) while every frame fits; otherwise
      the smallest power-of-two multiple of blocks_per_frame that covers
      the batch's max sample count — bucketing bounds the compile cache.
    * w_words: the smallest width rung holding the longest payload,
      escalating past the params worst case by powers of two — the buffer
      must hold the WHOLE payload (trailing bytes the walk never reaches
      still feed the device CRC and cap unary runs, bitreader.rs:129-139;
      the format caps payloads at 0x7fe0 bytes, x3.rs:145)."""
    from ..ops.encode_kernel import frame_geometry, width_rungs

    S, B, L, W = frame_geometry(params)
    max_n = max((int(n) for n in n_samples), default=0)
    maxlen = max((int(p) for p in payload_lens), default=0)
    n_blocks = None
    if max_n > S:
        n_blocks = B
        while 1 + n_blocks * L < max_n:
            n_blocks *= 2
    rungs = width_rungs(params)
    w = next((r for r in rungs if maxlen <= r * 4), None)
    if w is None:
        w = rungs[-1]
        while maxlen > w * 4:
            w *= 2
    return n_blocks, w


def decode_frames_batch(payloads, n_samples, params: Parameters | None = None, check_crcs=None):
    """Decode a list of frame payloads (bytes) with their sample counts.

    Returns (list of int16 arrays, err int array).  Lanes are padded to the
    pipeline's static payload size; errors are per-frame ERR_* codes
    (ops.decode_kernel: 0 ok, 1 invalid BFP, 2 OOB inverse, 3 overrun),
    mappable to exceptions via errors.decode_error.

    check_crcs: optional list of expected payload CRC16s — when given, the
    CRCs are verified ON DEVICE (fused GF(2) matmul) and mismatches are
    reported as a third return value (crc_ok bool array)."""
    from ..ops.decode_kernel import decode_frames, decode_frames_checked

    params = params or Parameters()
    f = len(payloads)
    if f == 0:
        return ([], np.zeros(0, np.int32)) if check_crcs is None else ([], np.zeros(0, np.int32), np.zeros(0, bool))
    arrs = [np.frombuffer(p, dtype=np.uint8) for p in payloads]
    # Static specialization follows the batch (see decode_geometry): frame
    # geometry from the max header sample count, payload width from the
    # longest payload — compact rungs when everything fits the defaults.
    n_blocks, w = decode_geometry(params, n_samples, [len(a) for a in arrs])
    # Pad the lane count to a power-of-two bucket: batch tails vary per
    # file, and each distinct (F, W) shape is a fresh device compile.
    # Dummy lanes (n_samples=0, zero payload) decode to nothing by design.
    fp = 1 << max(0, (f - 1).bit_length())
    buf = np.zeros((fp, w * 4), dtype=np.uint8)
    ns = np.zeros(fp, dtype=np.int32)
    plens = np.zeros(fp, dtype=np.int32)
    for i, (arr, n) in enumerate(zip(arrs, n_samples)):
        buf[i, : len(arr)] = arr
        ns[i] = n
        plens[i] = len(arr)
    if check_crcs is not None:
        out, err, crc = decode_frames_checked(buf, ns, plens, params, n_blocks)
        crc_ok = np.asarray(crc)[:f] == np.asarray(check_crcs, dtype=np.int64)
    else:
        out, err = decode_frames(buf, ns, plens, params, n_blocks)
    out = np.asarray(out)[:f]
    err = np.asarray(err)[:f]
    outs = [out[i, : ns[i]].copy() for i in range(f)]
    return (outs, err) if check_crcs is None else (outs, err, crc_ok)


def decode_frame(payload: bytes, params: Parameters, samples: int, engine: str = "jax") -> np.ndarray:
    """Decode a single frame payload (parity with decoder::decode_frame).

    Decode failures raise the matching reference error class
    (error.rs:27-62) via the kernel's per-frame error code."""
    if engine == "auto":
        from ..engine import resolve_engine

        engine = resolve_engine(engine)
    if engine == "native":
        from .. import native

        return native.decode_frame(payload, params, samples)
    if engine == "numpy":
        return oracle.decode_frame(payload, params, samples)
    outs, err = decode_frames_batch([payload], [samples], params)
    if err[0]:
        raise decode_error(err[0])
    return outs[0]
