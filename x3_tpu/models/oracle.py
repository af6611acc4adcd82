"""Reference-pure oracle codec: a direct, slow, bit-exact X3 encoder/decoder
in plain Python/NumPy.

This module is the differential oracle for the device pipelines (SURVEY.md §7
step 2): every golden byte vector from the reference's inline tests is pinned
against it, and the batched JAX kernels are validated against it on random
corpora.  Behavior follows the reference semantics exactly:

* encode: /root/reference/src/encoder.rs:175-315 (frame assembly, first
  sample raw in 16 bits, per-20-sample-block Rice/BFP/literal selection).
* decode: /root/reference/src/decoder.rs:36-235 (ftype dispatch, unary +
  suffix Rice decode via the shared inverse table, BFP sign fold quirk).
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..errors import (
    FrameDecodeInvalidBPF,
    FrameDecodeInvalidFType,
    OutOfBoundsInverse,
)
from ..ops.bitio import BitReader, BitWriter
from ..ops.crc import crc16
from ..params import Parameters

# Statistics slots (reference: encoder.rs:63, 96-108, 266): a Rice block
# counts under its code's nsubs slot (so slot 2 is unused with the default
# code selection [0, 1, 3]), BFP under 4, pass-through under 5.
STATS_SLOTS = 6
STAT_BFP = 4
STAT_PASSTHROUGH = 5


def count_bits(n: int) -> int:
    """Number of bits needed to represent n (reference: encoder.rs:228-231)."""
    return int(n).bit_length()


def write_frame_header(num_samples: int, source_id: int, payload_len: int, payload_crc: int) -> bytes:
    """Build the 20-byte big-endian frame header (reference: encoder.rs:122-162).

    Quirk replicated: the channels byte receives the same value as the
    source id (encoder.rs:130-138)."""
    header = bytearray(constants.FRAME_HEADER_LENGTH)
    header[0:2] = constants.FRAME_KEY.to_bytes(2, "big")
    header[constants.P_SOURCE_ID] = source_id
    header[constants.P_CHANNELS] = source_id  # quirk: id written twice
    header[constants.P_SAMPLES : constants.P_SAMPLES + 2] = (num_samples & 0xFFFF).to_bytes(2, "big")
    header[constants.P_PAYLOAD_SIZE : constants.P_PAYLOAD_SIZE + 2] = (payload_len & 0xFFFF).to_bytes(2, "big")
    # time stays zero (encoder.rs:148-150 FIXME)
    header_crc = crc16(header[: constants.P_HEADER_CRC])
    header[constants.P_HEADER_CRC : constants.P_HEADER_CRC + 2] = header_crc.to_bytes(2, "big")
    header[constants.P_PAYLOAD_CRC : constants.P_PAYLOAD_CRC + 2] = (payload_crc & 0xFFFF).to_bytes(2, "big")
    return bytes(header)


def _encode_rice_block(diffs, bw: BitWriter, params: Parameters, max_abs: int) -> int:
    ftype = sum(1 for t in params.thresholds if max_abs > t)
    bw.write_bits(ftype + 1, constants.RICE_HDR_LEN)
    rc = params.rice_codes[ftype]
    offset = rc.offset
    for d in diffs:
        ii = d + offset
        code = int(rc.code[ii])
        nbits = int(rc.num_bits[ii])
        # Equivalent to writing (nbits - bitlen(code)) zeros then the code:
        # the code value occupies the low bits of an nbits-wide field.
        bw.write_bits(code, nbits)
    return rc.nsubs


def _encode_bfp_block(diffs, bw: BitWriter, num_bits: int) -> int:
    bw.write_bits(num_bits, constants.BFP_HDR_LEN)
    for d in diffs:
        bw.write_bits(d & ((1 << (num_bits + 1)) - 1), num_bits + 1)
    return STAT_BFP


def _encode_literal_block(samples, bw: BitWriter) -> int:
    bw.write_bits(15, constants.BFP_HDR_LEN)
    for s in samples:
        bw.write_bits(int(s) & 0xFFFF, 16)
    return STAT_PASSTHROUGH


def encode_block(samples, diffs, bw: BitWriter, params: Parameters) -> int:
    """Encode one block; returns the statistics slot used
    (reference: x3_encode_block, encoder.rs:289-315)."""
    max_abs = max((abs(int(d)) for d in diffs), default=0)
    if max_abs <= params.thresholds[2]:
        return _encode_rice_block(diffs, bw, params, max_abs)
    num_bits = count_bits(max_abs)
    if num_bits >= 15:
        return _encode_literal_block(samples, bw)
    return _encode_bfp_block(diffs, bw, num_bits)


def encode_frame_payload(wav, params: Parameters, stats=None) -> tuple[bytes, int]:
    """Encode one frame's samples into its payload bytes.

    Returns (payload_bytes, payload_crc).  The payload is the raw 16-bit
    first sample, the per-block bitstream, zero-padded to a 16-bit word
    boundary (reference: encoder.rs:186-205).  Assumes the frame starts at
    an even stream position, which the container guarantees."""
    wav = [int(v) for v in wav]
    bw = BitWriter(stream_base=0)
    bw.write_bits(wav[0] & 0xFFFF, 16)
    diffs = [wav[i + 1] - wav[i] for i in range(len(wav) - 1)]
    bl = params.block_len
    for start in range(0, len(wav) - 1, bl):
        block_samples = wav[1 + start : 1 + start + bl]
        block_diffs = diffs[start : start + bl]
        slot = encode_block(block_samples, block_diffs, bw, params)
        if stats is not None:
            stats[slot] += len(block_samples)
    bw.word_align()
    return bw.getvalue(), bw.crc


def encode_frame(wav, params: Parameters, stats=None) -> bytes:
    """Encode one frame: 20-byte header followed by the payload
    (reference: encode_frame, encoder.rs:175-214)."""
    payload, payload_crc = encode_frame_payload(wav, params, stats)
    header = write_frame_header(len(wav), 1, len(payload), payload_crc)
    return header + payload


def encode(samples, params: Parameters | None = None, stats=None) -> bytes:
    """Encode a full sample stream into a sequence of frames
    (reference: encoder::encode, encoder.rs:51-111).  No archive header."""
    params = params or Parameters()
    samples = np.asarray(samples, dtype=np.int16)
    spf = params.samples_per_frame
    out = bytearray()
    for start in range(0, len(samples), spf):
        frame = samples[start : start + spf]
        out += encode_frame(frame, params, stats)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _wrap_i16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _unsigned_to_i16(a: int, num_bits: int) -> int:
    """Asymmetric sign fold (reference: decoder.rs:198-207): values strictly
    greater than 2^(num_bits-1) are negative; 2^(num_bits-1) itself is not."""
    neg_thresh = 1 << (num_bits - 1)
    if a > neg_thresh:
        a -= 1 << num_bits
    return a


def decode_block(br: BitReader, n: int, last_wav: int, params: Parameters) -> tuple[list, int]:
    """Decode one block of n samples (reference: decode_block, decoder.rs:132-235).

    Returns (samples, new_last_wav)."""
    ftype = br.read_nbits(2)
    out = []
    lw = last_wav
    if ftype == 0:
        num_bits = br.read_nbits(4) + 1
        if num_bits <= 5:
            raise FrameDecodeInvalidBPF(f"BFP num_bits={num_bits}")
        if num_bits == 16:
            for _ in range(n):
                v = br.read_nbits(16)
                lw = _wrap_i16(v)
                out.append(lw)
        else:
            for _ in range(n):
                a = br.read_nbits(num_bits)
                lw = _wrap_i16(lw + _unsigned_to_i16(a, num_bits))
                out.append(lw)
        return out, out[-1] if out else last_wav
    if ftype == 1:
        code = params.rice_codes[0]
        for _ in range(n):
            i = br.count_zero_bits()
            br.read_nbits(1)  # stop bit
            if i >= code.inv_len:
                raise OutOfBoundsInverse(f"index {i} >= {code.inv_len}")
            lw = _wrap_i16(lw + int(code.inv[i]))
            out.append(lw)
        return out, lw
    if ftype in (2, 3):
        code = params.rice_codes[ftype - 1]
        nb = 2 if ftype == 2 else 4
        level = 1 << code.nsubs
        for _ in range(n):
            zeros = br.count_zero_bits()
            r = br.read_nbits(nb)
            i = r + level * (zeros - 1)
            if i < 0 or i >= code.inv_len:
                raise OutOfBoundsInverse(f"index {i} >= {code.inv_len}")
            lw = _wrap_i16(lw + int(code.inv[i]))
            out.append(lw)
        return out, lw
    raise FrameDecodeInvalidFType(f"ftype {ftype}")


def decode_frame(payload: bytes, params: Parameters, samples: int) -> np.ndarray:
    """Decode one frame payload to samples
    (reference: decode_frame, decoder.rs:36-58)."""
    first = int.from_bytes(payload[0:2], "big", signed=True)
    out = [first]
    last_wav = first
    br = BitReader(payload[2:])
    remaining = samples - 1
    while remaining > 0:
        n = min(remaining, params.block_len)
        block, last_wav = decode_block(br, n, last_wav, params)
        out.extend(block)
        remaining -= n
    return np.asarray(out, dtype=np.int16)
