"""Exception hierarchy mirroring the reference's `X3Error` enum
(/root/reference/src/error.rs:27-62).  Device-side validity flags raised by
the batched kernels are reduced to these host exceptions."""

from __future__ import annotations


class X3Error(Exception):
    """Base class for all X3 codec errors."""


class InvalidEncodingThresh(X3Error):
    """Threshold must be less than or equal to the Rice code's offset."""


class OutOfBoundsInverse(X3Error):
    """A decoded code index is out of bounds for the inverse Rice table."""


class MoreThanOneChannel(X3Error):
    """Only mono (single channel) audio is supported."""


class ArchiveHeaderXMLInvalid(X3Error):
    """The archive header XML is poorly structured."""


class ArchiveHeaderXMLRiceCode(X3Error):
    """The archive header XML names an invalid Rice code."""


class ArchiveHeaderXMLInvalidKey(X3Error):
    """The archive magic 'X3ARCHIV' is missing."""


class FrameLength(X3Error):
    """The frame payload is too long."""


class FrameHeaderInvalidKey(X3Error):
    """The frame header is missing the 'x3' key."""


class FrameHeaderInvalidPayloadLen(X3Error):
    """The payload length reaches beyond the end of the available data."""


class FrameHeaderInvalidHeaderCRC(X3Error):
    """The frame header CRC16 does not match."""


class FrameHeaderInvalidPayloadCRC(X3Error):
    """The frame payload CRC16 does not match."""


class FrameDecodeInvalidBlockLength(X3Error):
    """The block length is bad."""


class FrameDecodeInvalidIndex(X3Error):
    """Invalid rice code encountered, index out of range."""


class FrameDecodeInvalidFType(X3Error):
    """Invalid block ftype encountered while decoding."""


class FrameDecodeInvalidBPF(X3Error):
    """The BFP decoder reached an invalid value (num_bits <= 5)."""


class FrameDecodeUnexpectedEnd(X3Error):
    """Fewer bytes remain than a frame header requires."""


class ByteWriterInsufficientMemory(X3Error):
    """The output buffer is too small."""


# Mapping from the batched decode kernel's per-frame error codes
# (ops.decode_kernel.ERR_*) to the reference's error classes
# (error.rs:27-62): 1 invalid BFP, 2 out-of-bounds inverse, 3 the
# bitstream overran / payload too large (unexpected end), 4 payload CRC.
DECODE_ERROR_CLASSES: dict[int, type] = {
    1: FrameDecodeInvalidBPF,
    2: OutOfBoundsInverse,
    3: FrameDecodeUnexpectedEnd,
    4: FrameHeaderInvalidPayloadCRC,
}


def decode_error(code: int, msg: str = "") -> X3Error:
    """Build the X3Error matching a device decode error code."""
    cls = DECODE_ERROR_CLASSES.get(int(code), X3Error)
    return cls(msg or f"frame failed to decode (code {int(code)})")
