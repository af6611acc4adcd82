"""Host-side bit-granular I/O used by the oracle codec and the file layer.

The reference implements these as sequential state machines
(`BitPacker`, /root/reference/src/bitpacker.rs:46-177 and `BitReader`,
/root/reference/src/bitreader.rs:51-176).  The device pipelines replace them
with prefix-sum offset computation plus vectorized packing/extraction
(see ops/encode_kernel.py / ops/decode_kernel.py); these plain-Python
equivalents exist as the differential oracle and for the scalar host path.

Semantics pinned by the reference and replicated here:

* Bits are written MSB-first into big-endian bytes.
* `write_bits(value, n)` masks `value` to its low `n` bits.
* `word_align()` pads with zero bits until the *stream position*
  (base offset + bytes written) is 2-byte aligned, flushing any partial
  byte first (bitpacker.rs:124-132).
* Reads past the end of the data return zero bits; unary zero counts are
  capped at the end of the data (bitreader.rs:29-49, 128-139).
"""

from __future__ import annotations

from .crc import update_crc16


class BitWriter:
    """MSB-first bit appender with running CRC16 over flushed bytes."""

    def __init__(self, stream_base: int = 0):
        self._bytes = bytearray()
        self._scratch = 0
        self._p_bit = 0  # bits used in the scratch byte
        self._stream_base = stream_base
        self.crc = 0xFFFF

    def _flush(self):
        self.crc = update_crc16(self.crc, self._scratch)
        self._bytes.append(self._scratch)
        self._scratch = 0
        self._p_bit = 0

    def write_bits(self, value: int, num_bits: int):
        value &= (1 << num_bits) - 1
        n = num_bits
        while n > 0:
            rem = 8 - self._p_bit
            if n >= rem:
                self._scratch |= (value >> (n - rem)) & ((1 << rem) - 1)
                self._flush()
                n -= rem
            else:
                self._scratch |= (value & ((1 << n) - 1)) << (rem - n)
                self._p_bit += n
                n = 0

    def write_packed_zeros(self, num_zeros: int):
        self.write_bits(0, num_zeros)

    def write_bytes(self, data: bytes):
        if self._p_bit != 0:
            raise ValueError("write_bytes requires byte alignment")
        for b in data:
            self.crc = update_crc16(self.crc, b)
        self._bytes.extend(data)

    def word_align(self):
        if self._p_bit != 0:
            self._flush()
        while (self._stream_base + len(self._bytes)) % 2 != 0:
            self._flush()

    def __len__(self) -> int:
        return len(self._bytes)

    def getvalue(self) -> bytes:
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit extractor over a byte buffer."""

    def __init__(self, data: bytes):
        self._data = bytes(data)
        self._total_bits = 8 * len(self._data)
        self.pos = 0  # absolute bit position

    def _bit(self, p: int) -> int:
        if p >= self._total_bits:
            return 0
        return (self._data[p >> 3] >> (7 - (p & 7))) & 1

    def read_nbits(self, n: int) -> int:
        result = 0
        for k in range(n):
            result = (result << 1) | self._bit(self.pos + k)
        self.pos += n
        return result

    def count_zero_bits(self) -> int:
        count = 0
        while self.pos + count < self._total_bits and self._bit(self.pos + count) == 0:
            count += 1
        self.pos += count
        return count

    def inc_bits(self, n: int):
        self.pos += n

    @property
    def remaining_bits(self) -> int:
        return max(0, self._total_bits - self.pos)
