"""Batched CRC-16/CCITT on device, reformulated as a matmul.

The reference computes CRCs with a sequential byte-at-a-time table walk
(/root/reference/src/crc.rs:44-58).  That chain looks unparallelizable, but
CRC is linear over GF(2): with the byte-update r' = S(r) ^ T[b] (S and the
table T both GF(2)-linear), the CRC of an n-byte buffer with init I is

    crc = S^n(I)  ^  sum_k S^(n-1-k)(T[b_k])

The data part is a fixed GF(2) matrix applied to the buffer's bits, i.e. a
binary matmul — a dense, fully parallel operation.  The pipeline packs
every frame's payload into a static-size zero-padded buffer, so:

1. `crc = const ^ (bits @ M) & 1` — one int8 matmul over [F, n_bits] with a
   precomputed [n_bits, 16] bit-contribution matrix (int32 accumulation).
2. The buffer is payload ∥ zeros(z); trailing zero bytes advance the register
   by S^z, so the true payload CRC is S^(-z) applied to the buffer CRC.  z is
   dynamic per frame; we apply precomputed S^(-2^k) matrices conditioned on
   the bits of z (a handful of 16-wide selects — negligible).

Everything is bit-exact with crc.py (tested against the reference vectors).
"""

from __future__ import annotations

import functools

import numpy as np

from .crc import CRC_TABLE


def _s_apply(v: np.ndarray) -> np.ndarray:
    """One zero-byte advance of the CRC register: S(r) = (r<<8) ^ T[r>>8]."""
    v = np.asarray(v, dtype=np.uint16)
    return (((v << np.uint16(8)) & np.uint16(0xFFFF)) ^ CRC_TABLE[v >> 8]).astype(np.uint16)


def _matrix_of(fn) -> np.ndarray:
    """16x16 GF(2) matrix (as 16 uint16 basis images) of a linear map."""
    basis = np.uint16(1) << np.arange(16, dtype=np.uint16)
    return fn(basis)


def _gf2_invert(cols: np.ndarray) -> np.ndarray:
    """Invert a GF(2) 16x16 matrix given as basis-image columns."""
    m = np.zeros((16, 16), dtype=np.uint8)
    for j in range(16):
        for i in range(16):
            m[i, j] = (int(cols[j]) >> i) & 1
    aug = np.concatenate([m, np.eye(16, dtype=np.uint8)], axis=1)
    for col in range(16):
        pivot = next(r for r in range(col, 16) if aug[r, col])
        aug[[col, pivot]] = aug[[pivot, col]]
        for r in range(16):
            if r != col and aug[r, col]:
                aug[r] ^= aug[col]
    inv = aug[:, 16:]
    out = np.zeros(16, dtype=np.uint16)
    for j in range(16):
        out[j] = int("".join(str(b) for b in inv[::-1, j]), 2)
    return out


def _apply_cols(cols: np.ndarray, v):
    """Apply a GF(2) matrix (basis-image columns) to uint16 values (np or jnp)."""
    acc = v * 0
    for b in range(16):
        bit = (v >> b) & 1
        acc = acc ^ (bit * int(cols[b]))
    return acc


@functools.lru_cache(maxsize=8)
def crc_matmul_consts(n_bytes: int):
    """Precompute (M, const_init, inv_pow_cols) for a static buffer length.

    M: [n_bytes*8, 16] int8 — contribution of each input bit to each CRC bit
       (input bits MSB-first per byte, matching np.unpackbits).
    const_init: uint16 — S^n(0xffff).
    inv_pow_cols: [n_levels, 16] uint16 — basis images of S^(-2^k).
    """
    n_bits = n_bytes * 8
    m = np.zeros((n_bits, 16), dtype=np.int8)
    # Backward recurrence: contribution vectors of the last byte's bits are
    # T[1<<p]; each step toward the front applies S once.
    contrib = CRC_TABLE[np.uint8(1) << np.arange(8)].astype(np.uint16)  # index p -> T[1<<p]
    for k in range(n_bytes - 1, -1, -1):
        # bit j within byte (MSB-first) corresponds to p = 7 - j
        for j in range(8):
            c = int(contrib[7 - j])
            m[k * 8 + j] = (c >> np.arange(16)) & 1
        contrib = _s_apply(contrib)

    init = np.uint16(0xFFFF)
    for _ in range(n_bytes):
        init = _s_apply(init)
    const_init = int(init)

    s_cols = _matrix_of(_s_apply)
    s_inv = _gf2_invert(s_cols)
    n_levels = max(1, int(n_bytes).bit_length())
    inv_pows = np.zeros((n_levels, 16), dtype=np.uint16)
    cur = s_inv
    for lvl in range(n_levels):
        inv_pows[lvl] = cur
        cur = np.array([_apply_cols(cur, np.uint16(c)) for c in cur], dtype=np.uint16)
    return m, const_init, inv_pows


def crc16_padded_jax(byte_rows, lengths, n_bytes: int):
    """CRC16 of `lengths[i]` leading bytes of each row of a zero-padded
    [F, n_bytes] uint8 array, on device.  Rows MUST be zero beyond their
    length.  Returns uint16-valued int32 [F]."""
    import jax.numpy as jnp

    bits = jnp.unpackbits(byte_rows, axis=1).astype(jnp.int8)  # [F, n_bytes*8]
    return _crc16_from_bits(bits, lengths, n_bytes)


def crc16_words_jax(word_rows, lengths, n_words: int):
    """Same as crc16_padded_jax but over big-endian u32 word rows [F, W]
    (the packed payload), avoiding a device-side byte expansion."""
    import jax.numpy as jnp

    shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    bits = ((word_rows[:, :, None] >> shifts) & 1).astype(jnp.int8)
    bits = bits.reshape(word_rows.shape[0], n_words * 32)
    return _crc16_from_bits(bits, lengths, n_words * 4)


def _crc16_from_bits(bits, lengths, n_bytes: int):
    import jax.numpy as jnp

    m, const_init, inv_pows = crc_matmul_consts(n_bytes)
    planes = jnp.matmul(bits, jnp.asarray(m), preferred_element_type=jnp.int32) & 1
    return _crc16_finish(planes, lengths, const_init, inv_pows, n_bytes)


def _crc16_finish(planes, lengths, const_init, inv_pows, n_bytes: int):
    import jax.numpy as jnp
    weights = (1 << jnp.arange(16, dtype=jnp.int32))[None, :]
    crc = jnp.sum(planes * weights, axis=1).astype(jnp.int32) ^ const_init
    # Undo the trailing zero padding: apply S^(-z), z = n_bytes - length.
    z = (jnp.int32(n_bytes) - lengths.astype(jnp.int32)).astype(jnp.int32)
    for lvl in range(inv_pows.shape[0]):
        bit = (z >> lvl) & 1
        applied = _apply_cols(inv_pows[lvl], crc)
        crc = jnp.where(bit == 1, applied, crc)
    return crc & 0xFFFF
