"""Frame-parallel device decode pipeline (plain jax.numpy/lax, no kernel).

The reference decoder walks the bitstream sample-by-sample in scalar Rust
(/root/reference/src/decoder.rs:36-235 over the BitReader word cache,
bitreader.rs:64-176).  Bit positions are inherently sequential *within* a
frame (every code's start depends on all previous code lengths), but frames
are self-contained — each carries its own raw first sample and CRC-delimited
payload (SURVEY.md §5 "checkpoint/resume") — so the frame axis is the
parallel axis: all lanes of a [F] batch step through their bitstreams in
lockstep, every per-sample operation a branch-free vector op across frames.

Structure: the walk is a `lax.scan` whose every step needs a data-dependent
gather (its indices come from the previous step's decode), so the scan
minimizes dependent gathers per block:

* processes U blocks per scan step with ONE shared K*G-word slice gather
  (U*MAXADV words of worst-case advance fit in the gathered window), cutting
  dependent-DMA steps from B to ceil(B/U);
* realigns each block's WIN-word window out of the gathered buffer with a
  log-depth barrel shifter (binary select stages), not an O(G) select chain;
* extracts each code's 32-bit view with a barrel pick of 2 words whose
  select depth is bounded per unrolled sample k (sample k of a block cannot
  start more than (37+16k)/32 words in — codes are <= 16 bits);
* keeps per-step state small so wide batches (F = 2048+) amortize the
  remaining fixed step cost.

The sample walk is unrolled for block_len <= 24 and a rolling-register
lax.scan beyond that (compile cost O(1) in block_len).  Block outputs stack
via scan ys; flattening them yields the sample stream directly because every
block occupies exactly `block_len` slots.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..params import Parameters
from .encode_kernel import block_buffer_words, frame_geometry, frame_geometry_blocks

# Per-frame decode error codes (parity with the reference's X3Error variants,
# error.rs:27-62): 0 ok, 1 invalid BFP (num_bits<=5, decoder.rs:209-212),
# 2 out-of-bounds inverse (decoder.rs:162-192), 3 bitstream overran the
# payload (unexpected end).  Host mapping lives in errors.decode_error().
ERR_OK = 0
ERR_INVALID_BPF = 1
ERR_OOB_INVERSE = 2
ERR_OVERRUN = 3

# Chunked-gather geometry: G-word slice granularity, K slices per gather,
# U blocks walked per dependent gather.  XLA:CPU compile time explodes on
# wide-chunk traces once the block count is non-trivial (measured: L=1/U=7
# at B=96 blocks exceeds 100 s of fresh compile while U=1 takes 0.9 s;
# default L=20/U=1 at B=500 is ~4 s), so the CPU config runs one block per
# step except for tiny geometries, which keep U > 1 so the chunked code
# path stays CPU-tested.  Correctness is config-independent: all configs
# are bit-exact.
#
# GPU: _GPU_GATHER = (G, U or None for the widest U the window allows).
# Measured on an NVIDIA H100 80GB HBM3 at its 700 W power limit (decode
# F=6144 hydrophone frames at the 2048-word rung, tools/geometry_ab.py):
# (64, widest U = 4) 10.39 ms, (64, 1) 30.91 ms, (16, 1) 27.56 ms of device
# time; cold compile 39.0 s, 11.9 s and 11.7 s.  The scan is step-bound
# there, so fewer, wider steps win despite the longer compile.
_GPU_GATHER = (64, None)


def _gather_geometry(L: int, WIN: int, B: int) -> tuple[int, int, int]:
    """(G, K, U) for the current backend.

    Constraint: the first block may start G-1 words into the gathered K*G
    window, each block advances at most MAXADV words, and every block needs
    WIN words of lookahead: (G-1) + U*MAXADV + WIN <= K*G."""
    maxadv = (6 + 16 * L + 31) // 32 + 1
    cpu = jax.default_backend() == "cpu"
    G, u_pin = (16, None) if cpu else _GPU_GATHER
    K = max(2, -(-(G - 1 + WIN + maxadv) // G))
    U = max(1, (K * G - G + 1 - WIN) // maxadv)
    if cpu and not (B <= 32 and L <= 8):
        U = 1
    if u_pin is not None:
        U = min(U, u_pin)
    return G, K, max(1, min(U, B))  # more blocks per step than a frame has is dead work


def _decode_tables(params: Parameters):
    """Per-ftype (1..3) nsubs and inv_len from the selected Rice codes."""
    nsubs = np.zeros(4, dtype=np.int32)
    invlen = np.zeros(4, dtype=np.int32)
    for f in (1, 2, 3):
        rc = params.rice_codes[f - 1]
        nsubs[f] = rc.nsubs
        invlen[f] = rc.inv_len
    return nsubs, invlen


def _wrap16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _inv_rice(i):
    """Closed form of the shared inverse Rice table 0,-1,1,-2,2,...
    (x3.rs:200-204): inv(i) = (i+1)>>1 negated when i is odd."""
    half = (i + 1) >> 1
    return jnp.where((i & 1) == 1, -half, half)


def _barrel(cur: list, idx, nout: int, maxidx: int) -> list:
    """[cur[idx+i] for i in range(nout)] via log-depth binary select stages.

    cur: list of [F] arrays; idx: [F] int32 in [0, maxidx] (entries past
    len(cur) read as zero).  Total selects ~ maxidx + nout*log2(maxidx),
    depth log2(maxidx) — vs an O(maxidx*nout) chain with depth maxidx."""
    if maxidx <= 0:
        return [cur[i] if i < len(cur) else jnp.zeros_like(cur[0]) for i in range(nout)]
    zero = jnp.zeros_like(cur[0])
    sh = 1
    stages = []
    while sh <= maxidx:
        stages.append(sh)
        sh <<= 1
    for sh in reversed(stages):
        bit = (idx & sh) != 0
        keep = min(len(cur), nout + sh - 1)
        cur = [
            jnp.where(bit, cur[i + sh] if i + sh < len(cur) else zero, cur[i])
            for i in range(keep)
        ]
    return [cur[i] if i < len(cur) else zero for i in range(nout)]


@functools.partial(jax.jit, static_argnums=(3, 4))
def decode_frames_checked(payload: jax.Array, n_samples: jax.Array, payload_lens: jax.Array, params: Parameters, n_blocks: int | None = None):
    """decode_frames plus device-side payload CRC16 (the batched integrity
    check of SURVEY.md §5): returns (samples, err, crc int32 [F]).  The CRC
    is a GF(2) matmul over the words the decoder already built, so the
    file pipeline needs no host CRC pass at all."""
    from .crc_jax import crc16_words_jax

    W = payload.shape[1] // 4  # matches _decode_impl's inferred width
    out, err, words = _decode_impl(payload, n_samples, payload_lens, params, n_blocks)
    crc = crc16_words_jax(words, payload_lens.astype(jnp.int32), W)
    return out, err, crc.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(3, 4))
def decode_frames(payload: jax.Array, n_samples: jax.Array, payload_lens: jax.Array, params: Parameters, n_blocks: int | None = None):
    """Decode a batch of frame payloads.

    payload: uint8 [F, W*4] zero-padded payload bytes.  W is inferred from
        the buffer width and may be NARROWER than frame_geometry's
        worst-case width when every payload fits (payload lengths are known
        before decode, so callers pick a compact rung — see
        models/decoder.decode_frames_batch; bucket widths via
        encode_kernel.width_rungs to bound the compile cache).  Semantics
        are width-independent: reads past the buffer see zeros exactly like
        the zero-padded tail of the full-width buffer, and the overrun
        check uses the format's worst-case width.
    n_samples: int32 [F] — sample count per frame (0 = dummy lane)
    payload_lens: int32 [F] — actual payload byte length per frame; unary
        zero counts cap at the payload end exactly like the reference's
        BitReader (bitreader.rs:129-139), which is observable on corrupt
        streams whose last run reaches the end of the data.
    n_blocks: static block-walk count override (None = blocks_per_frame).
        The reference walks `min(remaining, block_len)`-sample blocks off
        the caller's sample count alone (decoder.rs:36-58), so frames may
        legally exceed params.samples_per_frame (blocks_per_frame is not in
        the archive XML, decodefile.rs:295-300).  Callers bucket via
        models/decoder.decode_geometry to bound the compile cache.
    Returns (samples int16 [F, S], err int32 [F] — ERR_* codes, 0 = ok)
    where S = 1 + n_blocks*L when overridden."""
    out, err, _ = _decode_impl(payload, n_samples, payload_lens, params, n_blocks)
    return out, err


def _decode_impl(payload: jax.Array, n_samples: jax.Array, payload_lens: jax.Array, params: Parameters, n_blocks: int | None = None):
    if n_blocks is None:
        S, B, L, WFULL = frame_geometry(params)
    else:
        S, B, L, WFULL = frame_geometry_blocks(params, n_blocks)
    W = payload.shape[1] // 4  # compact width rung (<= WFULL) or full
    WIN = block_buffer_words(params)  # covers any block + start skew
    F = payload.shape[0]
    nsubs_np, invlen_np = _decode_tables(params)
    G, K, U = _gather_geometry(L, WIN, B)
    steps = -(-B // U)
    gbits = G.bit_length() - 1

    # Big-endian word build from byte PLANES: slicing the u8 buffer and
    # converting per plane fuses into one pass, where the naive
    # payload.astype(u32) materializes a u32 per BYTE plus a strided
    # or-fusion.
    by = payload.reshape(F, W, 4)
    words = (
        (by[:, :, 0].astype(jnp.uint32) << 24)
        | (by[:, :, 1].astype(jnp.uint32) << 16)
        | (by[:, :, 2].astype(jnp.uint32) << 8)
        | by[:, :, 3].astype(jnp.uint32)
    )

    n = n_samples.astype(jnp.int32)
    plen8 = payload_lens.astype(jnp.int32) * 8  # data end in bits (cap for unary runs)
    first = _wrap16(((words[:, 0] >> 16) & 0xFFFF).astype(jnp.int32))

    # Zero-pad so any clamped slice index stays in range; zeros decode as
    # end-of-data (matching the BitReader's tail-zero semantics).
    pad_w = K * G + (-(W + K * G)) % G
    wpad = jnp.concatenate([words, jnp.zeros((F, pad_w), jnp.uint32)], axis=1)
    Wg = (W + pad_w) // G
    wg = wpad.reshape(F, Wg, G)
    slice_iota = jnp.arange(K, dtype=jnp.int32)[None, :]

    def chunk_body(carry, j):
        off, last, err, obuf = carry
        # ONE dependent gather per U blocks: K contiguous G-word slices.
        sw0 = jnp.clip(off >> 5, 0, W - 1)
        q = jnp.clip(sw0 >> gbits, 0, Wg - K)
        raw = jnp.take_along_axis(wg, (q[:, None] + slice_iota)[:, :, None], axis=1)
        rawl = [r for r in jnp.moveaxis(raw.reshape(F, K * G), 1, 0)]
        base_word = q << gbits

        blks = []
        for u in range(U):
            b = j * U + u
            block_first = 1 + b * L
            valid_block = block_first < n

            # Realign this block's WIN-word window out of the gathered
            # buffer (log-depth barrel; delta clamp keeps garbage lanes in
            # range — they are error-flagged anyway).
            sw = jnp.clip(off >> 5, 0, W - 1)
            delta = jnp.clip(sw - base_word, 0, K * G - WIN)
            winl = _barrel(rawl, delta, WIN, K * G - WIN)
            rel = off - ((base_word + delta) << 5)

            def extract32(rel, kmax=None):
                """32-bit big-endian view at in-window bit offset rel.
                kmax statically bounds the word index: sample k starts at
                most (37 + 16k) bits in, so early samples need only a
                1-2 deep barrel."""
                qq = rel >> 5
                r = (rel & 31).astype(jnp.uint32)
                hi = WIN - 1 if kmax is None else min(WIN - 1, kmax)
                w0, w1 = _barrel(winl, qq, 2, hi)
                return (w0 << r) | ((w1 >> (31 - r)) >> 1)

            hdr = extract32(rel, kmax=1)  # block header: rel <= 31
            ftype = (hdr >> 30).astype(jnp.int32)
            dec_nb = ((hdr >> 26) & 0xF).astype(jnp.int32) + 1
            is_hdr0 = ftype == 0
            is_pass = is_hdr0 & (dec_nb == 16)
            bpf_err = valid_block & is_hdr0 & (dec_nb <= 5)
            rel = rel + jnp.where(is_hdr0, constants.BFP_HDR_LEN, constants.RICE_HDR_LEN)

            # Per-ftype constants via small selects (params are static).
            nsubs_f = jnp.where(ftype == 2, int(nsubs_np[2]), int(nsubs_np[3]))
            invlen_f = jnp.where(
                ftype == 1, int(invlen_np[1]), jnp.where(ftype == 2, int(invlen_np[2]), int(invlen_np[3]))
            )
            level = (1 << nsubs_f).astype(jnp.int32)
            nbsuf = jnp.where(ftype == 2, 2, 4)  # decoder.rs:180 quirk: hardwired
            dec_nb_u = jnp.clip(dec_nb, 1, 31).astype(jnp.uint32)
            neg_thresh = 1 << jnp.clip(dec_nb - 1, 0, 30)

            def decode_math(win32, last, oob, valid, cap):
                """Branch-free decode of one sample from its 32-bit window.
                Returns (new_sample, consumed_bits, oob flag).  Consumption
                is clamped to 16 bits — no legal code is longer (Rice worst
                case 15 zeros + stop; BFP/literal <= 16), and the clamp
                bounds garbage lanes' window advance (they are flagged).
                `cap` is the bits remaining to the payload end: unary zero
                counts stop there like the reference's BitReader
                (bitreader.rs:129-139)."""
                zeros = jnp.minimum(jax.lax.clz(win32).astype(jnp.int32), jnp.maximum(cap, 0))
                zc = jnp.clip(zeros, 0, 31).astype(jnp.uint32)

                # Rice ftype 1: unary index + stop bit (decoder.rs:147-170)
                # Rice ftype 2/3: unary + suffix (decoder.rs:172-196)
                suffix = ((win32 << zc) >> (32 - nbsuf.astype(jnp.uint32))).astype(jnp.int32)
                idx = jnp.where(ftype == 1, zeros, suffix + level * (zeros - 1))
                is_rice = ftype >= 1
                oob = oob | (valid & is_rice & ((idx < 0) | (idx >= invlen_f)))
                delta_rice = _inv_rice(jnp.clip(idx, 0, 59))

                # BFP / pass-through: fixed dec_nb-bit field (decoder.rs:209-235)
                a = (win32 >> (32 - dec_nb_u)).astype(jnp.int32)
                delta_bfp = a - jnp.where(a > neg_thresh, neg_thresh * 2, 0)
                v_pass = _wrap16((win32 >> 16).astype(jnp.int32))

                delta = jnp.where(is_rice, delta_rice, delta_bfp)
                new = jnp.where(is_pass, v_pass, _wrap16(last + delta))
                consume = jnp.where(
                    ftype == 1, zeros + 1, jnp.where(is_rice, zeros + nbsuf, dec_nb)
                )
                consume = jnp.minimum(consume, 16)
                return new, consume, oob

            oob = jnp.zeros_like(valid_block)
            rel_end = plen8 - ((base_word + delta) << 5)  # data end in window bits
            if L <= 24:
                # Small blocks (incl. the default 20): fully unrolled; each
                # sample extracts its window independently — short
                # dependency chains, everything fuses.
                outs = []
                for k in range(L):
                    valid = valid_block & ((block_first + k) < n)
                    win32 = extract32(rel, kmax=(37 + 16 * k) >> 5)
                    new, consume, oob = decode_math(win32, last, oob, valid, rel_end - rel)
                    rel = rel + jnp.where(valid, consume, 0)
                    last = jnp.where(valid, new, last)
                    outs.append(new)
                blk = jnp.stack(outs, axis=1)  # [F, L]
            else:
                # Large blocks: a rolling 64-bit register window inside
                # lax.scan keeps the trace (and compile time) O(1) in
                # block_len.
                widx = rel >> 5
                r = rel & 31
                (w0,) = _barrel(winl, widx, 1, WIN - 1)
                (w1,) = _barrel(winl, widx + 1, 1, WIN - 1)

                def sample_step(state, k):
                    widx, r, w0, w1, last, oob = state
                    valid = valid_block & ((block_first + k) < n)
                    ru = r.astype(jnp.uint32)
                    win32 = (w0 << ru) | ((w1 >> (31 - ru)) >> 1)
                    cap = rel_end - ((widx << 5) + r)
                    new, consume, oob = decode_math(win32, last, oob, valid, cap)
                    r = r + jnp.where(valid, consume, 0)
                    carry_w = r >= 32
                    r = r - jnp.where(carry_w, 32, 0)
                    w0 = jnp.where(carry_w, w1, w0)
                    # widx+2 may step past the window at the block tail; the
                    # clamp + maxidx=WIN makes the refill read zero there
                    # instead of wrapping onto a lower barrel stage.
                    (wnext,) = _barrel(winl, jnp.minimum(widx + 2, WIN), 1, WIN)
                    w1 = jnp.where(carry_w, wnext, w1)
                    widx = widx + carry_w.astype(jnp.int32)
                    last = jnp.where(valid, new, last)
                    return (widx, r, w0, w1, last, oob), new

                state = (widx, r, w0, w1, last, oob)
                state, souts = jax.lax.scan(sample_step, state, jnp.arange(L, dtype=jnp.int32))
                widx, r, w0, w1, last, oob = state
                blk = jnp.transpose(souts, (1, 0))
                rel = (widx << 5) + r

            off = ((base_word + delta) << 5) + rel
            # First error wins (reference decode stops at the first bad
            # block, decodefile.rs:128-135); BFP-header and Rice-OOB errors
            # are mutually exclusive within one block, so this is exact.
            blk_code = jnp.where(bpf_err, ERR_INVALID_BPF, jnp.where(oob, ERR_OOB_INVERSE, ERR_OK))
            err = jnp.where(err != ERR_OK, err, blk_code)
            blks.append(blk)
        # Write this chunk's samples straight into the output carry (slot
        # b*L+k is sample 1 + b*L + k, so the stream starts at column 1
        # after the raw first sample).  The in-place dynamic_update_slice
        # replaces a stacked-ys epilogue's [steps, F, U*L] transpose +
        # concat + s32->s16 convert.
        chunk = jnp.concatenate(blks, axis=1).astype(jnp.int16)  # [F, U*L]
        obuf = jax.lax.dynamic_update_slice(obuf, chunk, (jnp.int32(0), 1 + j * (U * L)))
        return (off, last, err, obuf), None

    off0 = n * 0 + 16  # bitstream starts after the raw first sample
    err0 = jnp.zeros_like(n)
    obuf0 = jnp.zeros((F, 1 + steps * U * L), jnp.int16).at[:, 0].set(first.astype(jnp.int16))
    (off, last, err, obuf), _ = jax.lax.scan(
        chunk_body, (off0, first, err0, obuf0), jnp.arange(steps, dtype=jnp.int32)
    )
    out = obuf[:, :S]
    # Overrun threshold uses the format's worst-case width so the verdict
    # is identical at every compact rung.
    err = jnp.where(err != ERR_OK, err, jnp.where(off > jnp.int32(WFULL * 32), ERR_OVERRUN, ERR_OK))
    return out, err, words
