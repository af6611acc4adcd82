"""Batched JAX encode pipeline vs the oracle: bit-exact on every signal class."""

import numpy as np
import pytest

from tests.conftest import make_hydrophone, make_mixed
from x3_tpu.models import oracle
from x3_tpu.models.encoder import encode
from x3_tpu.params import Parameters

P = Parameters()


def oracle_stream(wav):
    st = [0] * 6
    data = oracle.encode(wav, P, st)
    return data, np.asarray(st)


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 9_999, 10_000, 10_001, 25_000])
def test_jax_encode_matches_oracle_hydrophone(rng, n):
    wav = make_hydrophone(rng, n)
    want, want_stats = oracle_stream(wav)
    got = encode(wav, P, engine="jax", batch_frames=4)
    assert got.data == want
    np.testing.assert_array_equal(got.stats, want_stats)


def test_jax_encode_matches_oracle_mixed(rng):
    wav = make_mixed(rng, 34_567)
    want, want_stats = oracle_stream(wav)
    got = encode(wav, P, engine="jax", batch_frames=2)
    assert got.data == want
    np.testing.assert_array_equal(got.stats, want_stats)


def test_jax_encode_white_noise_passthrough(rng):
    wav = rng.integers(-32768, 32768, 12_345).astype(np.int16)
    want, _ = oracle_stream(wav)
    got = encode(wav, P, engine="jax", batch_frames=2)
    assert got.data == want


def test_jax_encode_silence(rng):
    wav = np.zeros(20_000, dtype=np.int16)
    want, _ = oracle_stream(wav)
    got = encode(wav, P, engine="jax", batch_frames=2)
    assert got.data == want


def test_jax_encode_golden_frame(golden):
    want = oracle.encode(golden["frame_wav"], P)
    got = encode(golden["frame_wav"], P, engine="jax", batch_frames=1)
    assert got.data == want


def test_jax_encode_empty():
    got = encode(np.array([], dtype=np.int16), P)
    assert got.data == b""


def test_numpy_engine_matches():
    wav = np.arange(-500, 500, dtype=np.int16)
    assert encode(wav, P, engine="numpy").data == oracle.encode(wav, P)


def test_pack_modes_agree(rng):
    """block-buffer pack vs segment-sum pack: identical words on tough input."""
    from x3_tpu.ops.encode_kernel import encode_frames

    wav = make_mixed(rng, 40_000)
    frames = wav[: 40_000 - (40_000 % 10_000)].reshape(-1, 10_000)
    nv = np.full(frames.shape[0], 10_000, np.int32)
    a = encode_frames(frames, nv, P, "block")
    b = encode_frames(frames, nv, P, "segment")
    np.testing.assert_array_equal(np.asarray(a["payload_words"]), np.asarray(b["payload_words"]))
    np.testing.assert_array_equal(np.asarray(a["nbytes"]), np.asarray(b["nbytes"]))
    np.testing.assert_array_equal(np.asarray(a["crc"]), np.asarray(b["crc"]))


def test_rice_closed_form_matches_tables():
    """Closed-form rice codes equal the normative tables at every index."""
    import jax.numpy as jnp

    from x3_tpu.constants import RICE_CODES
    from x3_tpu.ops.encode_kernel import rice_code_closed_form

    for order, rc in enumerate(RICE_CODES):
        n = len(rc.code)
        d = np.arange(n) - rc.offset
        code, bits = rice_code_closed_form(jnp.asarray(d), order)
        np.testing.assert_array_equal(np.asarray(code), rc.code, err_msg=f"code order {order}")
        np.testing.assert_array_equal(np.asarray(bits), rc.num_bits, err_msg=f"bits order {order}")


def test_compact_width_rung_bit_exact(rng):
    """A compact w_words specialization produces the identical payload
    (prefix words, nbytes, crc, stats) whenever the frames fit it."""
    from x3_tpu.ops.encode_kernel import encode_frames, fits_width, width_rungs

    wav = make_hydrophone(rng, 40_000)
    frames = wav.reshape(-1, 10_000)
    nv = np.full(frames.shape[0], 10_000, np.int32)
    rungs = width_rungs(P)
    assert rungs[-1] > rungs[0] and len(rungs) >= 2
    full = encode_frames(frames, nv, P, "block")
    # smallest rung this corpus fits (finer rungs exist for more
    # compressible classes and legitimately do not hold hydrophone frames)
    w = next(r for r in rungs if fits_width(np.asarray(full["nbytes"]), r, P))
    assert w < rungs[-1]
    compact = encode_frames(frames, nv, P, "block", w)
    assert fits_width(np.asarray(compact["nbytes"]), w, P)
    np.testing.assert_array_equal(
        np.asarray(compact["payload_words"]), np.asarray(full["payload_words"])[:, :w]
    )
    for k in ["nbytes", "crc", "stats", "total_bits"]:
        np.testing.assert_array_equal(np.asarray(compact[k]), np.asarray(full[k]), err_msg=k)


def test_compact_width_overflow_detected_and_isolated(rng):
    """Incompressible frames overflow the compact rung: fits_width flags the
    batch, nbytes stays correct, and neighbouring frames' words are
    untouched (the clip keeps the overflow inside its own buffer)."""
    from x3_tpu.ops.encode_kernel import encode_frames, fits_width, width_rungs

    rungs = width_rungs(P)
    noise = rng.integers(-32768, 32768, 10_000).astype(np.int16)
    quiet = make_hydrophone(rng, 10_000)
    frames = np.stack([quiet, noise, quiet])
    nv = np.full(3, 10_000, np.int32)
    full = encode_frames(frames, nv, P, "block")
    compact = encode_frames(frames, nv, P, "block", rungs[0])
    nb = np.asarray(compact["nbytes"])
    assert not fits_width(nb, rungs[0], P)
    np.testing.assert_array_equal(nb, np.asarray(full["nbytes"]))
    # frames that individually fit are still bit-exact at the compact rung
    w = rungs[0]
    fw = np.asarray(full["payload_words"])
    cw = np.asarray(compact["payload_words"])
    np.testing.assert_array_equal(cw[0], fw[0, :w])
    np.testing.assert_array_equal(cw[2], fw[2, :w])


def test_adaptive_encode_escalates_and_matches_oracle(rng):
    """End-to-end encode() over mixed compressible/incompressible content:
    the adaptive ladder escalates mid-stream and output stays byte-exact."""
    wav = np.concatenate(
        [
            make_hydrophone(rng, 15_000),
            rng.integers(-32768, 32768, 15_000).astype(np.int16),
            make_hydrophone(rng, 5_000),
        ]
    )
    want, _ = oracle_stream(wav)
    got = encode(wav, P, engine="jax", batch_frames=2)
    assert got.data == want
    assert got.width_used is not None


def test_stream_encoder_carries_width_hint(rng, tmp_path):
    """StreamEncoder remembers the escalated rung across batches."""
    import io

    from x3_tpu.ops.encode_kernel import block_width_rungs, width_rungs
    from x3_tpu.streaming import StreamEncoder

    rungs = width_rungs(P)
    nw_rungs = block_width_rungs(P)
    noise = rng.integers(-32768, 32768, 20_000).astype(np.int16)
    buf = io.BytesIO()
    enc = StreamEncoder(buf, 96000, P, batch_frames=1)
    enc.write(noise)
    assert enc._width_hint == rungs[-1]
    assert enc._block_width_hint == nw_rungs[-1]
    enc.write(make_hydrophone(rng, 10_000))
    enc.close()
    assert enc._width_hint == rungs[-1]  # sticky within the stream
    assert enc._block_width_hint == nw_rungs[-1]


def test_compact_block_width_rung_bit_exact(rng):
    """A compact nw_words (block-buffer) specialization produces identical
    output whenever every block's r2+bits fit it (fits_block_width)."""
    from x3_tpu.ops.encode_kernel import (
        block_width_rungs,
        encode_frames,
        fits_block_width,
        width_rungs,
    )

    wav = make_hydrophone(rng, 40_000)
    frames = wav.reshape(-1, 10_000)
    nv = np.full(frames.shape[0], 10_000, np.int32)
    nw_rungs = block_width_rungs(P)
    assert nw_rungs[-1] > nw_rungs[0] and len(nw_rungs) >= 2
    probe = encode_frames(frames, nv, P, "block")
    w = next(
        r for r in width_rungs(P) if np.asarray(probe["nbytes"]).max() <= (r - 2) * 4
    )
    # smallest block rung this corpus fits (nw=4 exists for the very
    # compressible class and legitimately does not hold hydrophone blocks)
    nw = next(
        r for r in nw_rungs if fits_block_width(np.asarray(probe["blockfit_bits"]), r, P)
    )
    assert nw < nw_rungs[-1]
    full = encode_frames(frames, nv, P, "block", w)
    compact = encode_frames(frames, nv, P, "block", w, nw)
    assert fits_block_width(np.asarray(compact["blockfit_bits"]), nw, P)
    np.testing.assert_array_equal(
        np.asarray(compact["blockfit_bits"]), np.asarray(full["blockfit_bits"])
    )
    for k in ["payload_words", "nbytes", "crc", "stats", "total_bits"]:
        np.testing.assert_array_equal(np.asarray(compact[k]), np.asarray(full[k]), err_msg=k)


def test_compact_block_width_overflow_detected(rng):
    """Blocks too wide for the compact block buffer are flagged by
    fits_block_width while nbytes/total_bits/blockfit stay correct."""
    from x3_tpu.ops.encode_kernel import (
        block_width_rungs,
        encode_frames,
        fits_block_width,
    )

    nw_rungs = block_width_rungs(P)
    # A BFP-coded burst: diffs ~±2000 (11-bit codes, 20*12+6=246 bits/block
    # + worst-case r2 skew can exceed the compact 13*32=416-bit buffer
    # only with bigger codes, so use ±8000 diffs -> 15-bit literals).
    wav = np.zeros(10_000, np.int16)
    wav[5000:5200] = (rng.integers(0, 2, 200) * 2 - 1).astype(np.int16) * 12000
    frames = wav.reshape(1, -1)
    nv = np.full(1, 10_000, np.int32)
    full = encode_frames(frames, nv, P, "block")
    compact = encode_frames(frames, nv, P, "block", None, nw_rungs[0])
    bf = np.asarray(compact["blockfit_bits"])
    assert not fits_block_width(bf, nw_rungs[0], P)
    assert fits_block_width(bf, nw_rungs[-1], P)
    for k in ["nbytes", "total_bits", "blockfit_bits"]:
        np.testing.assert_array_equal(np.asarray(compact[k]), np.asarray(full[k]), err_msg=k)


def test_adaptive_block_width_escalates_and_matches_oracle(rng):
    """encode() with a mid-stream loud burst escalates the block-buffer rung
    (sticky) and stays byte-exact vs the oracle."""
    quiet = make_hydrophone(rng, 15_000)
    loud = (rng.integers(0, 2, 15_000) * 2 - 1).astype(np.int16) * 12000
    wav = np.concatenate([quiet, loud, make_hydrophone(rng, 5_000)])
    want, _ = oracle_stream(wav)
    got = encode(wav, P, engine="jax", batch_frames=2)
    assert got.data == want
    assert got.block_width_used is not None
