"""Device-path checks that need a GPU.  They skip elsewhere; chip_smoke.py
runs them on the card (`python chip_smoke.py`).

The codec is integer-only, so every comparison is exact.  The two matmuls
(the one-hot int8 merge of the encode pack and the GF(2) CRC) are where
XLA:GPU could hand the work to a library that accumulates in another type;
these tests pin that the results stay exact at real widths."""

import numpy as np
import pytest

from x3_tpu.params import Parameters

P = Parameters()
pytestmark = pytest.mark.gpu


def test_device_is_gpu(gpu):
    assert gpu.platform == "gpu"


def test_crc_matmul_exact_at_full_width(gpu, rng):
    import jax.numpy as jnp

    from x3_tpu.ops.crc import crc16
    from x3_tpu.ops.crc_jax import crc16_words_jax
    from x3_tpu.ops.encode_kernel import frame_geometry

    _, _, _, W = frame_geometry(P)
    F = 64
    rows = rng.integers(0, 256, (F, W * 4)).astype(np.uint8)
    lens = rng.integers(1, W * 2 + 1, F).astype(np.int32) * 2
    for i in range(F):  # rows are zero past their length, as in the pipeline
        rows[i, lens[i] :] = 0
    words = rows.view(">u4").astype(np.uint32)
    got = np.asarray(crc16_words_jax(jnp.asarray(words), jnp.asarray(lens), W))
    want = [crc16(rows[i, : lens[i]].tobytes()) for i in range(F)]
    assert got.tolist() == want


def test_onehot_int8_merge_dot_exact(gpu, rng):
    """The int8 x int8 -> int32 dot of the encode merge at its real shape."""
    import jax

    F, B, WH, K = 8, 500, 651, 76
    onehot = np.zeros((F, B, WH), np.int8)
    onehot[np.arange(F)[:, None], np.arange(B)[None, :], np.sort(rng.integers(0, WH, (F, B)), axis=1)] = 1
    planes = rng.integers(-128, 128, (F, B, K)).astype(np.int8)
    dot = jax.jit(
        lambda a, b: jax.lax.dot_general(
            a, b, (((1,), (1,)), ((0,), (0,))), preferred_element_type=np.int32
        )
    )
    got = np.asarray(dot(onehot, planes))
    want = np.einsum("fbw,fbk->fwk", onehot.astype(np.int32), planes.astype(np.int32))
    np.testing.assert_array_equal(got, want)


def test_decode_uses_gpu_gather_geometry(gpu):
    from x3_tpu.ops import decode_kernel as dk
    from x3_tpu.ops.encode_kernel import block_buffer_words, frame_geometry

    _, B, L, _ = frame_geometry(P)
    G, K, U = dk._gather_geometry(L, block_buffer_words(P), B)
    assert G == dk._GPU_GATHER[0]
    if dk._GPU_GATHER[1] is not None:
        assert U == dk._GPU_GATHER[1]
