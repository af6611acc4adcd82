"""Multi-device scale-out over a device mesh.

The reference is single-threaded (SURVEY.md §2 "parallelism inventory"); the
format's latent parallel structure — self-contained frames — is what this
module promotes to the multi-device axis.  Frames (and whole files) are
embarrassingly parallel, so the mapping is data parallelism over a 1-D mesh
with `shard_map`: each device encodes/decodes its shard of frames with zero
inter-device communication inside the codec.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import Parameters

AXIS = "frames"


def make_mesh(devices=None, axis_name: str = AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def encode_frames_sharded(samples, n_valid, params: Parameters, mesh: Mesh, w_words: int | None = None, nw_words: int | None = None):
    """Encode a [F, S] batch sharded across the mesh's frame axis.

    F must be divisible by the mesh size.  Each device runs the single-device
    pipeline on its local shard — no collectives (frames are independent).
    w_words/nw_words: adaptive rung specializations (encode_frames)."""
    samples = jax.device_put(samples, NamedSharding(mesh, P(AXIS, None)))
    n_valid = jax.device_put(n_valid, NamedSharding(mesh, P(AXIS)))
    return _encode_fn(params, mesh, w_words, nw_words)(samples, n_valid)


@functools.lru_cache(maxsize=64)
def _encode_fn(params: Parameters, mesh: Mesh, w_words, nw_words):
    """The jitted sharded encode, built once per specialization (a fresh
    shard_map per call would be traced again on every batch)."""
    from ..ops.encode_kernel import encode_frames

    def local(s, n):
        return encode_frames(s, n, params, "block", w_words, nw_words)

    return jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS)),
        out_specs={
            "payload_words": P(AXIS, None),
            "nbytes": P(AXIS),
            "crc": P(AXIS),
            "stats": P(AXIS, None),
            "total_bits": P(AXIS),
            "blockfit_bits": P(AXIS),
        },
    ))


def decode_frames_sharded(payload, n_samples, payload_lens, params: Parameters, mesh: Mesh, n_blocks: int | None = None):
    """Decode a [F, W*4] payload batch sharded across the mesh's frame axis."""
    payload = jax.device_put(payload, NamedSharding(mesh, P(AXIS, None)))
    n_samples = jax.device_put(n_samples, NamedSharding(mesh, P(AXIS)))
    payload_lens = jax.device_put(payload_lens, NamedSharding(mesh, P(AXIS)))
    return _decode_fn(params, mesh, n_blocks)(payload, n_samples, payload_lens)


@functools.lru_cache(maxsize=64)
def _decode_fn(params: Parameters, mesh: Mesh, n_blocks):
    from ..ops.decode_kernel import decode_frames

    def local(p, n, pl):
        return decode_frames(p, n, pl, params, n_blocks)

    return jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS, None), P(AXIS)),
    ))


def _words_to_bytes(words):
    """Device-side big-endian byte expansion of packed payload words."""
    import jax.numpy as jnp

    f, w = words.shape
    shifts = jnp.asarray([24, 16, 8, 0], dtype=jnp.uint32)
    return ((words[:, :, None] >> shifts[None, None, :]) & 0xFF).astype(jnp.uint8).reshape(f, w * 4)


def roundtrip_step(params: Parameters, mesh: Mesh):
    """The full sharded pipeline step (encode -> decode -> verify) as one
    jittable function over the mesh; used by the multi-device dry run."""
    from ..ops.decode_kernel import decode_frames
    from ..ops.encode_kernel import encode_frames

    def local(s, n):
        enc = encode_frames(s, n, params)
        payload_bytes = _words_to_bytes(enc["payload_words"])
        dec, err = decode_frames(payload_bytes, n, enc["nbytes"], params)
        import jax.numpy as jnp

        idx = jax.lax.broadcasted_iota(jnp.int32, dec.shape, 1)
        valid = idx < n[:, None]
        exact = jnp.all(jnp.where(valid, dec == s.astype(jnp.int16), True))
        local_ok = (exact & ~err.any()).astype(jnp.int32)
        # One collective makes the verdict replicated across the mesh.
        return enc["nbytes"], jax.lax.psum(local_ok, AXIS) == jax.lax.axis_size(AXIS)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS)),
            out_specs=(P(AXIS), P()),
        )
    )
