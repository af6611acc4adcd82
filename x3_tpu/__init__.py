"""x3_tpu — X3 lossless audio codec on JAX/XLA.

A brand-new JAX/XLA implementation of the X3 codec (Shorten-style lossless
compression for low-entropy audio) with the same capabilities and bit-exact
on-the-wire format as the Rust reference `psiphi75/x3-rust`:

* `wav_to_x3a` / `x3a_to_wav` / `X3aReader` — file API (files.py)
* `encode` / `decode_frame` — array API (models/encoder.py, models/decoder.py)
* `python -m x3_tpu` — CLI (cli.py)

The compute path is redesigned for an accelerator: encode is batched tensor
math over [frames, blocks, samples] with prefix-sum bit packing; decode is
frame-parallel with branch-free per-sample steps; CRC16 runs as a GF(2)
matmul.  See SURVEY.md for the full design rationale.
"""

from .params import Parameters, X3aSpec
from .errors import X3Error

__version__ = "0.1.0"

__all__ = [
    "Parameters",
    "X3aSpec",
    "X3Error",
    "Channel",
    "IterChannel",
    "encode",
    "decode_frame",
    "wav_to_x3a",
    "x3a_to_wav",
    "X3aReader",
    "x3a_info",
    "verify_x3a",
    "StreamEncoder",
    "wav_to_x3a_batch",
    "x3a_to_wav_batch",
    "resolve_engine",
]


def __getattr__(name):
    # Lazy imports keep `import x3_tpu` light (no jax import until needed).
    if name in ("wav_to_x3a", "x3a_to_wav", "X3aReader", "x3a_info", "verify_x3a"):
        from . import files

        return getattr(files, name)
    if name == "encode":
        from .models.encoder import encode

        return encode
    if name == "decode_frame":
        from .models.decoder import decode_frame

        return decode_frame
    if name in ("Channel", "IterChannel"):
        from . import channel

        return getattr(channel, name)
    if name == "StreamEncoder":
        from .streaming import StreamEncoder

        return StreamEncoder
    if name in ("wav_to_x3a_batch", "x3a_to_wav_batch"):
        from . import multifile

        return getattr(multifile, name)
    if name == "resolve_engine":
        from .engine import resolve_engine

        return resolve_engine
    raise AttributeError(name)
