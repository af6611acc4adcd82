"""Profiling and observability hooks.

The reference relies on external tooling — `perf` against a debug-symbol
release build plus a PGO pipeline (Cargo.toml:13-17, test/compile-pgo.sh).
The JAX equivalents:

* `trace(logdir)` — JAX profiler trace context (view with XProf/TensorBoard);
* `annotate(name)` — named TraceAnnotation around a region;
* `aot_compile(...)` — ahead-of-time compilation of the pipelines for a
  given batch shape (the PGO/warmup analogue; combined with JAX's
  persistent compilation cache this removes all first-call latency);
* module-level `logger` — the library's logging channel (the reference
  just println!'s; see encoder stats / decodefile prints).
"""

from __future__ import annotations

import contextlib
import logging

logger = logging.getLogger("x3_tpu")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a JAX profiler trace of the enclosed region."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named annotation visible in profiler traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def aot_compile(batch_frames: int, params=None, decode: bool = True):
    """Ahead-of-time compile the encode (and optionally decode) pipelines
    for a given batch size; returns the lowered+compiled executables.

    With JAX_COMPILATION_CACHE_DIR set, the compiled artifacts persist
    across processes — the PGO-build analogue of the reference."""
    import jax
    import numpy as np

    from ..ops.decode_kernel import decode_frames
    from ..ops.encode_kernel import encode_frames, frame_geometry
    from ..params import Parameters

    params = params or Parameters()
    S, B, L, W = frame_geometry(params)
    samples = np.zeros((batch_frames, S), np.int16)
    n_valid = np.zeros(batch_frames, np.int32)
    enc = jax.jit(lambda s, n: encode_frames(s, n, params)).lower(samples, n_valid).compile()
    out = {"encode": enc}
    if decode:
        payload = np.zeros((batch_frames, W * 4), np.uint8)
        dec = (
            jax.jit(lambda p, n, pl: decode_frames(p, n, pl, params))
            .lower(payload, n_valid, n_valid)
            .compile()
        )
        out["decode"] = dec
    logger.info("AOT-compiled pipelines for batch_frames=%d", batch_frames)
    return out
