"""Streaming encode with bounded memory (the IterChannel equivalent).

The reference bounds memory by pulling one frame at a time from a lazy
sample iterator (x3::IterChannel, x3.rs:47-69; encoder.rs:67-74).  The device
pipeline wants large batches instead, so the streaming encoder buffers up to
`batch_frames` whole frames (default 256 frames = 2.56 M samples ≈ 5 MB),
encodes them in one device call, and appends the resulting frame stream to
the output — memory stays bounded by the batch size regardless of input
length.  Only the final flush may emit a partial frame, matching the
reference's framing exactly.

Also here: multi-channel convenience encoding.  The format is mono-only
(error.rs MoreThanOneChannel), so a [C, n] capture becomes C independent
archives — but all channels' frames ride in the same device batches, which
is exactly the batched-multi-file shape (BASELINE.json config 5: streaming
multi-channel 96 kHz hydrophone encode)."""

from __future__ import annotations

import wave

import numpy as np

from . import archive
from .models.encoder import EncodeResult, encode
from .params import Parameters


class StreamEncoder:
    """Incremental encoder: feed chunks of int16 samples, frames stream out.

    Usage:
        enc = StreamEncoder(out_file, sample_rate=96000)
        for chunk in source:
            enc.write(chunk)
        stats = enc.close()
    """

    def __init__(
        self,
        out_file,
        sample_rate: int,
        params: Parameters | None = None,
        engine: str = "jax",
        batch_frames: int = 256,
        write_archive_header: bool = True,
    ):
        self.params = params or Parameters()
        self.engine = engine
        self.batch_frames = batch_frames
        self._spf = self.params.samples_per_frame
        self._buffer = np.zeros(0, dtype=np.int16)
        self._stats = np.zeros(6, dtype=np.int64)
        self._nbytes = 0
        self._closed = False
        self._own_file = isinstance(out_file, (str, bytes)) or hasattr(out_file, "__fspath__")
        if self._own_file:
            from .utils.io import open_overwrite

            self._f = open_overwrite(out_file)  # truncated to size in close()
        else:
            self._f = out_file
        # Owned files write through a bounded background thread so the next
        # batch's encode overlaps file I/O where a spare core or a blocking
        # disk exists (utils/io.py); caller-supplied writers keep
        # synchronous semantics.
        if self._own_file:
            from .utils.io import AsyncWriter

            self._w = AsyncWriter(self._f)
        else:
            self._w = self._f
        self._width_hint: int | None = None  # adaptive rungs carried across batches
        self._block_width_hint: int | None = None
        if write_archive_header:
            self._w.write(archive.build_archive_header(sample_rate, self.params))

    def write(self, samples) -> None:
        if self._closed:
            raise ValueError("StreamEncoder is closed")
        samples = np.ascontiguousarray(samples, dtype=np.int16)
        self._buffer = np.concatenate([self._buffer, samples]) if len(self._buffer) else samples
        batch_samples = self.batch_frames * self._spf
        while len(self._buffer) >= batch_samples:
            head, self._buffer = self._buffer[:batch_samples], self._buffer[batch_samples:]
            self._emit(head)

    def _emit(self, samples: np.ndarray) -> None:
        res = encode(
            samples,
            self.params,
            engine=self.engine,
            batch_frames=self.batch_frames,
            width_hint=self._width_hint,
            block_width_hint=self._block_width_hint,
        )
        if res.width_used is not None:
            self._width_hint = res.width_used
        if res.block_width_used is not None:
            self._block_width_hint = res.block_width_used
        self._stats += res.stats
        self._nbytes += len(res.data)
        self._w.write(res.data)

    def close(self) -> EncodeResult:
        """Flush the tail (may include one partial frame) and return stats."""
        if self._closed:
            return EncodeResult(b"", self._stats, nbytes=self._nbytes)
        if len(self._buffer):
            self._emit(self._buffer)
            self._buffer = np.zeros(0, dtype=np.int16)
        self._closed = True
        if self._own_file:
            self._w.close()  # drain; re-raises any background write error
            self._f.truncate()  # cut any stale tail from a longer previous file
            self._f.close()
        return EncodeResult(b"", self._stats, nbytes=self._nbytes)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wav_to_x3a_streaming(
    wav_filename,
    x3a_filename,
    params: Parameters | None = None,
    engine: str = "jax",
    batch_frames: int = 256,
) -> np.ndarray:
    """Bounded-memory file conversion: reads the WAV in batch-sized chunks.

    Functionally identical output to files.wav_to_x3a (which loads the whole
    file); memory is bounded by batch_frames frames."""
    params = params or Parameters()
    with wave.open(str(wav_filename), "rb") as w:
        assert w.getsampwidth() == 2 and w.getnchannels() == 1
        rate = w.getframerate()
        with StreamEncoder(x3a_filename, rate, params, engine, batch_frames) as enc:
            chunk_samples = batch_frames * params.samples_per_frame
            while True:
                raw = w.readframes(chunk_samples)
                if not raw:
                    break
                enc.write(np.frombuffer(raw, dtype="<i2"))
            return enc.close().stats


def encode_channels(samples_2d, params: Parameters | None = None, mesh=None):
    """Encode a [C, n] multi-channel capture into C independent frame
    streams, all channels' frames sharing device batches.  Returns a list
    of EncodeResult (one per channel)."""
    from .multifile import encode_streams

    samples_2d = np.atleast_2d(np.asarray(samples_2d, dtype=np.int16))
    return encode_streams(list(samples_2d), params, mesh=mesh)
