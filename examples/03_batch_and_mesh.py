"""Batch-convert many files, optionally sharded across every device."""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from x3_tpu.multifile import wav_to_x3a_batch, x3a_to_wav_batch
from x3_tpu.parallel.mesh import make_mesh
from x3_tpu.utils.wav import write_wav


def main(use_mesh=True):
    rng = np.random.default_rng(2)
    work = Path(tempfile.mkdtemp(prefix="x3_example_"))  # keep cwd clean
    wavs, x3as, backs = [], [], []
    for i in range(8):
        wav = np.clip(np.cumsum(rng.integers(-9, 10, 120_000)), -32768, 32767).astype(np.int16)
        write_wav(str(work / f"batch{i}.wav"), wav, 44_100)
        wavs.append(str(work / f"batch{i}.wav"))
        x3as.append(str(work / f"batch{i}.x3a"))
        backs.append(str(work / f"batch{i}_back.wav"))

    mesh = make_mesh() if use_mesh else None  # frames shard across all devices
    results = wav_to_x3a_batch(wavs, x3as, mesh=mesh)
    counts = x3a_to_wav_batch(x3as, backs, mesh=mesh)
    print("files:", len(results), "samples decoded per file:", counts)


if __name__ == "__main__":
    main()
