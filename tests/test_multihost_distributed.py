"""True multi-process jax.distributed input pipeline: two coordinator-
connected processes each convert their worklist shard with their own local
mesh; outputs are byte-identical to single-process conversion (the codec is
collective-free, SURVEY.md §5)."""

import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.conftest import REPO_ROOT, make_hydrophone
from x3_tpu.multifile import wav_to_x3a_batch
from x3_tpu.utils.wav import write_wav

WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid, nproc, port, base, n_files = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5])
    jax.distributed.initialize(
        coordinator_address=f"localhost:{{port}}", num_processes=nproc, process_id=pid
    )
    from x3_tpu.parallel.multihost import local_mesh, shard_worklist
    from x3_tpu.multifile import wav_to_x3a_batch
    pairs = shard_worklist(
        [(f"{{base}}/in{{i}}.wav", f"{{base}}/dist{{i}}.x3a") for i in range(n_files)]
    )
    wav_to_x3a_batch([w for w, _ in pairs], [o for _, o in pairs], mesh=local_mesh())
    print(f"proc {{jax.process_index()}}/{{jax.process_count()}}: {{len(pairs)}} files")
    """
)


@pytest.mark.slow
def test_two_process_distributed_pipeline(tmp_path):
    rng = np.random.default_rng(3)
    n_files = 5
    for i in range(n_files):
        write_wav(tmp_path / f"in{i}.wav", make_hydrophone(rng, 22_000), 44100)

    # Single-process reference conversion.
    wav_to_x3a_batch(
        [tmp_path / f"in{i}.wav" for i in range(n_files)],
        [tmp_path / f"ref{i}.x3a" for i in range(n_files)],
    )

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    script = WORKER.format(repo=str(REPO_ROOT))
    env = {
        "JAX_PLATFORMS": "cpu",
        "PATH": "/usr/bin:/bin:/usr/local/bin",
        "HOME": "/root",
    }
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(pid), "2", str(port), str(tmp_path), str(n_files)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=400)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"

    for i in range(n_files):
        assert (tmp_path / f"dist{i}.x3a").read_bytes() == (tmp_path / f"ref{i}.x3a").read_bytes()
