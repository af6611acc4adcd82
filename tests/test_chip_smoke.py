"""chip_smoke.py off the card: it refuses to run without a GPU, and each
of its phases passes here at a tiny size on the CPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from tests.conftest import REPO_ROOT
from x3_tpu.params import Parameters

P = Parameters()


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True, env=env, cwd=cwd, timeout=300
    )


def test_exits_nonzero_without_gpu():
    r = _run_smoke(REPO_ROOT / "chip_smoke.py", REPO_ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO_ROOT / "chip_smoke.py", tmp_path)
    r = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_device_report_names_the_device(capsys):
    info = cs.device_report(jax.devices()[:1])
    assert (info["platform"], info["count"]) == ("cpu", 1)
    out = capsys.readouterr().out
    assert "nvidia-smi:" in out and '"kind"' in out


@pytest.mark.parametrize("cls", list(cs.FILE_SIZES_MB))
def test_phase_files(tmp_path, cls):
    out = cs.phase_files(tmp_path, P, {cls: 0.05})
    assert out[cls]["archive_identical"] and out[cls]["roundtrip_exact"]
    assert not list(tmp_path.glob(f"{cls}.*x3a"))  # cleaned up per class


def test_phase_damage(tmp_path):
    out = cs.phase_damage(tmp_path, P, n_frames=24)
    assert out["mutated"] == 16
    assert set(out["codes"]) >= {0, 4} and len(out["codes"]) >= 3


def test_damaged_archive_rotation():
    data, wav, mutated = cs.damaged_archive(P, 12)
    from x3_tpu import archive

    _, hs = archive.parse_archive_header(data)
    index = list(archive.walk_frames(data, hs))
    assert len(index) == 12 and mutated == 8
    assert sum(h.samples for _, h in index) == len(wav)


def test_phase_routing():
    out = cs.phase_routing()
    assert out["h2d_mbps"] is None  # CPU backend: no link to probe
    assert out["auto_encode"] in ("native", "jax")
