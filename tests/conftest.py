import os
import sys
from pathlib import Path

# The suite validates numerics/sharding on a virtual 8-device CPU mesh so it
# runs anywhere.  Tests of the device path itself carry the `gpu` marker and
# run on the card through chip_smoke.py, which sets X3_TESTS_ON_DEVICE=1 so
# that this file leaves JAX's platform alone.
ON_DEVICE = os.environ.get("X3_TESTS_ON_DEVICE") == "1"
if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_DEVICE:
    # In case jax was imported before this file: set the loaded config too.
    jax.config.update("jax_platforms", "cpu")

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import numpy as np
import pytest

GOLDEN_PATH = REPO_ROOT / "tests" / "data" / "golden.npz"


@pytest.fixture(scope="session")
def golden():
    return dict(np.load(GOLDEN_PATH))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0DEC)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none.  Decided
    here, at run time, never while the module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return dev


def make_hydrophone(rng, n, amplitude=6.0, drift=2000.0):
    """Synthetic low-entropy hydrophone-like signal: slow drift + small noise.

    Produces mostly Rice-coded blocks like the real corpora in
    /root/reference/test/timings.csv."""
    t = np.arange(n)
    slow = drift * np.sin(2 * np.pi * t / 9773.0)
    noise = rng.normal(0.0, amplitude, n)
    return np.clip(np.round(slow + noise), -32768, 32767).astype(np.int16)


def make_mixed(rng, n):
    """Signal that exercises every block type: silence, small noise, medium
    noise, large jumps (BFP), and full-scale white noise (pass-through)."""
    parts = []
    seg = max(1, n // 6)
    parts.append(np.zeros(seg, dtype=np.int16))
    parts.append(np.round(rng.normal(0, 1.2, seg)).astype(np.int16))
    parts.append(np.round(rng.normal(0, 5, seg)).astype(np.int16))
    parts.append(np.round(rng.normal(0, 400, seg)).astype(np.int16))
    parts.append(rng.integers(-32768, 32768, seg).astype(np.int16))
    cum = np.cumsum(rng.integers(-40, 41, n - 5 * seg))
    parts.append(np.clip(cum, -32768, 32767).astype(np.int16))
    return np.concatenate(parts)[:n]
