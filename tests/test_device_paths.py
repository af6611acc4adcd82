"""What the device path is made of: the decode scan's per-backend gather
geometry, the absence of any hand-written kernel or path switch, and
where the persistent compile cache lives."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from tests.conftest import REPO_ROOT, make_mixed
from x3_tpu.models import oracle
from x3_tpu.ops import decode_kernel as dk
from x3_tpu.ops.encode_kernel import block_buffer_words, frame_geometry
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)


def _window_ok(G, K, U, L, WIN):
    maxadv = (6 + 16 * L + 31) // 32 + 1
    return (G - 1) + U * maxadv + WIN <= K * G


@pytest.mark.parametrize("block_len", [1, 4, 20, 60])
def test_gpu_gather_geometry(monkeypatch, block_len):
    """The GPU branch: its own slice width, a window that holds U blocks of
    worst-case advance, and U as pinned (or the widest the window allows,
    at most the frame's block count)."""
    params = Parameters(block_len=block_len)
    _, B, L, _ = frame_geometry(params)
    WIN = block_buffer_words(params)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    G, K, U = dk._gather_geometry(L, WIN, B)
    g_pin, u_pin = dk._GPU_GATHER
    assert G == g_pin and 1 <= U <= B and _window_ok(G, K, U, L, WIN)
    if u_pin is not None:
        assert U <= u_pin
    else:
        assert U == B or not _window_ok(G, K, U + 1, L, WIN)  # widest U


def test_cpu_gather_geometry():
    _, B, L, _ = frame_geometry(Parameters())
    G, K, U = dk._gather_geometry(L, block_buffer_words(Parameters()), B)
    assert (G, U) == (16, 1)  # one block per step keeps XLA:CPU compiles short
    G, K, U = dk._gather_geometry(4, block_buffer_words(TINY), 8)
    assert U > 1 and _window_ok(G, K, U, 4, block_buffer_words(TINY))


def test_gpu_gather_geometry_decodes_bit_exact(monkeypatch, rng):
    """The scan traced with the GPU geometry (run here on the CPU, tiny
    frames) decodes exactly what the oracle does."""
    spf = TINY.samples_per_frame
    wav = make_mixed(rng, 3 * spf)
    frames = [wav[i * spf : (i + 1) * spf] for i in range(3)]
    payloads = [oracle.encode_frame_payload(f, TINY)[0] for f in frames]
    W = 64
    buf = np.zeros((4, W * 4), np.uint8)
    for i, p in enumerate(payloads):
        buf[i, : len(p)] = np.frombuffer(p, np.uint8)
    ns = np.array([spf] * 3 + [0], np.int32)
    pls = np.array([len(p) for p in payloads] + [0], np.int32)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    out, err, _ = jax.jit(lambda b, n, p: dk._decode_impl(b, n, p, TINY))(buf, ns, pls)
    assert not np.asarray(err).any()
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(np.asarray(out)[i, :spf], f)


def _sources():
    return {str(p.relative_to(REPO_ROOT)): p.read_text() for p in (REPO_ROOT / "x3_tpu").rglob("*.py")}


def test_package_imports_no_experimental_jax():
    """No hand-written kernel language: nothing under x3_tpu/ imports from
    jax.experimental (where the kernel APIs live)."""
    hits = []
    for name, text in _sources().items():
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("jax.experimental"):
                hits.append((name, node.module))
            if isinstance(node, ast.Import):
                hits += [(name, a.name) for a in node.names if a.name.startswith("jax.experimental")]
    assert not hits, hits


def test_package_reads_no_path_switch():
    """The only environment variables the package reads are the engine
    override, the probe switch and the external-binary paths: no variable
    picks between device code paths."""
    read = set()
    for text in _sources().values():
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in ("get", "getenv", "setdefault"):
                    owner = f.value
                    if (isinstance(owner, ast.Attribute) and owner.attr == "environ") or (
                        isinstance(owner, ast.Name) and owner.id == "os"
                    ):
                        read.add(node.args[0].value)
            if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute):
                if node.value.attr == "environ" and isinstance(node.slice, ast.Constant):
                    read.add(node.slice.value)
    assert read == {"X3_ENGINE", "X3_AUTO_PROBE", "X3_REFERENCE_BIN", "FLAC_BIN"}, read


def _run(code: str, env_extra: dict, unset=()) -> str:
    env = {k: v for k, v in os.environ.items() if k not in unset}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO_ROOT)}, **env_extra)
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_device_path_loads_no_experimental_jax():
    """Importing every module and running an encode/decode round trip loads
    no jax.experimental module beyond what `import jax` itself loads."""
    out = _run(
        """
        import importlib, pkgutil, sys, json
        import numpy as np
        import jax
        base = {k for k in sys.modules if k.startswith("jax.experimental")}
        import x3_tpu
        for m in pkgutil.walk_packages(x3_tpu.__path__, "x3_tpu."):
            if not m.name.endswith("__main__"):
                importlib.import_module(m.name)
        from x3_tpu.models.encoder import encode
        from x3_tpu.models.decoder import decode_frames_batch
        wav = (np.arange(2500) % 300).astype(np.int16)
        blob = encode(wav, engine="jax", batch_frames=1).data
        assert decode_frames_batch([blob[20:]], [2500])[0][0].tobytes() == wav.tobytes()
        print(json.dumps(sorted(k for k in sys.modules if k.startswith("jax.experimental") and k not in base)))
        """,
        {},
    )
    assert json.loads(out) == []


@pytest.mark.parametrize("where", ["unset", "set"])
def test_compile_cache_placement(tmp_path, where):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache is <repo>/.jax_cache, and compiled programs land there."""
    target = tmp_path / "cc" if where == "set" else REPO_ROOT / ".jax_cache"
    env = {"JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"}
    if where == "set":
        env["JAX_COMPILATION_CACHE_DIR"] = str(target)
    out = _run(
        """
        import jax, jax.numpy as jnp
        import x3_tpu.ops
        print(jax.config.jax_compilation_cache_dir)
        jax.jit(lambda x: x * 3 + 0x5CA1E)(jnp.arange(7)).block_until_ready()
        print(jax.config.jax_compilation_cache_dir)
        """,
        env,
        unset=("JAX_COMPILATION_CACHE_DIR",),
    )
    assert out == str(target)
    assert any(target.iterdir()), "no compiled program was cached"
