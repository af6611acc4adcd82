"""Time the device pipelines' size choices against their alternatives.

    python tools/geometry_ab.py            # on the card; one line per variant
    python tools/geometry_ab.py --scale 0.002   # rehearsal at tiny batches

Each variant runs in its own process, one after another (never two on the
card at once), with an empty compile cache, so the cold compile it reports
is real.  Variants:

* decode scan gather geometry (ops/decode_kernel._GPU_GATHER) at F=6144 on
  the hydrophone class's 2048-word rung: (G=64, widest U), (64, U=1),
  (16, U=1);
* the decode batch width with the fastest geometry: F=2048 (the file
  path's default batch) and F=12288;
* the encode batch width: F=768 (the file path's default) and F=1536.

Prints the device name and power limit first.  Each variant prints cold
compile seconds and best-of-3 device time (block_until_ready).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

VARIANT = textwrap.dedent(
    """
    import json, sys, time
    sys.path.insert(0, {repo!r})
    import jax, numpy as np
    from bench import make_class_corpus, timed
    from x3_tpu import native
    from x3_tpu.ops import decode_kernel as dk, encode_kernel as ek
    from x3_tpu.params import Parameters

    v = json.loads({variant!r})
    dk._GPU_GATHER = tuple(v.get("gather", dk._GPU_GATHER))
    P = Parameters()
    spf, F = P.samples_per_frame, v["F"]
    wav = make_class_corpus("hydrophone", F, spf, 7)
    t0 = time.perf_counter()
    if v["op"] == "decode":
        blob = native.encode(wav, P, nthreads=0)
        idx = native.index_frames(blob, 0)
        W = 2048
        buf = np.zeros((F, W * 4), np.uint8)
        for i, (o, _, ln) in enumerate(idx):
            buf[i, :ln] = np.frombuffer(blob[o : o + ln], np.uint8)
        ns = np.full(F, spf, np.int32)
        pls = np.asarray([ln for _, _, ln in idx], np.int32)
        args = tuple(jax.device_put(a) for a in (buf, ns, pls))
        t0 = time.perf_counter()
        fn = dk.decode_frames_checked.lower(*args, P, None).compile()
        cold = time.perf_counter() - t0
        out, err, _ = fn(*args)
        assert not np.asarray(err).any()
        assert np.array_equal(np.asarray(out)[:, :spf], wav.reshape(F, spf))
    else:
        frames = wav.reshape(F, spf)
        args = (jax.device_put(frames), jax.device_put(np.full(F, spf, np.int32)))
        t0 = time.perf_counter()
        fn = ek.encode_frames.lower(*args, P, "block", 2048, 6).compile()
        cold = time.perf_counter() - t0
    secs = timed(fn, args, reps=10, passes=3)
    mb = F * spf * 2 / 1e6
    print(json.dumps(dict(v, cold_compile_s=round(cold, 2), device_ms=round(secs * 1e3, 3),
                          device_mbs=round(mb / secs, 1))), flush=True)
    """
)


def run(variant: dict, timeout: int, scale: float) -> dict | None:
    variant = dict(variant, F=max(4, int(variant["F"] * scale)))
    (REPO / ".jax_cache").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / ".jax_cache") as cache:
        env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cache)
        code = VARIANT.format(repo=str(REPO), variant=json.dumps(variant))
        try:
            r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=timeout)
        except subprocess.TimeoutExpired:
            print(json.dumps(dict(variant, error=f"timeout after {timeout} s")), flush=True)
            return None
    if r.returncode != 0:
        print(json.dumps(dict(variant, error=r.stderr.strip().splitlines()[-1:])), flush=True)
        return None
    line = r.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0, help="multiply every batch size")
    ap.add_argument("--timeout", type=int, default=300, help="seconds per variant")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from chip_smoke import sh

    print("nvidia-smi:", sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]), flush=True)
    ab = lambda v: run(v, args.timeout, args.scale)  # noqa: E731
    res = [ab({"op": "decode", "F": 6144, "gather": g}) for g in [(64, None), (64, 1), (16, 1)]]
    ok = [r for r in res if r]
    best = min(ok, key=lambda r: r["device_ms"])["gather"] if ok else [16, 1]
    for F in (2048, 12288):
        ab({"op": "decode", "F": F, "gather": best})
    for F in (768, 1536):
        ab({"op": "encode", "F": F})
    return 0


if __name__ == "__main__":
    sys.exit(main())
