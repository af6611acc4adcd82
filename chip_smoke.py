"""On-device smoke test of the X3 codec's main path.

    python chip_smoke.py               # one GPU: files, device kernels, damage
    python chip_smoke.py --devices 4   # sharded batch conversion on 4 GPUs

Everything runs in this one process (a JAX process reserves most of the
card's memory, so a second one could not start): the CLI is called through
`x3_tpu.cli.main`, and the `gpu`-marked tests through `pytest.main`.

One device (default Parameters: 10,000-sample frames of 500 blocks x 20):

* files    — seeded WAVs at the upstream suite's sizes (hydrophone 72 MB,
             music 38 MB, pi240 144 MB, white noise 20 MB) through
             `wav_to_x3a` / `x3a_to_wav` with engine="jax": the archive must
             be byte-identical to engine="native"'s and the WAV must round-trip
             bit-exactly; one conversion through the CLI, one `verify_x3a`;
* rungs    — `encode_frames` (F=768) at every payload-width and block-width
             rung and `decode_frames_checked` (F=6144) at every payload-width
             rung, compared exactly with the plain reference
             (`models/oracle.py`) on the first 8 frames, the partial tail frame
             and every frame that forced an escalation, and with the native
             core on every frame; prints cold/warm compile seconds, memory
             analysis and device time per rung;
* damage   — a damaged archive with >= 300 mutated frames decoded with
             resync: per-frame error codes and accepted samples must equal
             the native engine's;
* tests    — the `gpu`-marked tests;
* routing  — what engine="auto" picks, with both probe rates.

With --devices 4 only the sharded path runs: 256 seeded WAVs of mixed class
and length (0.5-8 MB) through `multifile.wav_to_x3a_batch` /
`x3a_to_wav_batch` over a 4-device mesh, compared with the native engine,
plus `parallel.mesh.roundtrip_step` at default geometry.

Exits non-zero, with no result line, when JAX finds no GPU or any phase
fails.  The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
# Upstream suite sizes (the reference's test/timings.csv) plus the noise
# file of BASELINE.json config 3, in MB of 16-bit PCM.
FILE_SIZES_MB = {"hydrophone": 72, "music": 38, "pi240": 144, "noise": 20}
# Classes of the rung corpus's first 8 frames: together they reach every
# payload-width rung (pi240 512, quiet 1024, hydrophone 2048, music 4096,
# noise full) and every block-width rung.
LEAD_CLASSES = ("pi240", "quiet", "hydrophone", "music", "noise", "pi240", "hydrophone", "music")
UNMAPPED_ERR = 99  # a native exception with no device error code


def log(*args) -> None:
    print(*args, flush=True)


def sh(cmd: list[str]) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"


def require_devices(n: int):
    """The first n JAX devices, which must be GPUs; exits otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}")
    if len(devs) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPUs, JAX found {len(devs)}")
    return devs[:n]


def device_report(devices) -> dict:
    import jax

    d = devices[0]
    info = {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(devices),
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    log("nvidia-smi:", sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    log("device:", json.dumps(info))
    return info


# ---------------------------------------------------------------------------
# Signals
# ---------------------------------------------------------------------------


def class_samples(name: str, n_samples: int, seed: int) -> np.ndarray:
    from bench import make_class_corpus

    spf = 10_000
    return make_class_corpus(name, -(-n_samples // spf), spf, seed)[:n_samples]


def mixed_frames(n_frames: int, bulk: str, seed: int, spf: int, tail: int) -> tuple[np.ndarray, np.ndarray]:
    """[n_frames, spf] int16 frames: LEAD_CLASSES first, then `bulk`, with a
    louder frame every 97th (they force escalation) and a partial last
    frame of `tail` samples.  Returns (frames, n_valid)."""
    rng = np.random.default_rng(seed)
    kinds = [LEAD_CLASSES[i] if i < len(LEAD_CLASSES) else bulk for i in range(n_frames)]
    for i in range(len(LEAD_CLASSES) + 40, n_frames, 97):
        kinds[i] = ("hydrophone", "music", "noise")[(i // 97) % 3]
    frames = np.zeros((n_frames, spf), np.int16)
    by_kind: dict[str, list[int]] = {}
    for i, k in enumerate(kinds):
        by_kind.setdefault(k, []).append(i)
    for k, idx in by_kind.items():
        frames[idx] = class_samples(k, len(idx) * spf, int(rng.integers(1 << 30))).reshape(len(idx), spf)
    n_valid = np.full(n_frames, spf, np.int32)
    n_valid[-1] = tail
    frames[-1, tail:] = 0
    return frames, n_valid


def native_payloads(frames: np.ndarray, n_valid: np.ndarray, params) -> tuple[list[bytes], np.ndarray]:
    """Per-frame payloads and CRCs from the native core (one threaded encode
    of the concatenated frames)."""
    from x3_tpu import native

    stream = np.concatenate([f[:n] for f, n in zip(frames, n_valid)])
    blob = native.encode(stream, params, nthreads=0)
    idx = native.index_frames(blob, 0)
    assert len(idx) == len(frames), (len(idx), len(frames))
    payloads = [blob[o : o + ln] for o, _, ln in idx]
    crcs = np.asarray([int.from_bytes(blob[o - 2 : o], "big") for o, _, _ in idx], np.int64)
    return payloads, crcs


# ---------------------------------------------------------------------------
# Phase: device kernels at every rung against the reference
# ---------------------------------------------------------------------------


def _compile(fn, args, static) -> tuple[object, float, float]:
    """(compiled, cold s, warm s): the first lower+compile, then a second one
    after dropping the in-memory caches, which the persistent compile cache
    serves (as it would a fresh process)."""
    import jax

    t0 = time.perf_counter()
    compiled = fn.lower(*args, *static).compile()
    cold = time.perf_counter() - t0
    jax.clear_caches()
    t0 = time.perf_counter()
    fn.lower(*args, *static).compile()
    warm = time.perf_counter() - t0
    return compiled, cold, warm


def _memory(compiled) -> dict:
    try:
        ma = compiled.memory_analysis()
    except Exception as e:  # noqa: BLE001 - not every backend reports it
        return {"unavailable": type(e).__name__}
    if ma is None:
        return {"unavailable": "None"}
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def _device_seconds(compiled, args, reps: int) -> float:
    from bench import timed

    return timed(compiled, args, reps=reps, passes=3)


def phase_rungs(params, enc_frames: int = 768, dec_frames: int = 6144, reps: int = 10, seed: int = 11) -> dict:
    """encode_frames at every width rung, decode_frames_checked at every
    payload-width rung, each compared exactly with the oracle (check set)
    and the native core (every frame)."""
    import jax

    from x3_tpu.models import oracle
    from x3_tpu.ops.decode_kernel import decode_frames_checked
    from x3_tpu.ops.encode_kernel import (
        block_width_rungs,
        encode_frames,
        fits_block_width,
        fits_width,
        width_rungs,
    )

    spf = params.samples_per_frame
    w_rungs, nw_rungs = width_rungs(params), block_width_rungs(params)
    out: dict = {"encode": {}, "decode": {}}

    # ---- encode ----
    frames, n_valid = mixed_frames(enc_frames, "pi240", seed, spf, tail=spf - 1234)
    want, want_crc = native_payloads(frames, n_valid, params)
    want_len = np.asarray([len(p) for p in want])
    esc = set(np.nonzero(want_len > (w_rungs[0] - 2) * 4)[0].tolist())
    dev_f, dev_n = jax.device_put(frames), jax.device_put(n_valid)
    runs = [(w, None) for w in w_rungs] + [(None, nw) for nw in nw_rungs]
    for w, nw in runs:
        compiled, cold, warm = _compile(encode_frames, (dev_f, dev_n), (params, "block", w, nw))
        res = jax.device_get(compiled(dev_f, dev_n))
        if (w, nw) == (None, nw_rungs[0]):
            esc |= set(np.nonzero(~_fits_each_block(res["blockfit_bits"], nw_rungs[0], params))[0].tolist())
        secs = _device_seconds(compiled, (dev_f, dev_n), reps)
        mb = enc_frames * spf * 2 / 1e6
        fit_w = w if w is not None else w_rungs[-1]
        fit = want_len <= ((fit_w - 2) * 4 if fit_w < w_rungs[-1] else 1 << 30)
        if nw is not None and nw < nw_rungs[-1]:
            fit &= _fits_each_block(res["blockfit_bits"], nw, params)
        words = np.ascontiguousarray(res["payload_words"]).byteswap().view(np.uint8)
        nbytes = np.asarray(res["nbytes"])
        assert np.array_equal(nbytes, want_len), f"encode nbytes differ at w={w} nw={nw}"
        bad = [i for i in np.nonzero(fit)[0] if words[i, : nbytes[i]].tobytes() != want[i] or res["crc"][i] != want_crc[i]]
        assert not bad, f"encode differs from native at w={w} nw={nw}: frames {bad[:8]}"
        key = f"w={w or 'full'},nw={nw or 'full'}"
        out["encode"][key] = {
            "cold_s": round(cold, 3), "warm_s": round(warm, 3),
            "device_ms": round(secs * 1e3, 4), "device_mbs": round(mb / secs, 1),
            "frames_checked": int(fit.sum()), "memory": _memory(compiled),
        }
        log(f"encode F={enc_frames} {key}: {json.dumps(out['encode'][key])}")
        assert fits_width(nbytes[fit], fit_w, params) and (nw is None or fits_block_width(res["blockfit_bits"][fit], nw, params))
    check = sorted(set(range(min(8, enc_frames))) | {enc_frames - 1} | esc)
    for i in check:
        payload, crc = oracle.encode_frame_payload(frames[i, : n_valid[i]], params)
        assert payload == want[i] and crc == want_crc[i], f"native differs from oracle at frame {i}"
    out["encode_check_frames"] = len(check)
    out["escalated_frames"] = len(esc)
    log(f"encode: {len(check)} frames equal to the oracle ({len(esc)} forced escalation)")

    # ---- decode ----
    frames, n_valid = mixed_frames(dec_frames, "pi240", seed + 1, spf, tail=spf - 4321)
    payloads, crcs = native_payloads(frames, n_valid, params)
    plen = np.asarray([len(p) for p in payloads], np.int32)
    lead = sorted(set(range(min(8, dec_frames))) | {dec_frames - 1})
    for i in lead:
        got = oracle.decode_frame(payloads[i], params, int(n_valid[i]))
        assert np.array_equal(got, frames[i, : n_valid[i]]), f"oracle decode differs at frame {i}"
    for w in w_rungs:
        take = plen <= w * 4
        buf = np.zeros((dec_frames, w * 4), np.uint8)
        for i in np.nonzero(take)[0]:
            buf[i, : plen[i]] = np.frombuffer(payloads[i], np.uint8)
        ns = np.where(take, n_valid, 0).astype(np.int32)
        pls = np.where(take, plen, 0).astype(np.int32)
        args = (jax.device_put(buf), jax.device_put(ns), jax.device_put(pls))
        compiled, cold, warm = _compile(decode_frames_checked, args, (params, None))
        dec, err, crc = jax.device_get(compiled(*args))
        assert not err.any(), f"decode errors at w={w}: lanes {np.nonzero(err)[0][:8]}"
        assert np.array_equal(crc[take], crcs[take]), f"decode CRCs differ at w={w}"
        valid = np.arange(dec.shape[1])[None, :] < ns[:, None]
        assert np.array_equal(np.where(valid, dec, 0), np.where(valid, frames[:, : dec.shape[1]], 0)), f"decode differs at w={w}"
        secs = _device_seconds(compiled, args, reps)
        mb = dec_frames * spf * 2 / 1e6
        out["decode"][f"w={w}"] = {
            "cold_s": round(cold, 3), "warm_s": round(warm, 3),
            "device_ms": round(secs * 1e3, 4), "device_mbs": round(mb / secs, 1),
            "lanes": int(take.sum()), "memory": _memory(compiled),
        }
        log(f"decode F={dec_frames} w={w}: {json.dumps(out['decode'][f'w={w}'])}")
    return out


def _fits_each_block(blockfit, nw: int, params) -> np.ndarray:
    from x3_tpu.ops.encode_kernel import block_buffer_words

    if nw >= block_buffer_words(params):
        return np.ones(len(blockfit), bool)
    return np.asarray(blockfit) <= (nw + 8 - 1) * 32


# ---------------------------------------------------------------------------
# Phase: file conversion
# ---------------------------------------------------------------------------


def phase_files(workdir: Path, params, sizes_mb: dict[str, float] | None = None, seed: int = 5) -> dict:
    """wav_to_x3a / x3a_to_wav with engine="jax" for each class: archive
    byte-identical to the native engine's, WAV bit-exact; then one CLI
    conversion and one verify_x3a."""
    from x3_tpu import cli
    from x3_tpu.files import verify_x3a, wav_to_x3a, x3a_to_wav
    from x3_tpu.utils.wav import read_wav, write_wav

    sizes_mb = sizes_mb or FILE_SIZES_MB
    out = {}
    for k, (name, mb) in enumerate(sizes_mb.items()):
        n = int(mb * 1e6) // 2 + 1234  # partial tail frame
        wav = class_samples(name, n, seed + k)
        src, jx, nx, back = (workdir / f"{name}{s}" for s in (".wav", ".jax.x3a", ".native.x3a", ".back.wav"))
        write_wav(src, wav, 96000)
        t0 = time.perf_counter()
        wav_to_x3a(src, jx, params, engine="jax")
        t_enc = time.perf_counter() - t0
        wav_to_x3a(src, nx, params, engine="native")
        same = jx.read_bytes() == nx.read_bytes()
        t0 = time.perf_counter()
        errors = x3a_to_wav(jx, back, engine="jax")
        t_dec = time.perf_counter() - t0
        got, _ = read_wav(back)
        exact = errors == 0 and np.array_equal(got, wav)
        out[name] = {
            "mb": round(wav.nbytes / 1e6, 3), "ratio": round(wav.nbytes / jx.stat().st_size, 3),
            "archive_identical": same, "roundtrip_exact": bool(exact),
            "wall_encode_s": round(t_enc, 3), "wall_decode_s": round(t_dec, 3),
        }
        log(f"file {name}: {json.dumps(out[name])}")
        assert same, f"{name}: jax archive differs from the native engine's"
        assert exact, f"{name}: WAV round trip is not bit-exact"
        if k == 0:
            cli_back = workdir / f"{name}.cli.wav"
            assert cli.main(["-i", str(jx), "-o", str(cli_back), "--engine", "jax", "-q"]) == 0
            assert read_wav(cli_back)[0].tobytes() == wav.tobytes(), "CLI decode differs"
            report = verify_x3a(jx, engine="jax")
            log(f"verify_x3a {name}: {json.dumps(report)}")
            assert report["ok"] and report["n_samples_ok"] == len(wav), report
        for p in (src, jx, nx, back):
            p.unlink()
    return out


# ---------------------------------------------------------------------------
# Phase: damaged archive
# ---------------------------------------------------------------------------


def damaged_archive(params, n_frames: int, seed: int = 9) -> tuple[bytes, np.ndarray, int]:
    """A hydrophone archive whose frames are mutated in the rotation of the
    old on-chip parity check (i % 6: 0 flips byte 2, 1 flips a middle byte,
    2 flips the last byte, 3 truncates the payload to half, 4-5 untouched).
    Every other mutated frame gets a matching payload CRC, so its damage
    reaches the decoder; the rest fail their CRC check.  Returns (archive,
    source samples, number of mutated frames)."""
    from x3_tpu import archive, native
    from x3_tpu.models.oracle import write_frame_header
    from x3_tpu.ops.crc import crc16

    spf = params.samples_per_frame
    wav = class_samples("hydrophone", n_frames * spf, seed)
    blob = native.encode(wav, params, nthreads=0)
    out = bytearray(archive.build_archive_header(96000, params))
    mutated = 0
    for i, (o, ns, ln) in enumerate(native.index_frames(blob, 0)):
        payload = bytearray(blob[o : o + ln])
        crc = int.from_bytes(blob[o - 2 : o], "big")
        m = i % 6
        if m == 0:
            payload[2] ^= 0xFF
        elif m == 1:
            payload[ln // 2] ^= 0x81
        elif m == 2:
            payload[ln - 1] ^= 0x0F
        elif m == 3:
            payload = payload[: max(2, ln // 2)]
        if m < 4:
            mutated += 1
            if (i // 6) % 2 == 0:
                crc = crc16(bytes(payload))
        out += write_frame_header(ns, 1, len(payload), crc) + payload
    return bytes(out), wav, mutated


def _frame_codes(data: bytes, params, engine: str):
    """Per-frame (error code, samples) of every frame the resync walk finds,
    decoded by `engine` with payload CRCs checked (code 4 = CRC)."""
    from x3_tpu import archive, native
    from x3_tpu.errors import DECODE_ERROR_CLASSES, X3Error
    from x3_tpu.models.decoder import decode_frames_batch

    _, hs = archive.parse_archive_header(data)
    index = list(archive.walk_frames(data, hs, resync=True))
    payloads = [data[o : o + h.payload_len] for o, h in index]
    ns = [h.samples for _, h in index]
    want = [h.payload_crc for _, h in index]
    if engine == "jax":
        outs, err, crc_ok = decode_frames_batch(payloads, ns, params, check_crcs=want)
        return np.where(crc_ok, err, 4), outs
    code_of = {cls: c for c, cls in DECODE_ERROR_CLASSES.items()}
    crc_ok = archive.verify_payload_crcs_parts(payloads, want)
    codes, outs = [], []
    for p, n, ok in zip(payloads, ns, crc_ok):
        if not ok:
            codes.append(4)
            outs.append(None)
            continue
        try:
            outs.append(native.decode_frame(p, params, n))
            codes.append(0)
        except X3Error as e:
            codes.append(code_of.get(type(e), UNMAPPED_ERR))
            outs.append(None)
    return np.asarray(codes), outs


def phase_damage(workdir: Path, params, n_frames: int = 1100) -> dict:
    """Per-frame error codes and accepted samples of a damaged archive, jax
    against native; then the file path with resync on both engines.  1100
    frames pad to the 2048-lane batch the files phase already compiled."""
    from x3_tpu.files import verify_x3a, x3a_to_wav

    data, _, mutated = damaged_archive(params, n_frames)
    jc, jo = _frame_codes(data, params, "jax")
    nc, no = _frame_codes(data, params, "native")
    assert np.array_equal(jc, nc), f"error codes differ at frames {np.nonzero(jc != nc)[0][:8]}"
    for i in np.nonzero(jc == 0)[0]:
        assert np.array_equal(jo[i], no[i]), f"accepted samples differ at frame {i}"
    path = workdir / "damaged.x3a"
    path.write_bytes(data)
    res = {}
    for engine in ("jax", "native"):
        back = workdir / f"damaged.{engine}.wav"
        with contextlib.redirect_stdout(io.StringIO()):  # one line per bad frame
            res[engine] = (x3a_to_wav(path, back, engine=engine, resync=True), back.read_bytes())
        rep = verify_x3a(path, engine=engine)
        res[engine] += ({k: rep[k] for k in ("n_frames", "n_samples_ok", "frame_errors", "skipped_bytes")},)
    assert res["jax"][0] == res["native"][0], "frame error counts differ"
    assert res["jax"][1] == res["native"][1], "resynced WAVs differ"
    assert res["jax"][2] == res["native"][2], (res["jax"][2], res["native"][2])
    codes = {int(c): int((jc == c).sum()) for c in np.unique(jc)}
    out = {"frames": len(jc), "mutated": mutated, "codes": codes, "frame_errors": res["jax"][0]}
    log(f"damage: {json.dumps(out)}")
    assert mutated >= min(300, n_frames // 2)
    return out


# ---------------------------------------------------------------------------
# Phase: sharded batch conversion (--devices N)
# ---------------------------------------------------------------------------


def phase_mesh(workdir: Path, devices, params, n_files: int = 256, mb_range=(0.5, 8.0), batch_frames=None, seed: int = 13) -> dict:
    """256 seeded WAVs of mixed class and length through the sharded batch
    API over a mesh of `devices`: archives byte-identical to the native
    engine's, WAVs bit-exact; then roundtrip_step at default geometry."""
    from x3_tpu.files import wav_to_x3a
    from x3_tpu.multifile import wav_to_x3a_batch, x3a_to_wav_batch
    from x3_tpu.parallel.mesh import make_mesh, roundtrip_step
    from x3_tpu.params import Parameters
    from x3_tpu.utils.wav import read_wav, write_wav

    rng = np.random.default_rng(seed)
    mesh = make_mesh(devices)
    classes = ("hydrophone", "music", "pi240", "quiet", "noise")
    wavs, srcs, arcs, refs, backs = [], [], [], [], []
    for i in range(n_files):
        n = int(rng.uniform(*mb_range) * 1e6) // 2
        wav = class_samples(classes[i % len(classes)], n, int(rng.integers(1 << 30)))
        wavs.append(wav)
        srcs.append(workdir / f"m{i}.wav")
        arcs.append(workdir / f"m{i}.x3a")
        refs.append(workdir / f"m{i}.ref.x3a")
        backs.append(workdir / f"m{i}.back.wav")
        write_wav(srcs[-1], wav, 96000)
    mb = sum(w.nbytes for w in wavs) / 1e6
    t0 = time.perf_counter()
    wav_to_x3a_batch(srcs, arcs, params, batch_frames=batch_frames, mesh=mesh)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    x3a_to_wav_batch(arcs, backs, batch_frames=batch_frames, mesh=mesh)
    t_dec = time.perf_counter() - t0
    for i in range(n_files):
        wav_to_x3a(srcs[i], refs[i], params, engine="native")
        assert arcs[i].read_bytes() == refs[i].read_bytes(), f"file {i}: sharded archive differs from native"
        assert np.array_equal(read_wav(backs[i])[0], wavs[i]), f"file {i}: WAV round trip not bit-exact"
    # The jitted sharded step at default geometry, one partial frame.
    dp = Parameters()
    spf = dp.samples_per_frame
    frames, n_valid = mixed_frames(2 * len(devices), "hydrophone", seed, spf, tail=spf - 7)
    nbytes, exact = roundtrip_step(dp, mesh)(frames, n_valid)
    want, _ = native_payloads(frames, n_valid, dp)
    assert bool(exact), "roundtrip_step was not bit-exact"
    assert np.array_equal(np.asarray(nbytes), [len(p) for p in want]), "roundtrip_step nbytes differ"
    out = {
        "files": n_files, "mb": round(mb, 3), "devices": len(devices),
        "wall_encode_s": round(t_enc, 3), "wall_decode_s": round(t_dec, 3),
        "roundtrip_step_frames": len(frames),
    }
    log(f"mesh: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase: gpu-marked tests, engine routing
# ---------------------------------------------------------------------------


def phase_tests() -> dict:
    import pytest

    os.environ["X3_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main([str(REPO / "tests" / "test_gpu.py"), "-q", "-m", "gpu", "-p", "no:cacheprovider"])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {int(rc)})"
    return {"pytest_exit": int(rc)}


def phase_routing() -> dict:
    from x3_tpu import engine

    out = {
        "h2d_mbps": engine.probed_h2d_mbps(),
        "native_mbps": engine.probed_native_mbps(),
        "auto_encode": engine.resolve_engine("auto", decode=False),
        "auto_decode": engine.resolve_engine("auto", decode=True),
    }
    log(f"routing: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------


def run_phases(phases) -> bool:
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            status = "pass"
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            status, ok = "FAIL", False
        log(f"phase {name}: {status} ({time.perf_counter() - t0:.1f} s)")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, help="4: run only the sharded batch path")
    args = ap.parse_args(argv)

    devices = require_devices(args.devices)
    sys.path.insert(0, str(REPO))
    info = device_report(devices)

    from x3_tpu import native
    from x3_tpu.params import Parameters

    assert native.available(), "native core failed to build"
    params = Parameters()
    workdir = REPO / ".smoke_work"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir()
    try:
        if args.devices > 1:
            phases = [("mesh", lambda: phase_mesh(workdir, devices, params))]
        else:
            phases = [
                ("rungs", lambda: phase_rungs(params)),
                ("files", lambda: phase_files(workdir, params)),
                ("damage", lambda: phase_damage(workdir, params)),
                ("tests", phase_tests),
                ("routing", phase_routing),
            ]
        ok = run_phases(phases)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {k: info[k] for k in ("platform", "kind", "count")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
