"""chip_smoke.py's device-kernel and sharded phases, here on the CPU at a
tiny size: every rung against the oracle, and the --devices 4 path on four
virtual CPU devices."""

import jax
import numpy as np

import chip_smoke as cs
from x3_tpu.ops.encode_kernel import block_width_rungs, width_rungs
from x3_tpu.params import Parameters

P = Parameters()


def test_phase_rungs_tiny():
    out = cs.phase_rungs(P, enc_frames=12, dec_frames=16, reps=1)
    assert len(out["encode"]) == len(width_rungs(P)) + len(block_width_rungs(P))
    assert len(out["decode"]) == len(width_rungs(P))
    # the lead frames reach every rung, so each compact run checks fewer
    # frames than the full-width run
    checked = [r["frames_checked"] for r in out["encode"].values()]
    assert min(checked) < max(checked) == 12
    assert out["escalated_frames"] >= 5


def test_mixed_frames_lead_and_tail():
    frames, n_valid = cs.mixed_frames(200, "pi240", 3, P.samples_per_frame, tail=77)
    assert frames.shape == (200, P.samples_per_frame) and n_valid[-1] == 77
    assert not frames[-1, 77:].any()
    payloads, _ = cs.native_payloads(frames, n_valid, P)
    lens = np.asarray([len(p) for p in payloads])
    rungs = width_rungs(P)
    fit = [next(r for r in rungs if n <= (r - 2) * 4 or r == rungs[-1]) for n in lens[:8]]
    assert set(fit) == set(rungs)  # the first 8 frames reach every rung


def test_phase_mesh_four_devices(tmp_path):
    out = cs.phase_mesh(tmp_path, jax.devices()[:4], P, n_files=5, mb_range=(0.01, 0.05), batch_frames=8)
    assert out["devices"] == 4 and out["files"] == 5
