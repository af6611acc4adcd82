"""The XLA scan decode (ops/decode_kernel.py) against the plain reference
(models/oracle.py) at every payload-width rung and on mutated streams: the
scan is the only device decode path."""

import numpy as np
import pytest

from bench import make_class_corpus
from tests.conftest import make_mixed
from x3_tpu.errors import DECODE_ERROR_CLASSES, X3Error
from x3_tpu.models import oracle
from x3_tpu.models.decoder import decode_frames_batch
from x3_tpu.ops.encode_kernel import width_rungs
from x3_tpu.params import Parameters

P = Parameters()
SPF = P.samples_per_frame
F = 4  # lanes per decode call: one compile per rung, shared by the classes


def _frames_fitting(cls: str, w: int, seed: int):
    """Up to three frames of `cls` (one full-length where it fits, shorter
    ones otherwise, and a partial frame) whose payloads fit w words."""
    wav = make_class_corpus(cls, 3, SPF, seed)
    out = []
    for k, n in enumerate((SPF, SPF // 3 + 7, 1)):
        frame = wav[k * SPF : k * SPF + n]
        payload, crc = oracle.encode_frame_payload(frame, P)
        while len(payload) > w * 4:
            frame = frame[: len(frame) // 2]
            payload, crc = oracle.encode_frame_payload(frame, P)
        out.append((frame, payload, crc))
    return out


@pytest.mark.parametrize("cls", ["hydrophone", "music", "pi240"])
@pytest.mark.parametrize("w", width_rungs(P))
def test_scan_decode_matches_oracle_at_rung(cls, w):
    from x3_tpu.ops.decode_kernel import decode_frames_checked

    frames = _frames_fitting(cls, w, seed=w + len(cls))
    buf = np.zeros((F, w * 4), np.uint8)
    ns = np.zeros(F, np.int32)
    pls = np.zeros(F, np.int32)
    for i, (frame, payload, _) in enumerate(frames):
        buf[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        ns[i], pls[i] = len(frame), len(payload)
    out, err, crc = decode_frames_checked(buf, ns, pls, P)
    out, err, crc = np.asarray(out), np.asarray(err), np.asarray(crc)
    assert not err.any()
    for i, (frame, payload, want_crc) in enumerate(frames):
        want = oracle.decode_frame(payload, P, len(frame))
        np.testing.assert_array_equal(want, frame)
        np.testing.assert_array_equal(out[i, : len(frame)], want)
        assert crc[i] == want_crc


MUTATIONS = {
    # The same rotation as chip_smoke.damaged_archive.
    "flip_first_block": lambda b: b[:2] + bytes([b[2] ^ 0xFF]) + b[3:],
    "flip_middle": lambda b: b[: len(b) // 2] + bytes([b[len(b) // 2] ^ 0x81]) + b[len(b) // 2 + 1 :],
    "flip_last": lambda b: b[:-1] + bytes([b[-1] ^ 0x0F]),
    "truncate_half": lambda b: b[: max(2, len(b) // 2)],
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_scan_error_flags_match_oracle(mutation, rng):
    """Mutated payloads: per-frame error classes and accepted samples equal
    the oracle's, on every block type (make_mixed) and across classes."""
    seed = {"flip_first_block": 1, "flip_middle": 2, "flip_last": 3, "truncate_half": 4}[mutation]
    r = np.random.default_rng(seed)
    wavs = [make_mixed(r, SPF)] + [make_class_corpus(c, 1, SPF, seed) for c in ("hydrophone", "music", "pi240", "noise")]
    payloads = [MUTATIONS[mutation](oracle.encode_frame_payload(w, P)[0]) for w in wavs]
    outs, err = decode_frames_batch(payloads, [SPF] * len(wavs), P)
    for i, p in enumerate(payloads):
        try:
            want = oracle.decode_frame(p, P, SPF)
        except X3Error as e:
            assert err[i] != 0, f"frame {i}: oracle raised {type(e).__name__}, scan accepted"
            assert DECODE_ERROR_CLASSES[int(err[i])] is type(e), (i, int(err[i]), type(e).__name__)
        else:
            assert err[i] == 0, f"frame {i}: scan error {int(err[i])}, oracle accepted"
            np.testing.assert_array_equal(outs[i], want)
