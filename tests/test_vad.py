"""Bit-exact parity of the fixed-point GMM VAD vs the reference's
vendored WebRTC VAD (golden dumps from tools/oracle/vad_oracle.c:
decisions per frame and the 6 sub-band log-energy features + total
power computed by vad_filterbank.c)."""

import os

import numpy as np
import pytest

from tests.conftest import GOLDEN, DATADIR

from soundswallower_tpu.vad import Vad
from soundswallower_tpu.webrtc_vad import VadCore

VADG = os.path.join(GOLDEN, "vad")

CASES = [
    ("goforward", os.path.join(DATADIR, "goforward.raw"), 16000, 0, 30),
    ("goforward", os.path.join(DATADIR, "goforward.raw"), 16000, 1, 30),
    ("goforward", os.path.join(DATADIR, "goforward.raw"), 16000, 2, 30),
    ("goforward", os.path.join(DATADIR, "goforward.raw"), 16000, 3, 30),
    ("goforward", os.path.join(DATADIR, "goforward.raw"), 16000, 0, 10),
    ("goforward", os.path.join(DATADIR, "goforward.raw"), 16000, 0, 20),
    ("synth8000", os.path.join(VADG, "synth8000.raw"), 8000, 0, 30),
    ("synth8000", os.path.join(VADG, "synth8000.raw"), 8000, 3, 30),
    ("synth32000", os.path.join(VADG, "synth32000.raw"), 32000, 0, 30),
    ("synth32000", os.path.join(VADG, "synth32000.raw"), 32000, 3, 30),
    ("synth48000", os.path.join(VADG, "synth48000.raw"), 48000, 0, 30),
    ("synth48000", os.path.join(VADG, "synth48000.raw"), 48000, 3, 30),
]


@pytest.mark.parametrize("name,raw_path,rate,mode,ms", CASES,
                         ids=[f"{c[0]}-r{c[2]}-m{c[3]}-f{c[4]}" for c in CASES])
def test_vad_decisions_bitexact(name, raw_path, rate, mode, ms, request):
    if raw_path.startswith(DATADIR):
        request.getfixturevalue("reference")   # skips without the checkout
    raw = np.fromfile(raw_path, np.int16)
    frame_size = rate * ms // 1000
    d = os.path.join(VADG, f"{name}-r{rate}-m{mode}-f{ms}")
    gold = np.fromfile(os.path.join(d, "decisions.u8"), np.uint8)
    core = VadCore(mode)
    got = np.array(
        [core.process(rate, raw[i * frame_size:(i + 1) * frame_size])
         for i in range(len(gold))], np.uint8)
    assert np.array_equal(got, gold)


def test_vad_features_bitexact(reference):
    """Sub-band log energies + total power (vad_filterbank.c) over the
    full goforward utterance at 16 kHz."""
    raw = np.fromfile(os.path.join(DATADIR, "goforward.raw"), np.int16)
    d = os.path.join(VADG, "goforward-r16000-m0-f30")
    gold = np.fromfile(os.path.join(d, "features.i16"), np.int16).reshape(-1, 7)
    core = VadCore(0)
    for i in range(len(gold)):
        frame = [int(v) for v in raw[i * 480:(i + 1) * 480]]
        nb = core._down_by_2(frame, 0)
        feats, total = core.calculate_features(nb)
        assert feats == gold[i, :6].tolist() and total == gold[i, 6], f"frame {i}"
        # keep adapting the GMM state exactly as classify would
        core.gmm_decide(feats, total, len(nb))


def test_vad_wrapper_rate_selection():
    """ps_vad.c closest-supported-rate logic: 44.1 kHz -> 48 kHz frames."""
    v = Vad(sample_rate=44100, frame_length=0.03)
    assert v.frame_size == 1440  # at the closest (48k) rate
    v = Vad(sample_rate=11025)
    assert v.frame_size == 240  # closest is 8000
    with pytest.raises(ValueError):
        Vad(sample_rate=16000, frame_length=0.0301)


def test_endpointer_bitexact_vs_reference(reference):
    """End-to-end endpointer parity: per-frame return/in_speech flags,
    speech_start/speech_end timestamps, and the exact speech samples
    returned (golden from tools/oracle/ep_oracle.c, window=0.3 ratio=0.9
    mode=0 at 16 kHz over goforward.raw)."""
    from soundswallower_tpu.endpointer import Endpointer

    raw = np.fromfile(os.path.join(DATADIR, "goforward.raw"), np.int16)
    d = os.path.join(VADG, "ep-goforward")
    meta = np.fromfile(os.path.join(d, "ep.f64")).reshape(-1, 4)
    gold_speech = np.fromfile(os.path.join(d, "speech.i16"), np.int16)
    ep = Endpointer(window=0.3, ratio=0.9, vad_mode=0, sample_rate=16000)
    n = ep.frame_size
    got_speech = []
    nfull = (len(raw)) // n
    for i in range(nfull):
        out = ep.process(raw[i * n:(i + 1) * n])
        row = meta[i]
        assert (out is not None) == bool(row[0]), f"frame {i} return flag"
        assert ep.in_speech == bool(row[1]), f"frame {i} in_speech"
        assert abs(ep.speech_start - row[2]) < 1e-9, f"frame {i} start"
        assert abs(ep.speech_end - row[3]) < 1e-9, f"frame {i} end"
        if out is not None:
            got_speech.append(out)
    out = ep.end_stream(raw[nfull * n:])
    row = meta[nfull]
    if out is not None:
        got_speech.append(out)
        assert len(out) == int(row[0])
    else:
        assert row[0] == 0
    assert ep.in_speech == bool(row[1])
    assert abs(ep.speech_start - row[2]) < 1e-9
    assert abs(ep.speech_end - row[3]) < 1e-9
    got = np.concatenate(got_speech) if got_speech else np.zeros(0, np.int16)
    assert np.array_equal(got, gold_speech)
