"""Front-end parity tests: bit-exact MFCC and features vs the C reference."""

import numpy as np
import pytest

import os

from tests.conftest import DATADIR, GOLDEN, golden, slow

from soundswallower_tpu.fe.frontend import Frontend
from soundswallower_tpu.fe.feat import feats_full_utt_np, cmn_batch_np


def _fe_8k_band(samprate=16000):
    return Frontend(sampling_rate=samprate, num_filters=20,
                    lower_filt_freq=130, upper_filt_freq=3700,
                    transform="dct", lifter_val=22, remove_noise=True)


CASES = [
    ("goforward-en", f"{DATADIR}/goforward.raw", 16000),
    ("goforward-fr", f"{DATADIR}/goforward_fr.raw", 16000),
    ("austen-en", f"{GOLDEN}/austen.raw", 8000),
]


@pytest.mark.parametrize("name,raw,rate", CASES)
def test_mfcc_bitexact(name, raw, rate, reference):
    fe = _fe_8k_band(rate)
    audio = np.fromfile(raw, dtype=np.int16)
    cep = fe.process_int16(audio)
    gold = golden(name, "mfcc.f32", np.float32, (-1, 13))
    assert cep.shape == gold.shape
    assert (cep == gold).all(), "MFCC must be bit-exact vs C reference"


@pytest.mark.parametrize("name,raw,rate", CASES)
def test_feat_bitexact(name, raw, rate, reference):
    cep = golden(name, "mfcc.f32", np.float32, (-1, 13))
    feat = feats_full_utt_np(cep, cmn_mode="current")
    gold = golden(name, "feat.f32", np.float32, (-1, 3, 13))
    assert (feat == gold).all()


def test_cmn_mean_bitexact():
    cep = golden("goforward-en", "mfcc.f32", np.float32, (-1, 13))
    _, mean = cmn_batch_np(cep)
    gold = golden("goforward-en", "cmn_mean.f32", np.float32)
    assert (mean == gold).all()


def test_frame_counts():
    fe = _fe_8k_band()
    # full frames + zero-padded tail (fe_interface.c:379-391 + fe_end)
    assert fe.n_frames(44580) == 278
    # N=410 = one full frame plus a 250-sample tail frame (fe_end)
    assert fe.n_frames(410) == 2
    assert fe.n_frames(409) == 1
    assert fe.n_frames(0) == 0
    assert fe.n_frames(160) == 1
    assert fe.n_frames(410 + 160) == 3


# -- VTLN frequency warping (fe_warp_*.c) -----------------------------------

WARPS = [("affine", "1.2 150"), ("piecewise", "0.9"), ("inverse", "0.95")]
WARP_TYPE = {"affine": "affine", "piecewise": "piecewise_linear",
             "inverse": "inverse_linear"}


@pytest.mark.parametrize("name,params", WARPS)
def test_warped_melfilters_match_reference(name, params):
    """Filter placement + float32 coefficients vs a C dump (default FE
    config) for each warp function."""
    from soundswallower_tpu.fe.frontend import build_melfilters
    from soundswallower_tpu.fe.warp import Warp

    w = Warp(WARP_TYPE[name], params, 16000)
    spec_start, widths, coeffs = build_melfilters(
        16000, 512, 40, 133.33334, 6855.4976, warp=w)
    path = os.path.join(GOLDEN, "warp", f"melfb_{name}.txt")
    for line in open(path):
        head, vals = line.split(":")
        i, start, width = (int(x) for x in head.split())
        assert spec_start[i] == start, f"filter {i} start"
        assert widths[i] == width, f"filter {i} width"
        gold = np.array([np.float32(v) for v in vals.split()], np.float32)
        assert np.array_equal(coeffs[i], gold), f"filter {i} coeffs"


def test_warp_neutral_and_errors():
    from soundswallower_tpu.fe.warp import Warp

    # No params -> identity for every type (set_parameters(NULL))
    for t in ("affine", "piecewise_linear", "inverse_linear"):
        w = Warp(t, None, 16000)
        assert w.neutral and float(w.unwarped_to_warped(np.float32(440.0))) == 440.0
    # Zero slope -> warping not applied (affine.c:130-134)
    assert Warp("affine", "0 100", 16000).neutral
    with pytest.raises(ValueError):
        Warp("quadratic", "1", 16000)


@slow
@pytest.mark.parametrize("name,params", WARPS)
def test_warped_mfcc_bit_parity(name, params, reference):
    """Full MFCC pipeline with VTLN active vs the C front end (en-us FE
    config, goforward.raw)."""
    from soundswallower_tpu.fe.frontend import Frontend

    raw = np.fromfile(f"{DATADIR}/goforward.raw", np.int16).astype(np.float32)
    fe = Frontend(warp_type=WARP_TYPE[name], warp_params=params,
                  remove_noise=True, lower_filt_freq=130,
                  upper_filt_freq=3700, num_filters=20, lifter_val=22,
                  transform="dct")
    nfr = fe.n_frames(len(raw))
    cep = np.asarray(fe.mfcc(raw, len(raw), nfr))[:nfr]
    gold = np.fromfile(os.path.join(GOLDEN, "warp", f"mfcc_{name}.f32"),
                       np.float32).reshape(-1, 13)
    assert np.array_equal(cep, gold)


def test_spectrogram_matches_js_binding_goldens(reference):
    """spectrogram() parity vs the JS binding's C implementation
    (js/soundswallower.c:88-112, dumped by tools/oracle/spec_oracle.c):
    raw mel log-spectra bit-exact, smoothed (DCT-II/DCT-III round trip,
    fe_sigproc.c:624-637) bit-exact."""
    import numpy as np

    from soundswallower_tpu.decoder import Decoder
    from tests.conftest import golden

    d = Decoder(hmm="/root/reference/model/en-us")
    raw = np.fromfile("/root/reference/tests/data/goforward.raw", np.int16)
    nfilt = d.config.get_int("nfilt")
    want_raw = golden("spec-goforward", "spec_raw.f32", np.float32,
                      (-1, nfilt))
    want_smooth = golden("spec-goforward", "spec_smooth.f32", np.float32,
                         (-1, nfilt))
    got_raw = d.spectrogram(raw)
    assert got_raw.shape == want_raw.shape
    assert np.array_equal(got_raw, want_raw)
    got_smooth = d.spectrogram(raw, smooth=True)
    assert np.array_equal(got_smooth, want_smooth)
