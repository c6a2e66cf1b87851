"""5-state HMM topology: device fast path + host scorer vs the C reference.

Goldens in tests/golden/5st-en come from the reference oracle run on the
synthesized 5-state en-us variant (tools/make_5st_model.py: text mdef
with an expanded senone inventory, duplicated-column sendump, and a
deterministic left-to-right-with-skip [n_tmat, 5, 6] transition file).
This exercises hmm_vit_eval_5st_lr (hmm.c:166-305) on the fast path
(ops/align_jax._eval_5st) — both shipped models are 3-state, so without
this tier the 5-state kernels would ship unverified."""

import os
import sys

import numpy as np
import pytest

from tests.conftest import GOLDEN, MODELDIR, golden


@pytest.fixture(scope="module")
def model_5st(tmp_path_factory, reference):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_5st_model import make_5st_model

    outdir = str(tmp_path_factory.mktemp("5st-model"))
    mdef, tmat, sendump = make_5st_model(
        os.path.join(MODELDIR, "en-us"), outdir)
    return dict(hmm=os.path.join(MODELDIR, "en-us"),
                mdef=mdef, tmat=tmat, sendump=sendump)


@pytest.fixture(scope="module")
def aligner_5st(model_5st):
    from soundswallower_tpu.aligner import TpuAligner

    return TpuAligner(**model_5st)


def _ref_segs():
    out = []
    for line in open(f"{GOLDEN}/5st-en/segs.txt"):
        w, sf, ef, ascr, lscr = line.split()
        out.append((w, int(sf), int(ef)))
    return out


def test_5st_model_loads(aligner_5st):
    am = aligner_5st.am
    assert am.mdef.n_emit_state == 5
    assert am.n_sen == am.mdef.n_ciphone * 5 + (am.n_sen - am.mdef.n_ci_sen)
    assert am.tmat.shape[1:] == (5, 6)


def test_5st_senscr_bitexact(model_5st):
    """Expanded-inventory senone scores vs the C oracle (the duplicated
    columns must score identically to their source senones)."""
    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config
    from soundswallower_tpu.ops.senscore import ScorerNp

    cfg = Config(**model_5st)
    cfg.expand()
    am = AcousticModel.load(cfg)
    feat = golden("5st-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("5st-en", "senscr.i16", np.int16, (-1, am.n_sen))
    sc = ScorerNp(am)
    for t in range(0, len(feat), 4):
        out = sc.frame_eval(feat[t], t)
        assert (out == gold[t]).all(), f"frame {t} 5st scores differ"
        sc.frame_eval(feat[min(t + 1, len(feat) - 1)], t + 1)
        sc.frame_eval(feat[min(t + 2, len(feat) - 1)], t + 2)
        sc.frame_eval(feat[min(t + 3, len(feat) - 1)], t + 3)


def test_5st_fast_path_matches_reference(aligner_5st, reference):
    """Single-pass 5-state Viterbi (align_jax._eval_5st via the batch
    pipeline) reproduces the reference's two-pass word boundaries on the
    5-state model."""
    raw = np.fromfile("/root/reference/tests/data/goforward.raw", np.int16)
    segs = aligner_5st.align(raw, "go forward ten meters")
    got = [(s.word, s.start, s.start + s.duration - 1) for s in segs]
    assert got == _ref_segs()


def test_5st_batch_and_mixed_match_single(aligner_5st, reference):
    """Batch lanes kernel (shared graph) and the multi-graph dispatch
    (per-row graphs) both bit-match single-utterance 5-state
    alignment."""
    raw = np.fromfile("/root/reference/tests/data/goforward.raw", np.int16)
    S = 160
    cases = [
        (raw, "go forward ten meters"),
        (raw[: 117 * S], "go forward"),
        (raw[117 * S:], "ten meters"),
    ]
    singles = [aligner_5st.align(a, t) for a, t in cases]
    mixed = aligner_5st.align_batch([a for a, _ in cases],
                                    [t for _, t in cases])
    for i, single in enumerate(singles):
        assert mixed[i] is not None
        assert ([(s.word, s.start, s.duration) for s in mixed[i]]
                == [(s.word, s.start, s.duration) for s in single])
    # same-text batch (shared-graph lanes path)
    batch = aligner_5st.align_batch([raw, raw],
                                    ["go forward ten meters"] * 2)
    for segs in batch:
        assert ([(s.word, s.start, s.duration) for s in segs]
                == [(s.word, s.start, s.duration) for s in singles[0]])
