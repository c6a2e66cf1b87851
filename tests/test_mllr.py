"""MLLR adaptation parity vs the C reference.

Goldens in tests/golden/mllr-en were produced by the C oracle with the
same synthesized transform (tools/make_mllr.py seed 42, written to the
ps_mllr.c text format): the reference applies it at decoder init via
acmod_update_mllr (acmod.c:316-325) -> gauden_mllr_transform
(ms_gauden.c:460-539), and the dumped compallsen senone scores reflect
the transformed means/variances.  Our apply_mllr must match them
bit-for-bit."""

import os
import sys

import numpy as np
import pytest

from tests.conftest import MODELDIR, golden


@pytest.fixture(scope="module")
def mllr_en(tmp_path_factory, reference):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_mllr import make_mllr

    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config

    path = str(tmp_path_factory.mktemp("mllr") / "mllr_test")
    make_mllr(path)
    cfg = Config(hmm=os.path.join(MODELDIR, "en-us"))
    cfg.expand()
    am = AcousticModel.load(cfg)
    return am, cfg, path


def test_mllr_senscr_bitexact(mllr_en):
    """Senone scores after update_mllr match the C oracle exactly."""
    from soundswallower_tpu.mllr import Mllr, apply_mllr
    from soundswallower_tpu.ops.senscore import ScorerNp

    am, cfg, path = mllr_en
    before = am.means.copy()
    apply_mllr(am, Mllr(path), cfg)
    assert not np.array_equal(before, am.means), "transform was a no-op"
    feat = golden("mllr-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("mllr-en", "senscr.i16", np.int16, (-1, am.n_sen))
    sc = ScorerNp(am)
    for t in range(len(feat)):
        out = sc.frame_eval(feat[t], t)
        assert (out == gold[t]).all(), f"frame {t} mllr scores differ"


def test_mllr_device_scorer_parity(mllr_en):
    """The batched device scorer built from the TRANSFORMED model agrees
    with the C goldens to the same standard as the un-adapted path
    (exact top-4 replaces the C early-termination search)."""
    import jax.numpy as jnp

    from soundswallower_tpu.ops.senscore_jax import (
        ScorerTables, score_frames, ungroup)

    am, cfg, path = mllr_en  # apply_mllr already ran (module fixture order)
    t = ScorerTables.from_am(am)
    feat = golden("mllr-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("mllr-en", "senscr.i16", np.int16, (-1, am.n_sen))
    got = ungroup(t, np.asarray(score_frames(t, jnp.asarray(feat))))
    got = got[: len(gold)]
    frac = (got == gold).mean()
    assert frac > 0.999, f"device scorer agreement after MLLR dropped to {frac}"


def test_mllr_two_pass_alignment_matches(mllr_en):
    """Word boundaries from the reference's MLLR-adapted two-pass run
    (segs.txt) match our device aligner with update_mllr applied."""
    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.mllr import Mllr, apply_mllr
    from tests.conftest import GOLDEN

    al = TpuAligner(hmm=os.path.join(MODELDIR, "en-us"))
    _, _, path = mllr_en
    apply_mllr(al.am, Mllr(path), al.config)
    # rebuild device tables from the transformed model
    from soundswallower_tpu.ops.senscore_jax import ScorerTables
    al.tables = ScorerTables.from_am(al.am)
    raw = np.fromfile("/root/reference/tests/data/goforward.raw", np.int16)
    segs = al.align(raw, "go forward ten meters")
    got = [(s.word, s.start, s.start + s.duration - 1) for s in segs]
    want = []
    for line in open(f"{GOLDEN}/mllr-en/segs.txt"):
        w, sf, ef, ascr, lscr = line.split()
        want.append((w, int(sf), int(ef)))
    assert got == want
