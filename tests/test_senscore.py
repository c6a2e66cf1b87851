"""Senone scoring parity: exact numpy scorer vs C reference golden dumps."""

import numpy as np
import pytest

from tests.conftest import golden

from soundswallower_tpu.ops.senscore import ScorerNp, dist_checkpoints, int_dist


def test_senscore_exact_en(en_us):
    am, _ = en_us
    feat = golden("goforward-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("goforward-en", "senscr.i16", np.int16, (-1, am.n_sen))
    sc = ScorerNp(am)
    for t in range(len(feat)):
        out = sc.frame_eval(feat[t], t)
        assert (out == gold[t]).all(), f"frame {t} senone scores differ"


def test_senscore_exact_fr(fr_fr):
    am, _ = fr_fr
    feat = golden("goforward-fr", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("goforward-fr", "senscr.i16", np.int16, (-1, am.n_sen))
    sc = ScorerNp(am)
    for t in range(len(feat)):
        out = sc.frame_eval(feat[t], t)
        assert (out == gold[t]).all(), f"frame {t} senone scores differ"


def test_topn_state_matches_reference(en_us):
    am, _ = en_us
    feat = golden("goforward-en", "feat.f32", np.float32, (-1, 3, 13))
    topn = golden("goforward-en", "topn.i32", np.int32, (-1, 42, 3, 4, 2))
    sc = ScorerNp(am)
    for t in range(40):
        sc.frame_eval(feat[t], t)
        fi = t % 2
        assert (sc.hist_cw[fi] == topn[t, :, :, :, 0]).all()
        assert (sc.hist_score[fi] == topn[t, :, :, :, 1]).all()


def test_naive_topk_close_to_reference(en_us):
    """The device fast path uses exact top-4 by final distance; quantify its
    divergence from the C early-termination semantics (must stay tiny)."""
    am, _ = en_us
    feat = golden("goforward-en", "feat.f32", np.float32, (-1, 3, 13))
    topn = golden("goforward-en", "topn.i32", np.int32, (-1, 42, 3, 4, 2))
    mism = 0
    total = 0
    for t in range(0, len(feat), 4):
        _, final = dist_checkpoints(am, feat[t])
        di = int_dist(final)
        order = np.argsort(-di, axis=-1, kind="stable")[..., :4]
        same = (np.sort(order, -1) == np.sort(topn[t, :, :, :, 0], -1)).all(-1)
        mism += (~same).sum()
        total += same.size
    assert mism / total < 0.005


def test_ms_senscr_bitexact(ms_en):
    """Fully-continuous (ms) backend compallsen scores vs C oracle run
    with the same synthesized senmgau/mixw (ms_mgau.c ms_cont_mgau_frame_eval
    + ms_senone.c senone_eval + ms_gauden.c compute_dist)."""
    from soundswallower_tpu.ops.senscore import MsScorerNp

    am, _ = ms_en
    assert am.backend == "ms"
    feat = golden("ms-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("ms-en", "senscr.i16", np.int16, (-1, am.n_sen))
    sc = MsScorerNp(am)
    for t in range(0, 30):
        out = sc.frame_eval(feat[t], t)
        assert np.array_equal(out, gold[t]), f"frame {t}"


def test_ms_senscr_active_subset(ms_en):
    """Active-senone path: scores of evaluated senones match compallsen
    values, others keep stale buffer contents (ms_mgau.c:322-368)."""
    from soundswallower_tpu.ops.senscore import MsScorerNp

    am, _ = ms_en
    feat = golden("ms-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("ms-en", "senscr.i16", np.int16, (-1, am.n_sen))
    sc = MsScorerNp(am)
    rng = np.random.RandomState(7)
    sens = np.unique(rng.randint(0, am.n_sen, 300))
    out = sc.frame_eval(feat[0], 0, senone_active=sens)
    # active-subset normalization base differs (min over subset), so
    # compare score *differences* within the subset
    g = gold[0][sens].astype(np.int64)
    o = out[sens].astype(np.int64)
    assert np.array_equal(o - o.min(), g - g.min())
    # non-active senones untouched (stale zero-init buffer)
    mask = np.ones(am.n_sen, bool)
    mask[sens] = False
    assert (out[mask] == 0).all()


def test_semi_senscr_bitexact(semi_en):
    """Semi-continuous backend compallsen scores vs C oracle run with the
    same synthesized single-codebook means/variances (s2_semi_mgau.c
    frame_eval: eval_topn/eval_cb with int final check + mgau_norm +
    get_scores_4b, no best-score subtraction)."""
    am, _ = semi_en
    assert am.backend == "semi"
    feat = golden("semi-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("semi-en", "senscr.i16", np.int16, (-1, am.n_sen))
    sc = ScorerNp(am)
    for t in range(len(feat)):
        out = sc.frame_eval(feat[t], t)
        assert (out == gold[t]).all(), f"frame {t} semi scores differ"


def test_device_semi_score_frames_parity(semi_en):
    """Batched device scorer in semi mode vs the C goldens: same agreement
    standard as the PTM path (the fast path's exact top-4 replaces the
    C 2-frame-seeded early-termination search)."""
    import jax.numpy as jnp

    from soundswallower_tpu.ops.senscore_jax import (
        ScorerTables, score_frames, ungroup)

    am, _ = semi_en
    t = ScorerTables.from_am(am)
    assert t.backend == "semi"
    feat = golden("semi-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("semi-en", "senscr.i16", np.int16, (-1, am.n_sen))
    got = ungroup(t, np.asarray(score_frames(t, jnp.asarray(feat))))
    # With ONE shared codebook a single top-4 set divergence (the dropped
    # early-termination quirk) shifts every senone in that frame, so the
    # right metric is frames bit-exact, not elements (goforward: 277/278;
    # the off frame differs only via a 5th-best codeword swap).
    frames_exact = (got == gold).all(axis=1).mean()
    assert frames_exact >= 0.99, f"only {frames_exact:.4f} frames exact"
    assert (got == gold).mean() > 0.99


def test_ptm_4b_senscr_bitexact(ptm_4b_en):
    """PTM backend with a 4-bit clustered sendump vs the C oracle: the
    nibble select keys on PACKED-BYTE parity (ptm_mgau.c:377, a faithful
    C quirk — compare s2_semi_mgau.c:475 which keys on senone index)."""
    am, _ = ptm_4b_en
    assert am.backend == "ptm" and am.mixw_cb is not None
    feat = golden("ptm4b-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("ptm4b-en", "senscr.i16", np.int16, (-1, am.n_sen))
    sc = ScorerNp(am)
    for t in range(len(feat)):
        out = sc.frame_eval(feat[t], t)
        assert (out == gold[t]).all(), f"frame {t} ptm-4b scores differ"


def test_semi_4b_senscr_bitexact(semi_4b_en):
    """Semi backend with a 4-bit clustered sendump vs the C oracle:
    senone-index-parity nibble decode plus the uint8 w_den truncation
    (s2_semi_mgau.c:452-499)."""
    am, _ = semi_4b_en
    assert am.backend == "semi" and am.mixw_cb is not None
    assert am.mixw_wrap_u8
    feat = golden("semi4b-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("semi4b-en", "senscr.i16", np.int16, (-1, am.n_sen))
    sc = ScorerNp(am)
    for t in range(len(feat)):
        out = sc.frame_eval(feat[t], t)
        assert (out == gold[t]).all(), f"frame {t} semi-4b scores differ"


def test_device_4b_scorers_agree(ptm_4b_en, semi_4b_en):
    """The dense device scorer (ScorerTables.from_am) and the
    graph-restricted scorer (GraphScorer.build) must decode a clustered
    sendump IDENTICALLY — for both backends' conventions.  (Round-3
    advisor finding: from_am used packed-byte parity unconditionally, so
    the two scorers disagreed for semi clustered models.)"""
    from soundswallower_tpu.ops.senscore_jax import GraphScorer, ScorerTables

    for am, _ in (ptm_4b_en, semi_4b_en):
        t = ScorerTables.from_am(am)
        rng = np.random.RandomState(3)
        senid = rng.randint(0, am.n_sen, 60)
        gs = GraphScorer.build(am, t, senid)
        # decoded mixture weights must match column-for-column
        dense = am.mixw_dense()  # [F, D, n_sen]
        mg = np.asarray(t.mixw_g)         # [F, G, D, M]
        M = t.valid_g.shape[1]
        cols = t.sen_remap[senid]
        # non-adjacent advanced indices -> broadcast dim comes first: [S,F,D]
        from_dense = mg[:, cols // M, :, cols % M]
        assert (from_dense.transpose(1, 2, 0) == dense[:, :, senid]).all()
        wsel = np.asarray(gs.wsel.astype(np.float32))  # [F, Cu*D, S]
        D = dense.shape[1]
        cb_pos = np.asarray(gs.cb_pos)
        rows = cb_pos[None, :] * D + np.arange(D)[:, None]
        from_graph = wsel[:, rows, np.arange(len(senid))[None, :]]  # [F,D,S]
        assert (from_graph == dense[:, :, senid]).all()
        assert gs.wrap_u8 == t.wrap_u8 == am.mixw_wrap_u8


def test_device_4b_score_frames_parity(ptm_4b_en):
    """Batched device scorer on the 4-bit clustered model vs the C golden
    (same standard as the 8-bit PTM parity test)."""
    import jax.numpy as jnp

    from soundswallower_tpu.ops.senscore_jax import (
        ScorerTables, score_frames, ungroup)

    am, _ = ptm_4b_en
    t = ScorerTables.from_am(am)
    feat = golden("ptm4b-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("ptm4b-en", "senscr.i16", np.int16, (-1, am.n_sen))
    got = ungroup(t, np.asarray(score_frames(t, jnp.asarray(feat))))
    got = got[: len(gold)]
    frac = (got == gold).mean()
    assert frac > 0.999, f"device 4-bit scorer agreement dropped to {frac}"


def test_device_score_frames_parity(en_us):
    """The batched device scorer (senscore_jax.score_frames) vs the C golden
    compallsen scores.  The fast path intentionally drops eval_cb's
    dynamic-threshold early termination and cross-frame top-N seeding
    (ptm_mgau.c:181-209, 2-frame history ring), which changes a handful
    of top-4 sets; everything else is exact, so the agreement must stay
    above 99.9%."""
    import jax.numpy as jnp

    from soundswallower_tpu.ops.senscore_jax import (
        ScorerTables, score_frames, ungroup)

    am, _ = en_us
    t = ScorerTables.from_am(am)
    # group-split invariants: every senone has a unique slot, each
    # group's slots come from one codebook
    assert len(np.unique(t.sen_remap)) == am.n_sen
    G, M = t.valid_g.shape
    assert M == 128
    cb_of = np.asarray(t.cb_of)
    sen2cb = np.asarray(am.sen2cb)
    assert (cb_of[t.sen_remap // M] == sen2cb).all()

    feat = golden("goforward-en", "feat.f32", np.float32, (-1, 3, 13))
    gold = golden("goforward-en", "senscr.i16", np.int16, (-1, am.n_sen))
    got = ungroup(t, np.asarray(score_frames(t, jnp.asarray(feat))))
    got = got[: len(gold)]
    frac = (got == gold).mean()
    assert frac > 0.999, f"device scorer agreement dropped to {frac}"


def test_graph_scorer_matches_full_scorer_paths(reference):
    """The graph-restricted scorer (GraphScorer) equals the full grouped
    scorer at the graph's senone columns up to a per-frame additive
    constant, EXCEPT where the MAX_NEG_ASCR clamp saturates: the
    restricted norm is <= the full norm, so fewer codeword terms hit the
    96-cap (less saturation than compallsen, like the C reference's own
    active-set scoring).  Assert (a) the deviation beyond the per-frame
    constant stays within the clamp bound, touching only senones whose
    top-N codewords are already >= 96<<SENSCR_SHIFT below the best, and
    (b) the Viterbi paths -- the thing alignment depends on -- are
    identical."""
    import jax.numpy as jnp
    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.ops.senscore_jax import (
        MAX_NEG_ASCR, score_frames, score_frames_graph)

    al = TpuAligner(hmm="/root/reference/model/en-us")
    g = al.graph_for_text("go forward ten meters")
    feat = golden("goforward-en", "feat.f32", np.float32, (-1, 3, 13))
    fj = jnp.asarray(feat)
    T = len(feat)
    full = np.asarray(score_frames(al.tables, fj)).astype(np.int32)
    cols = al.tables.sen_remap[g.senid].reshape(-1)
    sel = full[:, cols]                       # [T, S]
    gs = al._graph_consts(g)["gs"]
    restricted = np.asarray(score_frames_graph(gs, fj))
    d = sel - restricted
    spread = d.max(axis=1) - d.min(axis=1)
    assert spread.max() <= 3 * MAX_NEG_ASCR, spread.max()
    assert np.median(spread) == 0
    # Viterbi paths must agree exactly
    path_full, _ = al._viterbi(g, jnp.asarray(full.astype(np.int16)), T)
    path_r, _ = al._viterbi_graph(g, jnp.asarray(restricted), jnp.int32(T))
    assert (np.asarray(path_full)[:T] == np.asarray(path_r)[:T]).all()


def test_ms_senscr_jax_bitexact(ms_en):
    """The JAX ms scorer (score_frames' ms path: float top-N with
    the C's insertion tie rule, ms_senone rounded shifts + full
    logmath_add, aw truncation, int16-clamped best-subtraction) must
    reproduce the C oracle compallsen scores bit-for-bit."""
    import jax.numpy as jnp

    from soundswallower_tpu.ops.senscore_jax import (ScorerTables,
                                                     score_frames, ungroup)

    am, _ = ms_en
    assert am.backend == "ms"
    feat = golden("ms-en", "feat.f32", np.float32, (-1, 3, 13))[:30]
    gold = golden("ms-en", "senscr.i16", np.int16, (-1, am.n_sen))[:30]
    tables = ScorerTables.from_am(am)
    out = ungroup(tables, np.asarray(score_frames(tables,
                                                  jnp.asarray(feat))))
    assert np.array_equal(out, gold)


def test_ms_1to1_no_senmgau_fallback(tmp_path, reference):
    """The no-senmgau 1:1 senone<->codebook fallback
    (ms_senone.c:225-241): a model whose gauden count equals n_sen maps
    each senone to its own codebook.  Synthesized by expanding the
    fr-fr codebooks per senone; scores must equal the equivalent
    senmgau-mapped model exactly (same Gaussians per senone)."""
    import os
    import sys

    import jax.numpy as jnp

    from soundswallower_tpu import s3file as s3
    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config
    from soundswallower_tpu.ops.senscore_jax import (ScorerTables,
                                                     score_frames, ungroup)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from make_ms_model import make_ms_model

    model = "/root/reference/model/fr-fr"
    mixw_path, senmgau_path = make_ms_model(model, str(tmp_path))

    # A: senmgau-mapped ms model (36 shared codebooks)
    cfg_a = Config(hmm=model, mixw=mixw_path, senmgau=senmgau_path,
                   sendump="")
    cfg_a.expand()
    am_a = AcousticModel.load(cfg_a)
    assert am_a.backend == "ms"

    # B: the same Gaussians EXPANDED one codebook per senone, no senmgau
    means, _, n_feat, n_density, veclen = s3.read_gauden_params(
        os.path.join(model, "means"))
    variances, *_ = s3.read_gauden_params(os.path.join(model, "variances"))
    sen2cb = np.asarray(am_a.sen2cb)
    s3.write_gauden_params(str(tmp_path / "means"), means[sen2cb],
                           [13, 13, 13])
    s3.write_gauden_params(str(tmp_path / "variances"), variances[sen2cb],
                           [13, 13, 13])
    cfg_b = Config(hmm=model, mixw=mixw_path, sendump="",
                   mean=str(tmp_path / "means"),
                   var=str(tmp_path / "variances"))
    cfg_b.expand()
    am_b = AcousticModel.load(cfg_b)
    assert am_b.backend == "ms"
    assert np.array_equal(np.asarray(am_b.sen2cb),
                          np.arange(am_b.n_sen))

    feat = golden("goforward-fr", "feat.f32", np.float32, (-1, 3, 13))[:5]
    ta = ScorerTables.from_am(am_a)
    tb = ScorerTables.from_am(am_b)
    sa = ungroup(ta, np.asarray(score_frames(ta, jnp.asarray(feat))))
    sb = ungroup(tb, np.asarray(score_frames(tb, jnp.asarray(feat))))
    assert np.array_equal(sa, sb)
