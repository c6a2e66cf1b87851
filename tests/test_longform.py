"""Long-form (>=60 s) alignment.

A seeded utterance of over a minute on the seeded tiny model is pushed
through every long-audio mechanism:

* offline fast path (align_batch) vs sequence-parallel
  align_longform_batch: MUST be segment-identical (same batch-CMN
  full-utterance semantics, feat.c:977-1007);
* streaming AlignStream: live-CMN semantics (cmn_live.c) — by design
  NOT identical to the full-utterance path, exactly like the
  reference's live vs full-utt modes; asserted invariants are
  chunk-size independence, mid-stream checkpoint/restore equivalence
  (decoder_get_cmn/set_cmn analog), and segmentation structure;
* the exact two-pass decoder anchors the fast path on a multi-clip
  concatenation of the reference's long-form oracle (the Austen
  utterance, golden tests/golden/austen-en) in the SST_SLOW tier.
"""

import os

import numpy as np
import pytest

from tests.conftest import GOLDEN, slow

AUSTEN = "he was not an ill disposed young man"


def _aligner(reference):
    from soundswallower_tpu.aligner import TpuAligner

    return TpuAligner(hmm=os.path.join(reference, "en-us"), samprate=8000)


def _segs(segs):
    return [(s.word, s.start, s.duration) for s in segs]


@pytest.fixture(scope="module")
def long_utt(tiny_model):
    """A seeded utterance of just over a minute."""
    audio, text = tiny_model[1].pair(np.random.default_rng(61), 61.0)
    assert len(audio) / 16000.0 > 60.0
    return audio, text


def _check_structure(al, segs, audio, text):
    words = [s for s in segs if s.word != "<sil>"]
    assert [w.word.split("(")[0] for w in words] == text.split()
    # segmentation invariants (test_word_align.c:138-160): words +
    # silences tile the utterance contiguously, phones tile each word
    pos = 0
    for s in segs:
        assert s.start == pos, (s.word, s.start, pos)
        pos += s.duration
        pstart = s.start
        for (ci, ps, pd, _sc) in s.phones:
            assert ps == pstart
            pstart += pd
        assert pstart == s.start + s.duration
    assert pos == al.fe.n_frames(len(audio))


def test_longform_60s_offline_and_seqparallel(tiny_aligner, long_utt):
    audio, text = long_utt
    al = tiny_aligner

    base = al.align_batch([audio], [text])[0]
    assert base is not None
    _check_structure(al, base, audio, text)

    # sequence parallel (frame axis sharded over all local devices,
    # ring-carried Viterbi): bit-identical segments
    sp = al.align_longform_batch([audio], [text])[0]
    assert sp is not None
    assert _segs(sp) == _segs(base)


def test_longform_streaming_chunk_invariance_and_restore(
        tiny_aligner, tiny_model, long_utt):
    # chunk-size invariance holds below the live-CMN high-water mark:
    # the reference's cmn_live checks the window AFTER each processed
    # block (cmn_live.c:107-135) and cmninit primes nframe at
    # CMN_WIN=500, so past ~300 frames the shift point — and thus the
    # mean — legitimately depends on push granularity, in C exactly as
    # here.
    audio2, text2 = tiny_model[1].pair(np.random.default_rng(62), 1.8)
    assert tiny_aligner.fe.n_frames(len(audio2)) < 300
    al = tiny_aligner
    st = al.stream(text2)
    for i in range(0, len(audio2), 3200):
        st.push(audio2[i:i + 3200])
    inv_a = st.end()
    st = al.stream(text2)
    for i in range(0, len(audio2), 17000):
        st.push(audio2[i:i + 17000])
    inv_b = st.end()
    assert _segs(inv_b) == _segs(inv_a)

    audio, text = long_utt            # past a minute: live-CMN decay
    st = al.stream(text)
    for i in range(0, len(audio), 3200):
        st.push(audio[i:i + 3200])
    segs_a = st.end()
    _check_structure(al, segs_a, audio, text)

    # checkpoint mid-stream, restore in a NEW stream object, continue
    from soundswallower_tpu.streaming import AlignStream

    st = al.stream(text)
    half = (len(audio) // 2) // 3200 * 3200
    for i in range(0, half, 3200):
        st.push(audio[i:i + 3200])
    ckpt = st.state()
    st2 = AlignStream.restore(al, ckpt)
    for i in range(half, len(audio), 3200):
        st2.push(audio[i:i + 3200])
    segs_c = st2.end()
    assert _segs(segs_c) == _segs(segs_a)


def _viterbi_windows(al, g, audio, windows):
    """Best path + score over graph ``g`` with each word's nodes
    optionally constrained to its reference window (``windows`` =
    [(word, sf, ef)] incl. <sil> rows, or None for unconstrained).
    Shared scorer, so scores of the two runs are directly comparable:
    the unconstrained run is the global Viterbi optimum, the
    constrained run is the best path consistent with the reference's
    word segmentation (the two-pass decoder's pass-2 window rule,
    state_align_search.c sf/ef)."""
    import jax.numpy as jnp

    from soundswallower_tpu.fe.feat import feats_full_utt
    from soundswallower_tpu.ops.align_jax import (
        WORST_SCORE, align_viterbi, backtrace, build_pred_table)
    from soundswallower_tpu.ops.senscore_jax import score_frames_graph

    T = al.fe.n_frames(len(audio))
    Tpad = max(64, -(-T // 64) * 64)
    cep = al.native_fe.process_batch(
        np.asarray(audio)[None], np.array([len(audio)]), Tpad)[0]
    feats = feats_full_utt(jnp.asarray(cep), jnp.int32(T),
                           al.config["cmn"])
    c = al._graph_consts(g)
    sen = score_frames_graph(c["gs"], feats)               # [Tpad, S]
    ast = np.asarray(g.astart).copy()
    aen = np.asarray(g.aend).copy()
    if windows is not None:
        wi = 0
        for (w, sf, ef) in windows:
            if w.startswith("<") or w.startswith("["):
                continue
            m = np.asarray(g.word_of) == wi
            ast[m] = np.maximum(ast[m], sf)
            # ef + 1: the kernel hands a word off at frame ef
            # only if it is still active at ef + 1 (active_next
            # gating in make_vit_step)
            aen[m] = np.minimum(aen[m], ef + 1)
            wi += 1
    P, E = g.senid.shape
    ident = np.arange(P * E, dtype=np.int32).reshape(P, E)
    pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst, g.edge_pen, P)
    entry = np.where(g.is_entry, g.entry_pen, WORST_SCORE).astype(np.int32)
    tp = np.asarray(al.am.tmat.astype(np.int32))[g.tmatid]
    tok, _, out_score, out_hist = align_viterbi(
        sen, jnp.asarray(ident), jnp.asarray(tp), jnp.asarray(pi),
        jnp.asarray(pp), jnp.asarray(pk), jnp.asarray(ast),
        jnp.asarray(aen), jnp.int32(T), jnp.asarray(entry), False)
    fin = np.asarray(g.final_nodes)
    # a window-deactivated final node retains its last (stale) exit
    # score; only nodes still active at T-1 can legitimately finish
    fsc = np.where(aen[fin] >= T - 1, np.asarray(out_score)[fin],
                   WORST_SCORE)
    b = int(np.argmax(fsc))
    path, _ = backtrace(tok, None,
                        jnp.int32(int(np.asarray(out_hist)[fin[b]])),
                        jnp.int32(int(fsc[b])), jnp.int32(T))
    segs = al._extract(g, np.asarray(path), T, int(fsc[b]))
    return int(fsc[b]), segs


@slow
def test_longform_exact_two_pass_parity(reference):
    """Fast path vs the exact two-pass decoder on a multi-clip Austen
    concatenation (the reference's own long-form check is
    word-boundary based, test_word_align.c:62).  The two-pass search
    can pick slightly different boundaries where its pass-1 windows
    constrain pass-2; the fast path's divergence is PROVEN principled:
    the best path constrained to the exact decoder's word windows
    reproduces its boundaries but scores no better than the
    unconstrained global optimum under the identical scorer."""
    from soundswallower_tpu.decoder import Decoder

    raw = np.fromfile(f"{GOLDEN}/austen.raw", np.int16)
    k = 2
    audio = np.tile(raw, k)
    text = " ".join([AUSTEN] * k)

    d = Decoder(hmm=os.path.join(reference, "en-us"), samprate=8000)
    d.set_align_text(text)
    d.start_utt()
    d.process_raw(audio)
    d.end_utt()
    exact = [(s["word"], s["sf"], s["ef"]) for s in d.seg_iter()]

    al = _aligner(reference)
    fast = al.align_batch([audio], [text])[0]
    got = [(s.word, s.start, s.start + s.duration - 1) for s in fast]
    # same words, boundaries within a tight tolerance
    assert [w for w, _, _ in got] == [w for w, _, _ in exact]
    for (w, sf, ef), (w2, sf2, ef2) in zip(got, exact):
        assert abs(sf - sf2) <= 3 and abs(ef - ef2) <= 3, (
            (w, sf, ef), (w2, sf2, ef2))

    g = al.graph_for_text(text)
    free_score, free_segs = _viterbi_windows(al, g, audio, None)
    assert [(s.word, s.start, s.start + s.duration - 1)
            for s in free_segs] == got
    con_score, con_segs = _viterbi_windows(al, g, audio, exact)
    con = [(s.word, s.start, s.start + s.duration - 1) for s in con_segs]
    # The exact decoder's own path is FEASIBLE in the constrained
    # problem (its words lie in their windows; silences are
    # unconstrained), so score(exact-path) <= con_score <= free_score:
    # the fast path's divergence can only be toward a better-scoring
    # segmentation.  The constrained optimum tracks the exact
    # boundaries to within a frame (its remaining freedom is optional
    # silence placement INSIDE a window, which pass-2's fixed phone
    # chain does not have).
    exact_w = [x for x in exact if not x[0].startswith("<")]
    con_w = [x for x in con if not x[0].startswith("<")]
    assert [w for w, _, _ in con_w] == [w for w, _, _ in exact_w]
    for (w, sf, ef), (_, sf2, ef2) in zip(con_w, exact_w):
        assert sf >= sf2 and ef <= ef2 + 1, ((w, sf, ef), (sf2, ef2))
        assert abs(sf - sf2) <= 3 and abs(ef - ef2) <= 3
    assert free_score >= con_score
