"""device grammar decoder: static decode graph + dense Viterbi vs the C
reference's beam search (tools/oracle goldens, JSGF grammars).

The graph compiles the full search space (triphone context expansion,
alt pronunciations, silence self-loops, null-closure) and dense Viterbi
finds the global optimum — hyp and word boundaries must match the
reference's beam search output on its test grammars.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import DATADIR, GOLDEN, golden

from soundswallower_tpu.aligner import TpuAligner


def _ref_segs(name):
    out = []
    for line in open(f"{GOLDEN}/{name}/segs.txt"):
        w, sf, ef, ascr, lscr = line.split()
        if w == "(NULL)":          # history artifact of null transitions
            continue
        out.append((w, int(sf), int(ef)))
    return out


def _grouped(al, name):
    raw = golden(name, "senscr.i16", np.int16, (-1, al.am.n_sen))
    G = int(np.prod(al.tables.group_shape))
    out = np.zeros((len(raw), G), np.int16)
    out[:, al.tables.sen_remap] = raw
    return out


def _decode_with_golden_scores(al, name):
    g = al._decode_graph
    sen = _grouped(al, name)
    T = len(sen)
    path, _ = al._viterbi(g, jnp.asarray(sen), T)
    segs = al._extract_decode(g, np.asarray(path), T)
    hyp = " ".join(al.dict.wordstr(al.dict.basewid_of(s.wid))
                   for s in segs if not al.dict.filler_word(s.wid))
    return hyp, [(s.word, s.start, s.start + s.duration - 1) for s in segs]


@pytest.fixture(scope="module")
def en(reference):
    return TpuAligner(hmm="/root/reference/model/en-us")


def test_jsgf_decode_matches_reference_en(en):
    """goforward.gram on the reference's own senone scores: hyp and
    every word boundary equal to the C beam search."""
    en.set_grammar(jsgf_file=f"{DATADIR}/goforward.gram")
    hyp, segs = _decode_with_golden_scores(en, "fsg-goforward")
    assert hyp == "go forward ten meters"
    assert segs == _ref_segs("fsg-goforward")


def _decode_score_windows(al, name, windows):
    """Best final score of the decode graph under the golden senone
    scores, with each non-filler word's nodes optionally constrained to
    its reference window — the machinery that PROVES boundary
    divergences principled: the reference's own path is feasible in the
    constrained problem, so score(ref) <= constrained optimum <=
    unconstrained optimum (the dense decode)."""
    from soundswallower_tpu.ops.align_jax import (
        WORST_SCORE, align_viterbi, build_pred_table)

    g = al._decode_graph
    sen = jnp.asarray(_grouped(al, name))
    T = sen.shape[0]
    ast = np.asarray(g.astart).copy()
    aen = np.asarray(g.aend).copy()
    if windows is not None:
        wo = np.asarray(g.word_of)
        names = np.asarray([al.dict.wordstr(int(v)) if int(w) >= 0 else ""
                            for v, w in zip(g.variant_of, g.word_of)])
        for (w, sf, ef) in windows:
            if w.startswith("<") or w.startswith("(") or w.startswith("["):
                continue
            m = (names == w) & (wo >= 0)
            assert m.any(), w
            ast[m] = np.maximum(ast[m], sf)
            # ef + 1: the kernel hands a word off at frame ef
            # only if it is still active at ef + 1 (active_next
            # gating in make_vit_step)
            aen[m] = np.minimum(aen[m], ef + 1)
    entry = np.where(g.is_entry, g.entry_pen, WORST_SCORE).astype(np.int32)
    senid_g = al.tables.sen_remap[g.senid].astype(np.int32)
    pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst, g.edge_pen,
                                  len(g.senid))
    _, _, out_score, _ = align_viterbi(
        sen, jnp.asarray(senid_g),
        jnp.asarray(np.asarray(al.am.tmat.astype(np.int32))[g.tmatid]),
        jnp.asarray(pi), jnp.asarray(pp), jnp.asarray(pk),
        jnp.asarray(ast), jnp.asarray(aen), jnp.int32(T),
        jnp.asarray(entry), False)
    fin = np.asarray(g.final_nodes)
    fsc = np.where(aen[fin] >= T - 1, np.asarray(out_score)[fin],
                   WORST_SCORE)
    return int(fsc.max())


def test_jsgf_decode_matches_reference_fr(reference):
    """fr-fr grammar with alternate pronunciations: the reference picks
    de(2)/mètres(4); the dense decode must pick the same variants.
    Boundaries may shift a few frames: dense Viterbi finds a path the
    reference's history-deduplicated beam search misses.  That claim is
    PROVEN, not assumed: under identical scoring, the best path
    constrained to the reference's word windows (which the reference's
    own path satisfies) scores strictly worse than the unconstrained
    dense optimum."""
    al = TpuAligner(hmm="/root/reference/model/fr-fr",
                    dict="/root/reference/model/fr-fr/dict.txt")
    al.set_grammar(jsgf_file=f"{DATADIR}/goforward_fr.gram")
    hyp, segs = _decode_with_golden_scores(al, "fsg-goforward-fr")
    assert hyp == "avance de dix mètres"
    ref = _ref_segs("fsg-goforward-fr")
    assert [s[0] for s in segs] == [r[0] for r in ref]  # words + variants
    diverged = False
    for (w, sf, ef), (_, rsf, ref_) in zip(segs, ref):
        assert abs(sf - rsf) <= 6 and abs(ef - ref_) <= 6, (w, sf, ef)
        diverged |= (sf != rsf or ef != ref_)
    free = _decode_score_windows(al, "fsg-goforward-fr", None)
    con = _decode_score_windows(al, "fsg-goforward-fr", ref)
    assert free >= con
    if diverged:
        assert free > con, (free, con)


def test_jsgf_decode_pizza_branching(en):
    """pizza.gram — the reference's own grammar with real branching
    ambiguity (optionals, alternation lists, a Kleene topping loop) —
    decoded against mismatched (goforward) audio on the reference's
    senone scores.  This is an adversarial knife-edge case: the C
    itself answers differently at different beam settings ('yo four
    large tomatoes' at defaults, 'yo four meat lover's' exhaustive),
    and the top alternatives sit ~1-15 shifted-log units apart (~0.01%
    of the path score).  The meaningful contract is score dominance,
    asserted via the window-constrained rescore: the best path
    consistent with the C's segmentation — which the C's own path is —
    cannot beat the dense optimum.  (The byte-exact beam-search port in
    search_fsg.py reproduces the C verbatim at both beam settings;
    see test_decoder_slow.)"""
    en.set_grammar(jsgf_file=f"{DATADIR}/pizza.gram")
    hyp, segs = _decode_with_golden_scores(en, "fsg-pizza")
    ref = _ref_segs("fsg-pizza")
    assert hyp.startswith("yo four")          # the unambiguous prefix
    free = _decode_score_windows(en, "fsg-pizza", None)
    con = _decode_score_windows(en, "fsg-pizza", ref)
    assert free >= con, (free, con)
    if [s[0] for s in segs] != [r[0] for r in ref]:
        assert free > con, (free, con)


def test_jsgf_decode_austen_branching(reference):
    """A branching grammar over the Austen vocabulary (alternatives at
    every position + a Kleene tail) on real matching audio: hyp and
    exact boundaries vs the C beam search."""
    al = TpuAligner(hmm="/root/reference/model/en-us", samprate=8000)
    al.set_grammar(jsgf_file="tests/data/austen_branch.gram")
    hyp, segs = _decode_with_golden_scores(al, "fsg-austen-branch")
    assert hyp == "he was not an ill disposed young man"
    ref = _ref_segs("fsg-austen-branch")
    assert [s[0] for s in segs] == [r[0] for r in ref]
    if segs != ref:
        free = _decode_score_windows(al, "fsg-austen-branch", None)
        con = _decode_score_windows(al, "fsg-austen-branch", ref)
        assert free > con, (free, con)


def test_jsgf_decode_imports(reference):
    """Cross-file rule imports (jsgf.c:740 semantics): a grammar
    importing two rules from a sibling file, decode-parity vs the C
    beam search on the Austen audio."""
    al = TpuAligner(hmm="/root/reference/model/en-us", samprate=8000)
    al.set_grammar(jsgf_file="tests/data/austen_import.gram")
    hyp, segs = _decode_with_golden_scores(al, "fsg-austen-import")
    assert hyp == "he was not an ill disposed young man"
    ref = _ref_segs("fsg-austen-import")
    assert [s[0] for s in segs] == [r[0] for r in ref]
    if segs != ref:
        free = _decode_score_windows(al, "fsg-austen-import", None)
        con = _decode_score_windows(al, "fsg-austen-import", ref)
        assert free > con, (free, con)


def test_decode_end_to_end_audio(en):
    """Full pipeline from raw audio (own FE + scorer, not goldens)."""
    en.set_grammar(jsgf_file=f"{DATADIR}/goforward.gram")
    raw = np.fromfile(f"{DATADIR}/goforward.raw", np.int16)
    hyp, segs = en.decode(raw)
    assert hyp == "go forward ten meters"
    # contiguity
    pos = 0
    for s in segs:
        assert s.start == pos
        pos = s.start + s.duration
    assert pos == en.fe.n_frames(len(raw))


def test_decode_batch(en):
    """Batched grammar decode must match per-utterance decode()."""
    en.set_grammar(jsgf_file=f"{DATADIR}/goforward.gram")
    raw = np.fromfile(f"{DATADIR}/goforward.raw", np.int16)
    single_hyp, single_segs = en.decode(raw)
    batch = en.decode_batch([raw, raw[:20000], raw])
    assert batch[0] is not None and batch[2] is not None
    hyp0, segs0 = batch[0]
    assert hyp0 == single_hyp
    assert ([(s.word, s.start, s.duration) for s in segs0]
            == [(s.word, s.start, s.duration) for s in single_segs])
    assert batch[0][0] == batch[2][0]


def test_decode_fsg_text_format(en):
    """Text-format FSG file (goforward.fsg) through FsgModel.read."""
    from soundswallower_tpu.fsg import FsgModel

    fsg = FsgModel.read_fsg_file(f"{DATADIR}/goforward.fsg", en.lmath,
                                 en.config.get_float("lw"))
    en.set_grammar(fsg=fsg)
    hyp, segs = _decode_with_golden_scores(en, "fsg-goforward")
    assert hyp == "go forward ten meters"


def test_decode_self_loop_grammar(en):
    """A grammar with a Kleene loop (word can repeat): re-entries of the
    same transition must split into separate word segments."""
    en.set_grammar(jsgf_string="""#JSGF V1.0;
grammar loop;
public <cmd> = go (forward | ten | meters)+;
""")
    raw = np.fromfile(f"{DATADIR}/goforward.raw", np.int16)
    hyp, segs = en.decode(raw)
    words = hyp.split()
    assert words[0] == "go"
    assert all(w in ("forward", "ten", "meters") for w in words[1:])
    assert len(words) >= 4  # forward ten meters at least
    pos = 0
    for s in segs:
        assert s.start == pos, (s, pos)
        pos = s.start + s.duration
