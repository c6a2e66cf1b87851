"""Single-pass device aligner: graph + Viterbi kernel parity.

Two tiers.  The C-oracle tests feed the reference's own (compallsen)
senone scores into the phone-graph Viterbi, isolating graph
construction + DP + backtrace + segment extraction; word boundaries
must match the reference two-pass segs exactly (they need the reference
model).  The self-consistency tests (batch == single, mixed == single,
dense == union, native == Python extraction) run on the seeded tiny
model with seeded audio."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import DATADIR, GOLDEN, golden

from soundswallower_tpu.aligner import TpuAligner


def _ref_segs(name):
    segs = []
    for line in open(f"{GOLDEN}/{name}/segs.txt"):
        w, sf, ef, ascr, lscr = line.split()
        segs.append((w, int(sf), int(ef)))
    return segs


@pytest.fixture(scope="module")
def ref_aligner(reference):
    return TpuAligner(hmm=os.path.join(reference, "en-us"))


@pytest.fixture(scope="module")
def aligner(tiny_model):
    return TpuAligner(hmm=tiny_model[0])


@pytest.fixture(scope="module")
def utts(tiny_model):
    """Seeded (audio, transcript) pairs."""
    corpus = tiny_model[1]
    rng = np.random.default_rng(51)
    return [corpus.pair(rng, 2.5) for _ in range(4)]


def _grouped_senscr(aligner, name):
    """Reference senone scores scattered into the scorer's grouped
    layout (pad columns get 0 like C's unevaluated senones)."""
    raw = golden(name, "senscr.i16", np.int16, (-1, aligner.am.n_sen))
    G = int(np.prod(aligner.tables.group_shape))
    out = np.zeros((len(raw), G), np.int16)
    out[:, aligner.tables.sen_remap] = raw
    return out


def test_graph_structure(aligner, utts):
    g = aligner.graph_for_text(utts[0][1])
    assert g.is_entry.sum() >= 2  # leading silence + first word
    assert len(g.final_nodes) >= 2  # last word + trailing silence
    # edges sorted by dst and acyclic forward
    assert (np.diff(g.edge_dst) >= 0).all()
    assert (g.edge_src < g.edge_dst).all()


def test_align_viterbi_matches_reference_goforward(ref_aligner):
    aligner = ref_aligner
    senscr = _grouped_senscr(aligner, "goforward-en")
    T = len(senscr)
    g = aligner.graph_for_text("go forward ten meters")
    path, final_sc = aligner._viterbi(g, jnp.asarray(senscr), T)
    segs = aligner._extract(g, np.asarray(path), T, int(final_sc))
    got = [(s.word, s.start, s.start + s.duration - 1) for s in segs]
    # reference two-pass boundaries (note: the reference used active-set
    # scoring; compallsen scores shift normalization per frame by a
    # constant, which cancels in the argmax path)
    assert got == _ref_segs("goforward-en")


def test_align_batch_matches_single(aligner, utts, tiny_model):
    """align_batch (the default host-FE path) must produce exactly the
    segments of per-utterance align(), including for padded shorter
    utterances."""
    raw, text = utts[0]
    texts = [text] * 3
    audios = [raw, tiny_model[1].audio(text, np.random.default_rng(52)),
              raw]
    singles = [aligner.align(a, t) for a, t in zip(audios, texts)]
    batch = aligner.align_batch(audios, texts)
    for got, want in zip(batch, singles):
        assert ([(s.word, s.start, s.duration) for s in got]
                == [(s.word, s.start, s.duration) for s in want])
    # mixed-transcript path
    mixed = aligner.align_batch([raw, utts[1][0]], [text, utts[1][1]])
    assert [s.word for s in mixed[0] if s.word != "<sil>"] == text.split()
    assert [s.word for s in mixed[1] if s.word != "<sil>"] == \
        utts[1][1].split()


def test_mixed_batch_single_dispatch_matches_single(aligner, tiny_model):
    """A batch of DIFFERENT transcripts (the ReadAlongs workload shape:
    one transcript per document, js/api.js:491) through the multi-graph
    single-dispatch path must reproduce per-utterance align() exactly —
    words, phones, boundaries — whatever else shares the batch."""
    corpus = tiny_model[1]
    rng = np.random.default_rng(53)
    cases = [corpus.pair(rng, rng.uniform(0.5, 3.0)) for _ in range(7)]
    audios = [a for a, _ in cases]
    texts = [t for _, t in cases]
    mixed = aligner.align_batch(audios, texts)
    for i, (a, t) in enumerate(cases):
        single = aligner.align(a, t)
        assert mixed[i] is not None, f"case {i} failed to align"
        got = [(s.word, s.start, s.duration,
                tuple(p[:3] for p in s.phones)) for s in mixed[i]]
        want = [(s.word, s.start, s.duration,
                 tuple(p[:3] for p in s.phones)) for s in single]
        assert got == want, f"case {i} ({t}) diverged from single-path"


def test_mixed_batch_unknown_word_isolated(aligner, utts):
    """An unknown word fails only ITS row (None), not the batch."""
    (raw, text), (raw2, text2) = utts[:2]
    out = aligner.align_batch(
        [raw, raw, raw2], [text, "xyzzyplugh " + text, text2])
    assert out[0] is not None and out[2] is not None
    assert out[1] is None
    assert [s.word for s in out[0] if s.word != "<sil>"] == text.split()


def test_stack_graphs_size_classes(aligner, tiny_model):
    """stack_graphs pads to bounded (P, K) size classes and its pad
    rows/slots can never win: re-stacking a batch with one extra small
    graph keeps the same class, and the per-row tensors of a graph are
    independent of its batch neighbors."""
    from soundswallower_tpu.ops.align_graph import stack_graphs

    w = tiny_model[1].words
    g1 = aligner.graph_for_text(" ".join(w[:4]))
    g2 = aligner.graph_for_text(" ".join(w[:2]))
    g3 = aligner.graph_for_text(w[3])
    tmat = aligner.am.tmat.astype(np.int32)
    remap = aligner.tables.sen_remap
    a = stack_graphs([g1, g2], tmat, remap)
    b = stack_graphs([g1, g3, g2], tmat, remap)
    assert a["P"] % 32 == 0 and a["K"] % 2 == 0
    assert a["P"] == b["P"] and a["K"] == b["K"]  # same size class
    # row tensors identical regardless of neighbors
    for k in ("tp", "pred_idx", "pred_pen", "pred_ok", "astart", "aend",
              "entry", "final_mask", "sencols"):
        assert (a[k][0] == b[k][0]).all(), k
        assert (a[k][1] == b[k][2]).all(), k
    # pad rows: inactive windows (astart > aend), WORST entry
    P1 = len(g2.ssid)
    assert (b["astart"][2, P1:] > b["aend"][2, P1:]).all()


def test_align_phone_level_contiguity(ref_aligner):
    aligner = ref_aligner
    senscr = _grouped_senscr(aligner, "goforward-en")
    T = len(senscr)
    g = aligner.graph_for_text("go forward ten meters")
    path, final_sc = aligner._viterbi(g, jnp.asarray(senscr), T)
    segs = aligner._extract(g, np.asarray(path), T, int(final_sc))
    # invariants from test_word_align.c: words contiguous, phones nest
    pos = 0
    for s in segs:
        assert s.start == pos
        pos = s.start + s.duration
        assert s.phones[0][1] == s.start
        plast = s.phones[-1]
        assert plast[1] + plast[2] == s.start + s.duration
    assert pos == T


def test_ms_backend_align_end_to_end(ms_en, reference):
    """TpuAligner on a fully-continuous (ms) model: the aligner routes
    through dense ms scoring (no graph-restricted scorer) + per-row
    gather; boundaries must match the en-us PTM model's on the same
    audio (the synthesized ms model reconstructs the SAME mixture
    weights from the sendump, so the optimum path is the same)."""
    from soundswallower_tpu.aligner import TpuAligner

    _, cfg = ms_en
    raw = np.fromfile(f"{DATADIR}/goforward.raw", np.int16)
    al = TpuAligner(hmm=os.path.join(reference, "en-us"),
                    senmgau=cfg["senmgau"], mixw=cfg["mixw"], sendump="")
    assert al.am.backend == "ms"
    out = al.align_batch([raw, raw], ["go forward ten meters"] * 2)
    assert out[0] is not None and out[1] is not None
    words = [(s.word, s.start, s.duration) for s in out[0]]
    assert words == [(s.word, s.start, s.duration) for s in out[1]]
    ref = TpuAligner(hmm=os.path.join(reference, "en-us"))
    base = ref.align_batch([raw], ["go forward ten meters"])[0]
    got_w = [(s.word, s.start, s.duration) for s in out[0]]
    ref_w = [(s.word, s.start, s.duration) for s in base]
    # same words; boundaries may differ by a frame or two (the ms
    # quantization path reconstructs weights through a float round trip)
    assert [w for w, _, _ in got_w] == [w for w, _, _ in ref_w]
    for (w, s1, d1), (_, s2, d2) in zip(got_w, ref_w):
        assert abs(s1 - s2) <= 3 and abs((s1 + d1) - (s2 + d2)) <= 3, \
            (w, (s1, d1), (s2, d2))


def test_graph_cache_rebuild_and_mllr_invalidation(tmp_path, reference):
    """graph device caches are keyed by a monotonic
    serial (never id(), which can alias after GC), and update_mllr
    invalidates every cache that baked the old Gaussians — alignment
    results must change under the transform and stay self-consistent
    across graph drop/rebuild cycles."""
    import gc
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from make_mllr import make_mllr

    from soundswallower_tpu.aligner import TpuAligner

    raw = np.fromfile(f"{DATADIR}/goforward.raw", np.int16)
    text = "go forward ten meters"
    al = TpuAligner(hmm=os.path.join(reference, "en-us"))

    base = [(s.word, s.start, s.duration)
            for s in al.align_batch([raw], [text])[0]]

    # drop and rebuild graphs repeatedly: serial keys mean a new graph
    # NEVER reuses a dead graph's device constants even if id() aliases
    serials = set()
    for _ in range(3):
        g = al.graph_for_text(text)
        serials.add(g.serial)
        again = [(s.word, s.start, s.duration)
                 for s in al.align_batch([raw], [text])[0]]
        assert again == base
        al._graph_cache.clear()
        gc.collect()
    assert len(serials) == 3          # rebuilt graphs got fresh serials

    # MLLR must invalidate the graph-restricted scorers: the same
    # cached-text alignment must now reflect the transformed Gaussians
    mllr_path = str(tmp_path / "mllr_test")
    make_mllr(mllr_path)
    al.graph_for_text(text)           # populate caches pre-transform
    scored_before = al.align_batch_scored([raw], [text])[0]
    al.update_mllr(mllr_path)
    after = al.align_batch([raw], [text])[0]
    scored_after = al.align_batch_scored([raw], [text])[0]
    assert after is not None
    # scores MUST differ under the transform (stale caches would
    # reproduce the old ones bit-for-bit)
    assert [s.score for s in scored_after] != [s.score for s in scored_before]
    # and a fresh aligner built with the transform agrees exactly
    fresh = TpuAligner(hmm=os.path.join(reference, "en-us"),
                       mllr=mllr_path)
    ref = fresh.align_batch([raw], [text])[0]
    assert [(s.word, s.start, s.duration) for s in after] == \
           [(s.word, s.start, s.duration) for s in ref]


def test_native_extraction_matches_python(aligner, utts):
    """native/sst_seg.cpp batch extraction == the Python _extract on
    same-transcript AND mixed batches (words, starts, durations,
    phones, silence grouping, per-row failure isolation)."""
    raw = utts[0][0]
    texts = [t for _, t in utts]
    # row 3 gets far too little audio for its transcript: a failed row
    audios = [a for a, _ in utts[:3]] + [raw[:3200]]
    h = aligner.align_batch_begin(audios, texts)
    g, Ts, paths_d, pscore_d, final_d, realB = h
    paths = np.asarray(paths_d)
    final_sc = np.asarray(final_d)
    native = aligner._extract_batch_native(g, paths, Ts, realB)
    assert native is not None, "libsst_seg.so missing"
    python = [
        aligner._extract_safe(g[i] if isinstance(g, list) else g,
                              paths[i], int(Ts[i]), int(final_sc[i]))
        for i in range(realB)
    ]
    assert len(native) == len(python)
    for a, b in zip(native, python):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert [(s.word, s.start, s.duration, tuple(p[:3] for p in s.phones))
                for s in a] == \
               [(s.word, s.start, s.duration, tuple(p[:3] for p in s.phones))
                for s in b]


def test_fr_batch_alignment(reference):
    """BASELINE config 3: fr-fr batch forced alignment — batched rows
    must equal the single-utterance path exactly (different senone
    inventory/codebook count exercises the scorer's other shape
    class)."""
    from soundswallower_tpu.aligner import TpuAligner

    al = TpuAligner(hmm=os.path.join(reference, "fr-fr"),
                    dict=os.path.join(reference, "fr-fr", "dict.txt"))
    raw = np.fromfile(f"{DATADIR}/goforward_fr.raw", np.int16)
    text = "avance de dix mètres"
    single = al.align(raw, text)
    out = al.align_batch([raw] * 8, [text] * 8)
    assert all(o is not None for o in out)
    want = [(s.word, s.start, s.duration) for s in single]
    for segs in out:
        assert [(s.word, s.start, s.duration) for s in segs] == want
    # mixed fr batch
    mout = al.align_batch([raw, raw], [text, "avance de dix mètres"])
    assert all(o is not None for o in mout)


def test_mixed_dense_fallback_matches_union(aligner, utts):
    """Once the working set covers most of the senone inventory the
    mixed path falls back to dense scoring; both scorers must yield
    identical segments (each row is normalized over its own graph's
    codebooks in both, and the per-frame best-senone shift cancels in
    the Viterbi argmax)."""
    texts = [t for _, t in utts]
    audios = [a for a, _ in utts]
    base = aligner.align_batch(audios, texts)       # union scorer
    uni = aligner._union_scorer([aligner.graph_for_text(t) for t in texts])
    assert uni is not None                           # union path active
    try:
        aligner._uni["dense"] = True                 # force dense
        dense = aligner.align_batch(audios, texts)
    finally:
        aligner._uni["dense"] = False
    for a, b in zip(base, dense):
        assert (a is None) == (b is None)
        if a is not None:
            assert [(s.word, s.start, s.duration) for s in a] == \
                   [(s.word, s.start, s.duration) for s in b]
