"""Sequence-parallel (ring-carried) Viterbi: bit-parity vs single device.

Runs the wavefront-pipelined chunked forward + backtrace over an
8-virtual-device ('seq',) CPU mesh and compares the decoded state paths
and final scores against the single-device scan on the same inputs —
they share the per-frame step function, so equality must be exact.
The inputs are the seeded tiny model's scores of a seeded utterance;
the golden-segment test needs the reference model.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.conftest import GOLDEN, golden

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.ops.align_jax import (
    WORST_SCORE, align_viterbi, backtrace, build_pred_table)
from soundswallower_tpu.parallel.seqpipe import align_longform, seq_mesh


def _grouped(al, raw):
    """[T, n_sen] scores -> the scorer's grouped column layout."""
    G = int(np.prod(al.tables.group_shape))
    sen = np.zeros((len(raw), G), np.int16)
    sen[:, al.tables.sen_remap] = raw
    return sen


@pytest.fixture(scope="module")
def utt(tiny_model):
    return tiny_model[1].pair(np.random.default_rng(31), 3.0)


@pytest.fixture(scope="module")
def setup(tiny_aligner, utt):
    al = tiny_aligner
    audio, text = utt
    g = al.graph_for_text(text)
    return al, g, _grouped(al, al._dense_scores_utt(audio))


@pytest.fixture(scope="module")
def ref_setup(reference):
    al = TpuAligner(hmm=os.path.join(reference, "en-us"))
    g = al.graph_for_text("go forward ten meters")
    raw = golden("goforward-en", "senscr.i16", np.int16, (-1, al.am.n_sen))
    return al, g, _grouped(al, raw)


def _args(al, g):
    pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst, g.edge_pen,
                                  len(g.senid))
    senid = al.tables.sen_remap[g.senid].astype(np.int32)
    tp = np.asarray(al.am.tmat.astype(np.int32))[g.tmatid]
    entry = np.where(g.is_entry, g.entry_pen, WORST_SCORE).astype(np.int32)
    return senid, tp, pi, pp, pk, g.astart, g.aend, entry


def test_seqpipe_matches_single_device(setup):
    al, g, sen = setup
    senid, tp, pi, pp, pk, ast, aen, entry = _args(al, g)
    nseq = 8
    mesh = seq_mesh(nseq)

    # batch of 5 utterances with different lengths (same senscr source,
    # truncated) so the wavefront handles ragged n_frames
    T_real = len(sen)
    lens = [T_real, T_real - 17, T_real - 40, T_real - 60, T_real - 5]
    B = len(lens)
    Tpad = -(-T_real // (nseq * 8)) * (nseq * 8)
    batch = np.zeros((B, Tpad, sen.shape[1]), np.int16)
    for i, L in enumerate(lens):
        batch[i, :L] = sen[:L]
    nfr = np.asarray(lens, np.int32)

    path_sp, score_sp = align_longform(
        mesh, batch, senid, tp, pi, pp, pk, ast, aen, nfr, entry,
        g.final_nodes)
    path_sp, score_sp = np.asarray(path_sp), np.asarray(score_sp)

    for i, L in enumerate(lens):
        tok_id, _, out_score, out_hist = align_viterbi(
            jnp.asarray(batch[i]), jnp.asarray(senid), jnp.asarray(tp),
            jnp.asarray(pi), jnp.asarray(pp), jnp.asarray(pk),
            jnp.asarray(ast), jnp.asarray(aen), jnp.int32(L),
            jnp.asarray(entry), False)
        fin = jnp.asarray(g.final_nodes)
        best = jnp.argmax(out_score[fin])
        node = fin[best]
        path, _ = backtrace(tok_id, None, out_hist[node],
                            out_score[node], jnp.int32(L))
        path = np.asarray(path)
        assert int(out_score[node]) == int(score_sp[i]), f"utt {i} score"
        assert (path == path_sp[i]).all(), f"utt {i} path differs"


def test_seqpipe_segments_match_reference(ref_setup):
    """End to end: sequence-parallel path -> segment extraction ->
    reference two-pass boundaries."""
    al, g, sen = ref_setup
    senid, tp, pi, pp, pk, ast, aen, entry = _args(al, g)
    mesh = seq_mesh(8)
    T = len(sen)
    Tpad = -(-T // 64) * 64
    batch = np.zeros((1, Tpad, sen.shape[1]), np.int16)
    batch[0, :T] = sen
    path, score = align_longform(
        mesh, batch, senid, tp, pi, pp, pk, ast, aen,
        np.asarray([T], np.int32), entry, g.final_nodes)
    segs = al._extract(g, np.asarray(path[0]), T, int(score[0]))
    got = [(s.word, s.start, s.start + s.duration - 1) for s in segs]
    ref = []
    for line in open(os.path.join(GOLDEN, "goforward-en", "segs.txt")):
        w, sf, ef, ascr, lscr = line.split()
        ref.append((w, int(sf), int(ef)))
    assert got == ref


def test_align_longform_batch_matches_align_batch(setup, utt, tiny_model):
    """The public longform API must reproduce align_batch exactly: same
    wire format, same graph-restricted scorer, ring-carried Viterbi."""
    al, _, _ = setup
    raw, text = utt
    texts = [text] * 2
    audios = [raw, tiny_model[1].audio(text, np.random.default_rng(32))]
    want = al.align_batch(audios, texts)
    got = al.align_longform_batch(audios, texts)
    for w, g2 in zip(want, got):
        assert [(s.word, s.start, s.duration) for s in g2] == \
            [(s.word, s.start, s.duration) for s in w]
