"""Streaming aligner: chunk-size invariance, checkpoint/resume,
partial results, and agreement with the offline aligner.

The streaming path uses LIVE CMN (cmn_live.c semantics, like the
reference's chunked mode) while the offline aligner uses batch CMN, so
word boundaries may shift slightly between them — the invariant tests
here mirror how the reference treats its own live-vs-batch divergence
(test strategy per SURVEY.md §4).  Chunk-size invariance and resume are
bit-exact requirements: any two chunkings, or a checkpoint/restore at
any point, must produce IDENTICAL segments.
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def aligner(tiny_aligner):
    return tiny_aligner


@pytest.fixture(scope="module")
def utt(tiny_model):
    """A seeded utterance under 3 s (below the live-CMN update point,
    where chunking moves the CMN shift) and its transcript."""
    return tiny_model[1].pair(np.random.default_rng(21), 1.8)


@pytest.fixture(scope="module")
def raw(utt):
    return utt[0]


@pytest.fixture(scope="module")
def TEXT(utt):
    return utt[1]


def _segs(out):
    return [(s.word, s.start, s.duration) for s in out]


def test_stream_chunk_size_invariance(aligner, raw, TEXT):
    results = []
    for chunk in (len(raw), 16000, 1600, 777):
        st = aligner.stream(TEXT)
        for i0 in range(0, len(raw), chunk):
            st.push(raw[i0:i0 + chunk])
        results.append(_segs(st.end()))
    assert results[0] == results[1] == results[2] == results[3]


def test_stream_invariants(aligner, raw, TEXT):
    st = aligner.stream(TEXT)
    st.push(raw)
    segs = st.end()
    words = [s.word for s in segs if s.word != "<sil>"]
    assert words == TEXT.split()
    # contiguity + phone nesting (test_word_align.c invariants)
    pos = 0
    for s in segs:
        assert s.start == pos
        pos = s.start + s.duration
        assert s.phones[0][1] == s.start
        p = s.phones[-1]
        assert p[1] + p[2] == s.start + s.duration
    assert pos == aligner.fe.n_frames(len(raw))


def test_stream_checkpoint_resume(aligner, raw, TEXT):
    from soundswallower_tpu.streaming import AlignStream

    want = None
    st = aligner.stream(TEXT)
    st.push(raw)
    want = _segs(st.end())
    # checkpoint mid-stream at several points, restore, continue
    for cut in (5000, len(raw) // 2, len(raw) - 7999):
        a = aligner.stream(TEXT)
        a.push(raw[:cut])
        ckpt = a.state()
        # simulate crossing a process boundary
        import pickle

        ckpt = pickle.loads(pickle.dumps(ckpt))
        b = AlignStream.restore(aligner, ckpt)
        b.push(raw[cut:])
        assert _segs(b.end()) == want, f"resume at {cut} diverged"


def test_stream_partial_results(aligner, raw, TEXT):
    st = aligner.stream(TEXT)
    st.push(raw[:len(raw) * 4 // 5])   # past one 128-frame Viterbi chunk
    partial = st.result()  # best-so-far backtrace
    assert partial and partial[0].start == 0
    st.push(raw[len(raw) * 4 // 5:])
    final = st.end()
    assert [s.word for s in final if s.word != "<sil>"] == TEXT.split()


def test_stream_agrees_with_offline_on_words(aligner, raw, TEXT):
    """Live CMN vs batch CMN: word sequences must agree and boundaries
    stay within a small tolerance (the reference's own live mode shows
    the same kind of divergence)."""
    st = aligner.stream(TEXT)
    st.push(raw)
    live = [s for s in st.end() if s.word != "<sil>"]
    batch = [s for s in aligner.align(raw, TEXT) if s.word != "<sil>"]
    assert [s.word for s in live] == [s.word for s in batch]
    for a, b in zip(live, batch):
        assert abs(a.start - b.start) <= 15, (a, b)
