"""Benchmark: forced-alignment throughput on the GPU fast path, on the
seeded en-us model (soundswallower_tpu/seeded_model.py).

Prints the device, then ONE JSON line: {"metric": ..., "value": N,
"unit": ..., "device": {...}, "mixed": {...}, "longform": {...},
"serve_p50_ms": N, ...}.  Exits 1 when JAX finds no GPU.

Workloads, all steady-state (post-compile), with fresh seeded audio per
batch so no result cache can short-circuit the pipeline.  Batch
throughput is the median interval between consecutive
align_batch_end completions over BENCH_REPS (default 8) pipelined
batches (see pipelined_batch_time); serving latency reports percentiles
over 256 requests at concurrency 32:

1. ``value`` (headline): a same-transcript batch of B=1024 — host C++
   MFCC -> upload -> dynamic features -> graph-restricted senone
   scoring -> phone-graph Viterbi + backtrace -> native segment
   extraction, pipelined via align_batch_begin/end.
2. ``mixed``: B=256 utterances with 256 DISTINCT transcripts through the
   multi-graph single-dispatch path (working-set union scoring + banded
   per-row Viterbi) — the ReadAlongs-shaped serving workload (one
   transcript per document, js/api.js:491).  Includes a per-stage
   breakdown.
3. ``longform``: 8 utterances of ~67 s (graph size and token stacks
   scale with audio length).
4. ``serve_p50_ms``/``serve_p99_ms``: per-request latency through
   AlignService (the dynamic batcher) under concurrent mixed load.

The estimator is due to be replaced (ROADMAP Speed 2): its numbers are
not yet a recorded baseline.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

def make_mixed(corpus, B, seed=0, seconds=2.6):
    """B distinct seeded transcripts with their synthesized audio."""
    rng = np.random.default_rng(seed)
    pairs, seen = [], set()
    while len(pairs) < B:
        audio, text = corpus.pair(rng, seconds)
        if text not in seen:
            seen.add(text)
            pairs.append((audio, text))
    return pairs


def pipelined_batch_time(al, batches, texts):
    """Steady-state per-batch seconds through align_batch_begin/end:
    the MEDIAN interval between consecutive align_batch_end completions.
    The first interval (pipeline fill) is excluded by construction
    since the first end() completes only after two begins."""
    marks = []
    pending = al.align_batch_begin(batches[0], texts)
    for b in batches[1:]:
        nxt = al.align_batch_begin(b, texts)
        out = al.align_batch_end(pending)
        marks.append(time.perf_counter())
        pending = nxt
    out = al.align_batch_end(pending)
    marks.append(time.perf_counter())
    ivals = np.diff(marks)
    return float(np.median(ivals)), out


def bench_same(al, corpus, batch, reps, rng):
    _, text = corpus.pair(rng, 2.6)
    texts = [text] * batch

    def make_batch():
        return [corpus.audio(text, rng) for _ in range(batch)]

    segs = al.align_batch(make_batch(), texts)  # warmup/compile
    assert all(s is not None for s in segs)
    batches = [make_batch() for _ in range(reps)]
    dt, segs = pipelined_batch_time(al, batches, texts)
    assert all(s is not None for s in segs)
    audio_sec = np.mean([sum(len(a) for a in b) for b in batches]) / 16000.0
    return audio_sec / dt


def bench_mixed(al, corpus, batch, reps, rng):
    pairs = make_mixed(corpus, batch)
    audios = [a for a, _ in pairs]
    texts = [t for _, t in pairs]
    audio_sec = sum(len(a) for a in audios) / 16000.0

    def perturb():
        return [(a + rng.integers(-1, 2, len(a)).astype(np.int16))
                for a in audios]

    out = al.align_batch(perturb(), texts)  # warmup/compile
    assert all(o is not None for o in out)
    batches = [perturb() for _ in range(reps)]
    dt, out = pipelined_batch_time(al, batches, texts)
    assert all(o is not None for o in out)
    return audio_sec / dt, len(set(texts))


def bench_stages(al, corpus, batch, rng):
    """Stage-level timing of the mixed path (host FE / h2d / features /
    scoring / gather / viterbi+backtrace / d2h / extract).  Each stage
    forces completion with a host fetch of one element.  Unpipelined
    sums exceed the pipelined e2e numbers above (host stages overlap
    device stages there)."""
    import jax

    from soundswallower_tpu.aligner import _gather_cols
    from soundswallower_tpu.ops.senscore_jax import score_frames_graph

    pairs = make_mixed(corpus, batch)
    audios = [a + rng.integers(-1, 2, len(a)).astype(np.int16)
              for a, _ in pairs]
    texts = [t for _, t in pairs]
    audio_sec = sum(len(a) for a in audios) / 16000.0
    graphs = [al.graph_for_text(t) for t in texts]
    uni = al._union_scorer(graphs)
    st = al._stacked_graphs(graphs, remap=uni["pos"], remap_ver=uni["ver"])
    ns = np.array([len(a) for a in audios])
    Ts = np.array([al.fe.n_frames(int(n)) for n in ns])
    Tmax = max(64, al.tmax_floor, -(-int(Ts.max()) // 64) * 64)

    def t(fn, fetch, reps=4):
        out = fn()
        fetch(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        fetch(out)
        return (time.perf_counter() - t0) / reps, out

    # force completion by fetching ONE scalar (a full-array fetch would
    # measure the d2h transfer, not the stage)
    fetch_j = lambda o: np.asarray(o.ravel()[0])  # noqa: E731
    d_fe, pl = t(lambda: al.native_fe.process_list_i16p(
        audios, Tmax, al.wire_scale), lambda o: None)
    d_h2d, pl_d = t(lambda: jax.device_put(pl), fetch_j)
    Ts_d = jax.device_put(Ts)
    d_feat, fv = t(lambda: al._feats_chunk_planes(pl_d, Ts_d, Tmax),
                   fetch_j)
    flat = fv.reshape((-1,) + fv.shape[2:])
    cbs = jax.device_put(al._row_codebooks(graphs, uni["cb_row"]))
    d_score, dense = t(
        lambda: score_frames_graph(uni["gs"], flat, cbs), fetch_j)
    dense = dense.reshape(len(audios), Tmax, -1)
    d_gather, sen = t(lambda: _gather_cols(dense, st["sencols"]), fetch_j)
    Ts32 = jax.device_put(Ts.astype(np.int32))
    d_vit, vout = t(lambda: al._vit_full_mg(st, sen, Ts32),
                    lambda o: np.asarray(o[0].ravel()[0]))
    d_d2h, fetched = t(lambda: (np.array(vout[0]), np.array(vout[2])),
                       lambda o: None)
    paths, fins = fetched
    def extract():
        out = al._extract_batch_native(graphs, paths, Ts, len(audios))
        if out is None:  # library unavailable: python fallback
            out = [al._extract_safe(graphs[i], paths[i], int(Ts[i]),
                                    int(fins[i]))
                   for i in range(len(audios))]
        return out
    d_ex, _ = t(extract, lambda o: None)
    ms = {k: round(v * 1000, 2) for k, v in
          [("host_fe", d_fe), ("h2d", d_h2d), ("feats", d_feat),
           ("score", d_score), ("gather", d_gather),
           ("viterbi_backtrace", d_vit), ("d2h", d_d2h),
           ("extract", d_ex)]}
    ms["audio_s"] = round(audio_sec, 1)
    return ms


def bench_longform(al, corpus, rng, seconds=67.0, B=8, reps=4):
    """Long-form throughput: B seeded utterances of one ~67 s transcript
    through the offline fast path — the alignment-graph node count and
    the token stack scale with audio length here, unlike the
    short-utterance sections."""
    audio, text = corpus.pair(rng, seconds)
    audio_sec = len(audio) / 16000.0 * B
    texts = [text] * B

    def make_batch():
        return [(audio + rng.integers(-1, 2, len(audio)).astype(np.int16))
                for _ in range(B)]

    out = al.align_batch(make_batch(), texts)  # warmup/compile
    assert all(o is not None for o in out)
    batches = [make_batch() for _ in range(reps)]
    dt, _ = pipelined_batch_time(al, batches, texts)
    return audio_sec / dt, len(audio) / 16000.0


def bench_serve(al, corpus, n_req=256, conc=32):
    """Per-request latency through the dynamic batcher under mixed
    concurrent load."""
    from concurrent.futures import ThreadPoolExecutor

    from soundswallower_tpu.serve import AlignService

    pairs = make_mixed(corpus, 16, seed=7)
    svc = AlignService(al, max_batch=64, max_wait_ms=5.0)
    rng = np.random.default_rng(9)
    try:
        # compile every batch-size class the dynamic batcher can hit
        # (what a real deployment does at startup; serve.py --prewarm-text)
        svc.prewarm(pairs)

        def one(i):
            a, t = pairs[i % len(pairs)]
            a = a + rng.integers(-1, 2, len(a)).astype(np.int16)
            t0 = time.monotonic()
            svc.align(a, t, timeout=600)
            return (time.monotonic() - t0) * 1000.0

        # shakeout wave (unmeasured): the first concurrent batches after
        # prewarm absorb one-time costs that are not steady-state
        # (batcher thread ramp); the metric is steady-state latency
        for _ in range(2):
            with ThreadPoolExecutor(max_workers=conc) as ex:
                list(ex.map(one, range(conc)))
        with ThreadPoolExecutor(max_workers=conc) as ex:
            lat = list(ex.map(one, range(n_req)))
        lat.sort()
        return (lat[len(lat) // 2], lat[int(len(lat) * 0.95)],
                lat[int(len(lat) * 0.99)])
    finally:
        svc.close()


def main():
    import jax

    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.seeded_model import Corpus, write_seeded_model

    dev = jax.devices()[0]
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()))
    print(f"device: {device}", flush=True)
    if dev.platform != "gpu":
        print("no GPU found; the benchmark runs on a GPU only",
              file=sys.stderr)
        sys.exit(1)

    batch = int(os.environ.get("BENCH_BATCH", "1024"))
    mixed_batch = int(os.environ.get("BENCH_MIXED_BATCH", "256"))
    reps = int(os.environ.get("BENCH_REPS", "8"))

    model = write_seeded_model("en-us", 0)
    al = TpuAligner(hmm=model)
    corpus = Corpus(model)
    rng = np.random.default_rng(0)

    p50, p95, p99 = bench_serve(al, corpus)
    value = bench_same(al, corpus, batch, reps, rng)
    mixed_val, n_distinct = bench_mixed(al, corpus, mixed_batch, reps, rng)
    stages = bench_stages(al, corpus, mixed_batch, rng)
    lf_val, lf_sec = bench_longform(al, corpus, rng)

    out = {
        "metric": "align_audio_seconds_per_second_per_chip",
        "value": round(value, 1),
        "unit": "audio-s/s/chip",
        "device": device,
        "mixed": {
            "value": round(mixed_val, 1),
            "unit": "audio-s/s/chip",
            "batch": mixed_batch,
            "distinct_transcripts": n_distinct,
            "stage_ms": stages,
        },
        "longform": {
            "value": round(lf_val, 1),
            "unit": "audio-s/s/chip",
            "utt_seconds": round(lf_sec, 1),
        },
        "serve_p50_ms": round(p50, 1),
        "serve_p95_ms": round(p95, 1),
        "serve_p99_ms": round(p99, 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
