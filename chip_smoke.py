#!/usr/bin/env python3
"""Drive the aligner's main path once on a GPU, at the full width of the
seeded en-us model, and check what comes out.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the data- and
                                    # sequence-parallel meshes only

Phases (each prints a line; any failure ends the run with exit 1 and no
result line):

1. device: JAX's devices, ``nvidia-smi`` name and power limit, the FE
   route and the compile-cache directory.  No GPU -> exit 1.
2. model: write (or reuse) the seeded en-us model and load it through
   ``TpuAligner(hmm=...)``; the loaded shapes must be the published ones.
3. same-transcript batch (B=256, 2-15 s) through ``align_batch`` and
   ``align_batch_begin/end``; compile times, ``memory_analysis()`` and
   the s64/f64 op counts of the scorer and Viterbi programs; Viterbi
   unroll timings; the device-FE route (SST_FE=device) at small B.
4. distinct-transcript batches through the multi-graph path, one of
   them past UNION_MAX_FRAC into dense scoring.
5. long-form: a >= 60 s utterance through ``align_batch`` and
   ``AlignStream``.
6. grammar: ``set_grammar(jsgf_string=...)`` + ``decode_batch``.
7. serving: ``make_server`` in a thread, 16 concurrent POST /v1/align
   and GET /v1/health checked against the result schema; ``cli.main``
   in-process on a seeded WAV.
8. comparisons at full model width (tolerances stated where checked):
   (a) dense scorer vs the numpy reference ScorerNp, (b) the same
   scorer on the GPU and on the CPU device, (c) graph-restricted vs
   full scorer, (d) Viterbi + backtrace on the GPU and on the CPU
   device, (e) batch rows vs single-row ``align``, (f) information
   only: boundaries from ScorerNp scores.

The last line of standard output is the result:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# published en-us shapes (BASELINE.md:13)
EN_US = dict(n_ciphone=42, n_phone=137_095, n_sen=5_126, n_ci_sen=126,
             n_sseq=28_458, n_tmat=42, n_emit_state=3,
             codebooks=(42, 3, 128, 13), dict_words=134_784)


@dataclass
class Sizes:
    """Work per phase.  The defaults are the chip run; the CPU tests
    call the phases with a small Sizes at the tiny preset."""
    batch: int = 256           # phase 3 rows
    min_s: float = 2.0         # phase 3 audio lengths
    max_s: float = 15.0
    fe_rows: int = 8           # phase 3 device-FE rows
    mixed: int = 64            # phase 4 distinct transcripts, short enough
    mixed_s: float = 1.5       # that their working set stays a union
    dense_s: float = 10.0      # phase 4 second batch, past UNION_MAX_FRAC
    long_s: float = 62.0       # phase 5
    grammar_rows: int = 8      # phase 6
    requests: int = 16         # phase 7
    sample_rows: int = 4       # rows checked per comparison
    score_frames: int = 300    # (a)/(b)/(c) frames
    timing_reps: int = 3       # unroll timing repetitions


def log(msg: str) -> None:
    print(msg, flush=True)


def segs_key(segs, phones: bool = True):
    if segs is None:
        return None
    return [(s.word, s.start, s.duration) +
            ((tuple(p[:3] for p in s.phones),) if phones else ())
            for s in segs]


class Ctx:
    def __init__(self, al, corpus, rng, sizes: Sizes, model_dir: str):
        self.al, self.corpus, self.rng = al, corpus, rng
        self.sz, self.model_dir = sizes, model_dir
        self.same = None           # phase 3 results kept for phase 8
        self.mixed = None          # phase 4 results kept for phase 8


# -- phase 1 -----------------------------------------------------------------

def card_info() -> str:
    """nvidia-smi's name and power limit, from a child that never
    imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device(want: int) -> dict:
    import jax

    devs = jax.devices()
    log(f"devices: {devs}")
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"no GPU found: JAX reports platform "
                         f"{d0.platform!r}; this script runs on a GPU only")
    if len(devs) < want:
        raise SystemExit(f"need {want} GPUs, JAX reports {len(devs)}")
    log(f"device_kind: {d0.device_kind}")
    for line in card_info().splitlines():
        log(f"nvidia-smi: {line}")
    log("compile cache: " + str(jax.config.jax_compilation_cache_dir))
    log("XLA_FLAGS: " + os.environ.get("XLA_FLAGS", ""))
    return dict(platform=d0.platform, kind=d0.device_kind, count=len(devs))


# -- phase 2 -----------------------------------------------------------------

def loaded_shapes(al) -> dict:
    m = al.am.mdef
    return dict(n_ciphone=m.n_ciphone, n_phone=m.n_phone, n_sen=m.n_sen,
                n_ci_sen=m.n_ci_sen, n_sseq=m.n_sseq, n_tmat=m.n_tmat,
                n_emit_state=m.n_emit_state,
                codebooks=tuple(al.am.means.shape),
                dict_words=al.dict.filler_start)


def phase_model(preset: str, seed: int):
    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.seeded_model import Corpus, write_seeded_model

    t0 = time.perf_counter()
    d = write_seeded_model(preset, seed)
    t1 = time.perf_counter()
    al = TpuAligner(hmm=d)
    t2 = time.perf_counter()
    shapes = loaded_shapes(al)
    log(f"model {preset}-{seed}: write/reuse {t1 - t0:.1f}s, load "
        f"{t2 - t1:.1f}s, backend {al.am.backend}, shapes {shapes}")
    if preset == "en-us" and shapes != EN_US:
        raise AssertionError(f"loaded shapes {shapes} != published {EN_US}")
    log(f"fe route: {al.fe_route}")
    if al.fe_route != "host" or al.native_fe is None:
        raise AssertionError("the native host FE did not load")
    return al, Corpus(d), d


# -- phase 3 -----------------------------------------------------------------

def hlo_wide_ops(compiled) -> dict:
    """Instructions of an optimized HLO module that produce s64/f64."""
    text = compiled.as_text()
    return {t: len(re.findall(rf"=\s*{t}\[", text)) for t in ("s64", "f64")}


def mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    return (f"args {m.argument_size_in_bytes} out {m.output_size_in_bytes} "
            f"temp {m.temp_size_in_bytes} code "
            f"{m.generated_code_size_in_bytes} bytes")


def vit_program(unroll_v: int, unroll_b: int):
    """The batch Viterbi + final select + backtrace of
    TpuAligner._vit_full, traced afresh with the given scan unroll
    factors (the module's factors are read while tracing)."""
    import jax
    import jax.numpy as jnp

    from soundswallower_tpu.ops import align_jax as aj

    def run(sg, tp, pi, pp, pk, ast, aen, entry, fin, Ts):
        keep = aj.VITERBI_UNROLL, aj.BACKTRACE_UNROLL
        aj.VITERBI_UNROLL, aj.BACKTRACE_UNROLL = unroll_v, unroll_b
        try:
            tok_id, _, out_score, out_hist = \
                aj.align_viterbi_batch.__wrapped__(
                    sg, tp, pi, pp, pk, ast, aen, Ts, False, entry)
            fsc = out_score[:, fin]
            final_node = fin[jnp.argmax(fsc, axis=1)]
            rows = jnp.arange(sg.shape[0])
            fstate = out_hist[rows, final_node]
            fscore = out_score[rows, final_node]
            path, _ = aj.backtrace_batch.__wrapped__(
                tok_id, None, fstate, fscore, Ts)
        finally:
            aj.VITERBI_UNROLL, aj.BACKTRACE_UNROLL = keep
        return path, fscore

    return jax.jit(run)


def vit_args(al, g, sen, Ts):
    c = al._graph_consts(g)
    return (sen, c["tp"], c["pi"], c["pp"], c["pk"], c["ast"], c["aen"],
            c["entry"], c["fin"], Ts)


def phase_same(ctx: Ctx) -> None:
    import jax
    import jax.numpy as jnp

    from soundswallower_tpu.ops import align_jax as aj
    from soundswallower_tpu.ops.senscore_jax import (
        _dist_stage_graph, _topn_sen_stage_graph)

    al, sz, rng = ctx.al, ctx.sz, ctx.rng
    _, text = ctx.corpus.pair(rng, 1.8)
    audios = [ctx.corpus.audio(text, rng, seconds=rng.uniform(sz.min_s,
                                                              sz.max_s))
              for _ in range(sz.batch)]
    captured = {}
    vit_full = al._vit_full

    def spy(g, sen_g, Ts):
        captured.update(g=g, sen=sen_g, Ts=Ts)
        return vit_full(g, sen_g, Ts)

    al._vit_full = spy
    try:
        t0 = time.perf_counter()
        out = al.align_batch(audios, [text] * len(audios))
        t1 = time.perf_counter()
        again = al.align_batch(audios, [text] * len(audios))
        t2 = time.perf_counter()
        h = al.align_batch_begin(audios, [text] * len(audios))
        piped = al.align_batch_end(h)
    finally:
        al._vit_full = vit_full
    bad = sum(o is None for o in out)
    if bad:
        raise AssertionError(f"{bad} rows failed to align")
    if [segs_key(o) for o in out] != [segs_key(o) for o in again] or \
            [segs_key(o) for o in out] != [segs_key(o) for o in piped]:
        raise AssertionError("repeat / begin-end results differ")
    audio_s = sum(len(a) for a in audios) / 16000.0
    log(f"same-transcript: B={len(audios)} ({len(text.split())} words, "
        f"{audio_s:.1f} audio-s) first call {t1 - t0:.2f}s (compile+run), "
        f"second {t2 - t1:.2f}s; begin/end equal")

    g, sen, Ts = captured["g"], captured["sen"], captured["Ts"]
    B, Tmax, S = sen.shape
    gs = al._graph_consts(g)["gs"]
    rows = min(al._chunk_size(B), B) * Tmax
    Cu = gs.means.shape[0]
    f32 = jax.ShapeDtypeStruct((rows,) + (3, 13), jnp.float32)
    i32 = jax.ShapeDtypeStruct((rows, Cu, 3, 128), jnp.int32)
    progs = {
        "score.dist": _dist_stage_graph.lower(gs, f32).compile(),
        "score.topn_sen": _topn_sen_stage_graph.lower(gs, i32).compile(),
        "viterbi+backtrace": al._vit_batch_jit[False].lower(
            *vit_args(al, g, sen, Ts)).compile(),
    }
    for name, c in progs.items():
        log(f"program {name}: {mem(c)}; wide ops {hlo_wide_ops(c)}")

    # unroll factors: current against 1, alternating, same inputs
    args = vit_args(al, g, sen, Ts)
    cands = {(aj.VITERBI_UNROLL, aj.BACKTRACE_UNROLL): None, (1, 1): None}
    for k in cands:
        cands[k] = vit_program(*k)
        jax.block_until_ready(cands[k](*args))
    times = {k: [] for k in cands}
    ref = None
    for _ in range(sz.timing_reps):
        for k, fn in cands.items():
            t = time.perf_counter()
            res = jax.block_until_ready(fn(*args))
            times[k].append(time.perf_counter() - t)
            p = np.asarray(res[0])
            if ref is None:
                ref = p
            elif not (p == ref).all():
                raise AssertionError("unroll factors changed the path")
    log("viterbi+backtrace unroll timing at B=%d T=%d S=%d: %s" % (
        B, Tmax, S, ", ".join(f"unroll {k}: median {np.median(v)*1e3:.2f} ms"
                              for k, v in times.items())))

    # the device FE route at small B
    from soundswallower_tpu.aligner import TpuAligner

    os.environ["SST_FE"] = "device"
    try:
        al_dev = TpuAligner(hmm=ctx.model_dir)
    finally:
        del os.environ["SST_FE"]
    few = audios[: sz.fe_rows]
    dev_out = al_dev.align_batch(few, [text] * len(few))
    same = sum(segs_key(a) == segs_key(b) for a, b in zip(dev_out, out))
    worst = 0.0
    for a in few:
        n = len(a)
        T = al.fe.n_frames(n)
        host = al.native_fe.process_batch(a[None], np.array([n]), T)[0]
        dev = np.asarray(al.fe.mfcc(jnp.asarray(a.astype(np.float32)), n, T))
        worst = max(worst, float(np.abs(host - dev[:T]).max()))
    log(f"device FE (SST_FE=device, B={len(few)}): max |cep host - cep "
        f"device| = {worst:.3g}; rows with equal words+boundaries "
        f"{same}/{len(few)}")
    ctx.same = dict(text=text, audios=audios, out=out, g=g,
                    sen=np.asarray(sen), Ts=np.asarray(Ts))


# -- phase 4 -----------------------------------------------------------------

def phase_mixed(ctx: Ctx) -> None:
    al, sz, rng, corpus = ctx.al, ctx.sz, ctx.rng, ctx.corpus
    pairs = []
    seen = set()
    while len(pairs) < sz.mixed:
        a, t = corpus.pair(rng, rng.uniform(0.5, sz.mixed_s))
        if t not in seen:
            seen.add(t)
            pairs.append((a, t))
    t0 = time.perf_counter()
    out = al.align_batch([a for a, _ in pairs], [t for _, t in pairs])
    t1 = time.perf_counter()
    uni = al._uni
    if uni["dense"] or uni["gs"] is None:
        raise AssertionError("first mixed batch did not use the union scorer")
    if any(o is None for o in out):
        raise AssertionError("mixed rows failed to align")
    log(f"mixed: {len(pairs)} distinct transcripts, union scorer over "
        f"{len(uni['senset'])}/{al.am.n_sen} senones, first call "
        f"{t1 - t0:.2f}s")
    # a batch whose working set crosses UNION_MAX_FRAC -> dense scoring
    limit = al.UNION_MAX_FRAC * al.am.n_sen
    need = set(uni["senset"].tolist())
    big = []
    while len(need) <= limit:
        if len(big) >= 1024:
            raise AssertionError("no batch of 1024 transcripts crosses "
                                 "UNION_MAX_FRAC")
        a, t = corpus.pair(rng, sz.dense_s)
        need |= set(al.graph_for_text(t).senid.ravel().tolist())
        big.append((a, t))
    t0 = time.perf_counter()
    out2 = al.align_batch([a for a, _ in big], [t for _, t in big])
    t1 = time.perf_counter()
    if not al._uni["dense"]:
        raise AssertionError("working set crossed UNION_MAX_FRAC but the "
                             "scorer did not switch to dense")
    if any(o is None for o in out2):
        raise AssertionError("dense mixed rows failed to align")
    log(f"mixed dense: {len(big)} transcripts ({len(need)} senones > "
        f"{al.UNION_MAX_FRAC} * {al.am.n_sen}), dense scoring, first call "
        f"{t1 - t0:.2f}s")
    ctx.mixed = dict(pairs=pairs, out=out, big=big, out2=out2)


# -- phase 5 -----------------------------------------------------------------

def phase_longform(ctx: Ctx) -> None:
    al, sz, rng = ctx.al, ctx.sz, ctx.rng
    audio, text = ctx.corpus.pair(rng, sz.long_s)
    secs = len(audio) / 16000.0
    t0 = time.perf_counter()
    off = al.align_batch([audio], [text])[0]
    t1 = time.perf_counter()
    st = al.stream(text)
    for i in range(0, len(audio), 16000):
        st.push(audio[i:i + 16000])
    live = st.end()
    t2 = time.perf_counter()
    words = text.split()
    for name, segs in (("align_batch", off), ("AlignStream", live)):
        if segs is None or [s.word for s in segs if s.word != "<sil>"] \
                != words:
            raise AssertionError(f"long-form {name} lost the transcript")
    a = [s.start for s in off if s.word != "<sil>"]
    b = [s.start for s in live if s.word != "<sil>"]
    log(f"long-form: {secs:.1f} s, {len(words)} words; align_batch "
        f"{t1 - t0:.2f}s, AlignStream {t2 - t1:.2f}s; word starts live vs "
        f"batch CMN: max |diff| {max(abs(x - y) for x, y in zip(a, b))} "
        f"frames")


# -- phase 6 -----------------------------------------------------------------

def phase_grammar(ctx: Ctx) -> None:
    al, sz, rng, corpus = ctx.al, ctx.sz, ctx.rng, ctx.corpus
    slots = [[corpus.words[i] for i in rng.choice(len(corpus.words), 3,
                                                   replace=False)]
             for _ in range(3)]
    jsgf = ("#JSGF V1.0;\ngrammar cmd;\npublic <cmd> = "
            + " ".join("( " + " | ".join(s) + " )" for s in slots) + " ;\n")
    al.set_grammar(jsgf_string=jsgf)
    said = [" ".join(s[rng.integers(3)] for s in slots)
            for _ in range(sz.grammar_rows)]
    t0 = time.perf_counter()
    res = al.decode_batch([corpus.audio(t, rng) for t in said])
    t1 = time.perf_counter()
    vocab = {w for s in slots for w in s}
    for r in res:
        if r is None or not set(r[0].split()) <= vocab:
            raise AssertionError(f"grammar decode failed: {r}")
    hits = sum(r[0] == t for r, t in zip(res, said))
    log(f"grammar: {len(said)} utterances decoded in {t1 - t0:.2f}s, "
        f"hypothesis = spoken sentence for {hits}/{len(said)}")


# -- phase 7 -----------------------------------------------------------------

def check_seg(seg) -> None:
    """The result schema js/index.d.ts declares (tests/test_serve.py)."""
    if not ({"b", "d", "t"} <= set(seg) <= {"b", "d", "p", "t", "w"}):
        raise AssertionError(f"bad segment keys {sorted(seg)}")
    if not all(isinstance(seg[k], (int, float)) for k in ("b", "d")) or \
            not isinstance(seg["t"], str):
        raise AssertionError(f"bad segment types {seg}")
    for child in seg.get("w", []):
        check_seg(child)


def phase_serve(ctx: Ctx) -> None:
    from soundswallower_tpu import cli
    from soundswallower_tpu.serve import make_server

    al, sz, rng, corpus = ctx.al, ctx.sz, ctx.rng, ctx.corpus
    pairs = [corpus.pair(rng, rng.uniform(2.0, 5.0))
             for _ in range(sz.requests)]
    srv = make_server(al, "127.0.0.1", 0, max_batch=sz.requests,
                      max_wait_ms=50.0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    try:
        def post(pair):
            a, t = pair
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/align",
                data=json.dumps({"text": t, "audio": base64.b64encode(
                    a.astype("<i2").tobytes()).decode()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(pairs)) as ex:
            got = list(ex.map(post, pairs))
        t1 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/health",
                                    timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.service.close()
        th.join(timeout=30)
    if set(health) != {"status", "model", "n_sen", "backend"} or \
            health["status"] != "ok" or health["n_sen"] != al.am.n_sen:
        raise AssertionError(f"bad health response {health}")
    for (code, res), (_, t) in zip(got, pairs):
        check_seg(res)
        words = [w["t"] for w in res["w"] if not w["t"].startswith("<")]
        if code != 200 or res["t"] != t or words != t.split():
            raise AssertionError(f"bad /v1/align response for {t!r}")
    log(f"serve: {len(pairs)} concurrent POST /v1/align in "
        f"{t1 - t0:.2f}s, schema ok; GET /v1/health ok")

    wav_dir = os.path.join(ctx.model_dir, "audio")
    with open(os.path.join(wav_dir, "transcripts.txt")) as fh:
        name, text = fh.readline().split(" ", 1)
    text = text.strip()
    with tempfile.TemporaryDirectory() as tmp:
        outp = os.path.join(tmp, "out.jsonl")
        cli.main(["--model", ctx.model_dir, "--align-text", text,
                  "--phone-align", os.path.join(wav_dir, name), "-o", outp])
        with open(outp) as fh:
            res = json.loads(fh.readline())
    check_seg(res)
    words = [w["t"] for w in res["w"] if not w["t"].startswith("<")]
    if words != text.split():
        raise AssertionError(f"cli words {words} != {text.split()}")
    log(f"cli: {name} aligned in-process, {len(words)} words, schema ok")


# -- phase 8 -----------------------------------------------------------------

def phase_compare(ctx: Ctx) -> None:
    import jax
    import jax.numpy as jnp

    from soundswallower_tpu.fe.feat import feats_full_utt
    from soundswallower_tpu.ops.senscore import ScorerNp
    from soundswallower_tpu.ops.senscore_jax import (
        MAX_NEG_ASCR, _dist_stage, score_frames, score_frames_graph, ungroup)

    al, sz, rng = ctx.al, ctx.sz, ctx.rng
    cpu = jax.devices("cpu")[0]
    same = ctx.same
    # features of one phase-3 row, fetched to the host
    i = int(np.argmax([len(a) for a in same["audios"]]))
    audio = same["audios"][i]
    T = al.fe.n_frames(len(audio))
    cep = al.native_fe.process_batch(audio[None], np.array([len(audio)]),
                                     T)[0]
    feats = np.asarray(feats_full_utt(jnp.asarray(cep), jnp.int32(T),
                                      al.config["cmn"]))
    # a contiguous run from the first frame: ScorerNp seeds each frame's
    # top-N search from the previous frame, like the C scorer
    fx = feats[: min(sz.score_frames, T)]

    # (a) dense scorer vs ScorerNp.  Tolerance: >= 99.9% of entries
    # equal (tests/test_senscore.py): the fast path drops eval_cb's
    # early stop and cross-frame top-N seeding, which changes a few
    # top-4 sets.
    dense = ungroup(al.tables, np.asarray(score_frames(al.tables,
                                                       jnp.asarray(fx))))
    ref = ScorerNp(al.am)
    ref.start_utt()
    npy = np.stack([ref.frame_eval(fx[k], k) for k in range(len(fx))])
    agree = float((dense == npy).mean())
    log(f"(a) dense scorer vs ScorerNp: {agree:.6f} of {npy.size} entries "
        f"equal ({len(fx)} frames x {al.am.n_sen} senones; gate >= 0.999)")
    if agree < 0.999:
        raise AssertionError("(a) scorer agreement below 0.999")

    # (b) the same jitted scorer on the GPU and on the CPU device (the
    # CPU copy of the tables holds the mixture weights in f32, the
    # matmul type XLA's CPU backend takes; exact either way, see
    # senscore_jax.mm_dtype)
    t_cpu = jax.device_put(dataclasses.replace(
        al.tables, mixw_g=al.tables.mixw_g.astype(jnp.float32)), cpu)
    f_gpu = jnp.asarray(fx)
    f_cpu = jax.device_put(fx, cpu)
    d_gpu = np.asarray(_dist_stage(al.tables, f_gpu))
    d_cpu = np.asarray(_dist_stage(t_cpu, f_cpu))
    s_gpu = np.asarray(score_frames(al.tables, f_gpu))
    s_cpu = np.asarray(score_frames(t_cpu, f_cpu))
    ndist = int((d_gpu != d_cpu).sum())
    nsc = int((s_gpu != s_cpu).sum())
    log(f"(b) scorer GPU vs CPU device: {ndist}/{d_gpu.size} int32 "
        f"distances differ (max |diff| "
        f"{int(np.abs(d_gpu.astype(np.int64) - d_cpu).max())}), "
        f"{nsc}/{s_gpu.size} int16 scores differ")

    # (c) graph-restricted scorer within 3*MAX_NEG_ASCR of the full
    # scorer at the graph's columns after the per-frame constant
    # (tests/test_senscore.py: only senones whose top-N codewords
    # saturate the MAX_NEG_ASCR clamp may move, by at most the clamp)
    g = same["g"]
    full = np.asarray(score_frames(al.tables, f_gpu)).astype(np.int32)
    cols = al.tables.sen_remap[g.senid].reshape(-1)
    restricted = np.asarray(score_frames_graph(al._graph_consts(g)["gs"],
                                               f_gpu))
    dd = full[:, cols] - restricted
    spread = int((dd.max(axis=1) - dd.min(axis=1)).max())
    log(f"(c) restricted vs full scorer: max per-frame spread {spread} "
        f"(gate <= {3 * MAX_NEG_ASCR})")
    if spread > 3 * MAX_NEG_ASCR:
        raise AssertionError("(c) restricted scorer out of bound")

    # (d) Viterbi + backtrace on GPU vs CPU over the identical int scores
    rows = np.sort(rng.choice(len(same["audios"]),
                              min(sz.sample_rows * 2, len(same["audios"])),
                              replace=False))
    prog = vit_program(1, 1)
    c = al._graph_consts(g)
    consts = [c[k] for k in ("tp", "pi", "pp", "pk", "ast", "aen", "entry",
                             "fin")]
    sen_r = same["sen"][rows]
    Ts_r = same["Ts"][rows].astype(np.int32)
    p_gpu, f_gpu_sc = prog(jnp.asarray(sen_r), *consts, jnp.asarray(Ts_r))
    cpu_args = [jax.device_put(np.asarray(x), cpu)
                for x in [sen_r] + consts + [Ts_r]]
    p_cpu, f_cpu_sc = prog(*cpu_args)
    eq_path = bool((np.asarray(p_gpu) == np.asarray(p_cpu)).all())
    eq_sc = bool((np.asarray(f_gpu_sc) == np.asarray(f_cpu_sc)).all())
    log(f"(d) Viterbi+backtrace GPU vs CPU on {len(rows)} rows: paths "
        f"equal {eq_path}, final scores equal {eq_sc}")
    if not (eq_path and eq_sc):
        raise AssertionError("(d) integer Viterbi differs across devices")

    # (e) batch rows == single-row align
    n_e = 0
    for out, audios, texts in (
            (same["out"], same["audios"], [same["text"]] * len(same["out"])),
            (ctx.mixed["out"], [a for a, _ in ctx.mixed["pairs"]],
             [t for _, t in ctx.mixed["pairs"]])):
        for r in rng.choice(len(out), min(sz.sample_rows, len(out)),
                            replace=False):
            single = al.align(audios[r], texts[r])
            if segs_key(single) != segs_key(out[r]):
                raise AssertionError(f"(e) row {r} differs from align()")
            n_e += 1
    log(f"(e) batch rows vs single-row align: {n_e}/{n_e} equal "
        f"(words, phones, boundaries)")

    # (f) information only: ScorerNp scores -> the same Viterbi on CPU
    order = np.argsort([len(a) for a in same["audios"]])[: sz.sample_rows]
    G = int(np.prod(al.tables.group_shape))
    eq = 0
    for r in order:
        a = same["audios"][r]
        Tr = al.fe.n_frames(len(a))
        cep = al.native_fe.process_batch(a[None], np.array([len(a)]), Tr)[0]
        fr = np.asarray(feats_full_utt(jnp.asarray(cep), jnp.int32(Tr),
                                       al.config["cmn"]))
        ref = ScorerNp(al.am)
        ref.start_utt()
        npy = np.stack([ref.frame_eval(fr[k], k) for k in range(Tr)])
        grouped = np.zeros((Tr, G), np.int32)
        grouped[:, al.tables.sen_remap] = npy
        sen = grouped[:, cols][None]                          # [1, T, S]
        args = [jax.device_put(np.asarray(x), cpu)
                for x in [sen] + consts + [np.array([Tr], np.int32)]]
        path, fsc = prog(*args)
        segs = al._extract(g, np.asarray(path)[0], Tr, int(fsc[0]))
        eq += segs_key(segs, phones=False) == \
            segs_key(same["out"][r], phones=False)
    log(f"(f) info: word boundaries from ScorerNp scores equal the device "
        f"path's for {eq}/{len(order)} rows")


# -- --four ----------------------------------------------------------------

def phase_four(ctx: Ctx, n: int) -> None:
    """DP and SP meshes over n devices; segments must equal the
    single-device run on device 0."""
    from soundswallower_tpu.parallel.mesh import data_mesh
    from soundswallower_tpu.parallel.seqpipe import seq_mesh

    al, sz, rng, corpus = ctx.al, ctx.sz, ctx.rng, ctx.corpus
    _, text = corpus.pair(rng, 1.8)
    same = [corpus.audio(text, rng, seconds=rng.uniform(sz.min_s, sz.max_s))
            for _ in range(sz.batch)]
    mixed = [corpus.pair(rng, rng.uniform(0.5, sz.mixed_s))
             for _ in range(sz.mixed)]
    la, lt = corpus.pair(rng, sz.long_s)
    lb = corpus.audio(lt, rng)
    al.use_mesh(None)
    want_same = al.align_batch(same, [text] * len(same))
    want_mixed = al.align_batch([a for a, _ in mixed], [t for _, t in mixed])
    want_long = al.align_batch([la, lb], [lt, lt])
    al.use_mesh(data_mesh(n))
    try:
        got_same = al.align_batch(same, [text] * len(same))
        got_mixed = al.align_batch([a for a, _ in mixed],
                                   [t for _, t in mixed])
    finally:
        al.use_mesh(None)
    for name, w, g in (("same", want_same, got_same),
                       ("mixed", want_mixed, got_mixed)):
        if any(x is None for x in w) or \
                [segs_key(x) for x in w] != [segs_key(x) for x in g]:
            raise AssertionError(f"DP {name}-transcript batch differs from "
                                 f"device 0")
    log(f"DP over {n} devices: {len(same)} same-transcript + {len(mixed)} "
        f"mixed rows equal the single-device segments")
    sp = al.align_longform_batch([la, lb], [lt, lt], mesh=seq_mesh(n))
    if [segs_key(x) for x in sp] != [segs_key(x) for x in want_long] or \
            any(x is None for x in sp):
        raise AssertionError("SP long-form differs from device 0")
    log(f"SP over {n} devices: 2 x {len(la) / 16000:.1f}/"
        f"{len(lb) / 16000:.1f} s utterances equal the single-device "
        f"segments")


# -- main --------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card DP/SP phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model, audio and transcripts")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "soundswallower_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        # the CPU device is the comparison backend of phase 8
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, REPO)
    import soundswallower_tpu  # noqa: F401  (XLA flags, x64, compile cache)

    phase = "device"
    try:
        want = 4 if args.four else 1
        device = phase_device(want)
        phase = "model"
        al, corpus, d = phase_model("en-us", args.seed)
        ctx = Ctx(al, corpus, np.random.default_rng(args.seed + 1), Sizes(),
                  d)
        steps = ([("four", lambda c: phase_four(c, 4))] if args.four else
                 [("same", phase_same), ("mixed", phase_mixed),
                  ("longform", phase_longform), ("grammar", phase_grammar),
                  ("serve", phase_serve), ("compare", phase_compare)])
        for phase, fn in steps:
            t = time.perf_counter()
            fn(ctx)
            log(f"phase {phase} ok ({time.perf_counter() - t:.1f}s)")
    except SystemExit as e:
        print(f"FAILED in phase {phase}: {e}", file=sys.stderr)
        return 1
    except Exception:  # every phase failure ends the run non-zero
        traceback.print_exc()
        print(f"FAILED in phase {phase}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
