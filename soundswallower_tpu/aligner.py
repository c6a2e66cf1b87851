"""TpuAligner: the high-throughput forced-alignment pipeline.

End-to-end on device: audio -> MFCC (fe/frontend.py) -> dynamic features
(fe/feat.py) -> dense senone scores (ops/senscore_jax.py) -> phone-graph
Viterbi + backtrace (ops/align_jax.py), with host work limited to graph
construction (cached per transcript) and segment extraction from the
decoded state path.

This is the single-pass equivalent of the reference's two-pass alignment
(see ops/align_graph.py for the argument); `tests/test_align_tpu.py`
checks boundary agreement against the exact two-pass path.

Batching: same-transcript batches ride the graph-restricted scorer
with the batch in the Viterbi's vector lanes; batches of DIFFERENT
transcripts run as ONE multi-graph dispatch (working-set-union
scoring + per-row banded Viterbi, _batch_begin_mixed).  Segment
extraction runs in C++ (native/sst_seg.cpp) on the no-scores path.
`use_mesh` shards batches over a ('data',) device mesh; `stream`,
`align_longform_batch`, `decode`/`decode_batch`, and
`decode_search`/`lattice`/`nbest` cover the streaming, long-form,
grammar-decode, and history-table surfaces.
"""

from __future__ import annotations

import os

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .am import AcousticModel
from .config import Config
from .dict2pid import Dict2Pid
from .dictionary import Dictionary
from .fe.feat import feats_full_utt
from .fe.frontend import Frontend
from .logmath import LogMath
from .ops.align_graph import AlignGraph, build_chain_graph, stack_graphs
from .ops.align_jax import (WORST_SCORE, align_viterbi, align_viterbi_batch,
                            backtrace, backtrace_batch, build_pred_table)
from .ops.senscore_jax import (GraphScorer, ScorerTables, score_frames,
                               score_frames_graph)


@jax.jit
def _gather_cols(dense, cols):
    """Per-row senone-column gather: dense [B, T, G] scores, cols [B, S]
    grouped-layout columns -> [B, T, S]."""
    return jnp.take_along_axis(dense, cols[:, None, :], axis=2)


@dataclass
class WordSeg:
    word: str
    start: int
    duration: int
    score: int = 0
    phones: list | None = None  # list of (ciphone, start, duration, score)
    wid: int = -1               # dict word id (grammar decode)
    # per-phone HMM-state segments (want_states mode): parallel to
    # ``phones``, each a list of (senone_id, start, duration, score) —
    # the innermost nesting level of the reference result JSON
    # (format_seg_align, decoder.c:1400-1500)
    states: list | None = None


def result_json_from_segs(segs, lmath, n_frames: int, frate: int,
                          hyp: str | None = None, start: float = 0.0,
                          align_level: int = 0) -> str:
    """WordSeg list -> the reference's line-JSON result schema
    (decoder_result_json, decoder.c:1502-1593): nested {"b","d","p","t"}
    objects, words under "w", phones one level deeper when align_level
    >= 1.  p = logmath-exp of the segment score (top level p follows
    the reference's prob=0 -> 1.0 when bestpath is off,
    fsg_search.c:1160-1162)."""
    def fmt(b, d, p, t):
        return f'{{"b":{b:.3f},"d":{d:.3f},"p":{p:.3f},"t":"{t}"'

    if hyp is None:
        # base words in the hyp (variant markers stay on the word
        # entries, like the reference: hyp 'mètres', word 'mètres(4)')
        import re

        hyp = " ".join(re.sub(r"\(\d+\)$", "", s.word) for s in segs
                       if not (s.word.startswith("<")
                               or s.word.startswith("[")))
    out = [fmt(start, n_frames / frate, 1.0, hyp), ',"w":[']
    first = True
    for s in segs:
        if not first:
            out.append(",")
        first = False
        out.append(fmt(start + s.start / frate, s.duration / frate,
                       lmath.exp(int(s.score)), s.word))
        if align_level and s.phones:
            out.append(',"w":[')
            pfirst = True
            for pi_, (ci, ps, pd, psc) in enumerate(s.phones):
                if not pfirst:
                    out.append(",")
                pfirst = False
                out.append(fmt(start + ps / frate, pd / frate,
                               lmath.exp(int(psc)), ci))
                if align_level >= 2 and s.states:
                    out.append(',"w":[')
                    sfirst = True
                    for (senid, ss, sd, ssc) in s.states[pi_]:
                        if not sfirst:
                            out.append(",")
                        sfirst = False
                        out.append(fmt(start + ss / frate, sd / frate,
                                       lmath.exp(int(ssc)), str(senid)))
                        out.append("}")
                    out.append("]")
                out.append("}")
            out.append("]")
        out.append("}")
    out.append("]}\n")
    return "".join(out)


class TpuAligner:
    def __init__(self, config: Config | None = None, **kwargs):
        if config is None:
            config = Config(**kwargs)
        self.config = config
        config.expand()
        self.lmath = LogMath(config.get_float("logbase"), 0, True)
        self.am = AcousticModel.load(config, self.lmath)
        self.dict = Dictionary(self.am.mdef, config["dict"], config["fdict"],
                               config.get_bool("dictcase"))
        self.d2p = Dict2Pid(self.am.mdef, self.dict)
        self.fe = Frontend.from_config(config)
        self.tables = ScorerTables.from_am(self.am)
        self.tmat_i32 = jnp.asarray(self.am.tmat.astype(np.int32))
        self._graph_cache: dict[str, AlignGraph] = {}
        # Front-end route.  "host": the native C++ FE (bit-exact with
        # self.fe) computes cepstra on the host and uploads 13 values
        # per frame instead of 160 samples.  It is the default, and a
        # host FE that cannot be built or loaded is an error, never a
        # silent change of route.  SST_FE=device selects the on-device
        # (float64 JAX) FE explicitly.
        self.fe_route = os.environ.get("SST_FE", "host")
        if self.fe_route not in ("host", "device"):
            raise ValueError(f"SST_FE must be host or device, "
                             f"not {self.fe_route!r}")
        self.native_fe = None
        if self.fe_route == "host":
            from .fe.native_fe import NativeFrontend
            self.native_fe = NativeFrontend.load(self.fe)
            if self.native_fe is None:
                raise RuntimeError(
                    "native host front end unavailable: native/"
                    "libsst_fe.so could not be built or loaded, or this "
                    "FE configuration (remove_dc, transform, nfft) is "
                    "not supported by it; set SST_FE=device for the "
                    "on-device front end")
        # Wire format for host-FE cepstra: "i16p" ships round(cep*scale)
        # int16 as two byte planes, half the bytes of f32 cepstra; the
        # 1/scale cepstral quantization is the only loss and is far
        # below the model's own mixw/score quantization.  SST_WIRE=f32
        # restores the exact-wire path.  Whether the halved h2d bytes
        # pay for the dequantization on the GPU is not measured yet.
        #
        # i16p assumes |cep| < 32768/scale.  At the x256 scale that is
        # |cep| < 128: safe for the legacy transform (C0 = mean log mel
        # <= ~39) but dct/htk C0 = sum(logspec) * sqrt_inv_n can reach
        # ~150 on full-scale audio and would silently saturate (advisor
        # r3).  dct/htk therefore default to scale 128 (|cep| < 256
        # headroom, quantization 1/128 — still far below the model's
        # own mixw/score quantization); SST_WIRE=f32 restores the
        # exact wire.
        self.wire = os.environ.get("SST_WIRE", "i16p")
        default_scale = "256" if config["transform"] == "legacy" else "128"
        self.wire_scale = float(os.environ.get("SST_WIRE_SCALE",
                                               default_scale))
        # Serving size-class floors (AlignService.prewarm sets them):
        # tmax_floor pins the frame-axis class, graph_p_floor /
        # graph_k_floor pin the stacked-graph (node count, in-degree)
        # class — so compiled shapes stop depending on WHICH utterances
        # land in a batch.  Without the floors a batch composition
        # missing the longest audio or largest graph falls into a
        # smaller class and pays a fresh compile (seconds) mid-traffic.
        # Bigger inputs still grow the class past the floors.
        self.tmax_floor = int(os.environ.get("SST_TMAX_FLOOR", "0"))
        self.graph_p_floor = 0
        self.graph_k_floor = 0
        self.graph_w_floor = 0
        # data-parallel device mesh (use_mesh); None = single device
        self.mesh = None
        # Opt-in per-segment scores: the Viterbi also emits the token
        # score stack and the backtrace returns the cumulative path
        # score per frame, from which extraction derives per-phone /
        # per-word scores (the "p" fields of the reference result JSON,
        # decoder_result_json decoder.c:1502-1593).  Off by default —
        # it doubles the token-stack device-memory traffic on the
        # throughput path.
        self.want_scores = False

        if config["mllr"]:
            self.update_mllr(config["mllr"])

    def update_mllr(self, path: str):
        """Apply an MLLR transform to the acoustic model and rebuild the
        device scoring tables (acmod_update_mllr, acmod.c:316-325; the
        reference also applies config['mllr'] at init, acmod.c:122-126).
        Cached graph-restricted scorers are invalidated — they bake the
        transformed Gaussians."""
        from .mllr import Mllr, apply_mllr

        apply_mllr(self.am, Mllr(path), self.config)
        self.tables = ScorerTables.from_am(self.am)
        # every cache that (transitively) baked the old Gaussians or
        # closed over per-graph device constants
        for name in ("_graph_const_cache", "_vit_batch_jit",
                     "_stack_cache", "_uni"):
            if hasattr(self, name):
                delattr(self, name)

    # -- data-parallel mesh ------------------------------------------------

    def use_mesh(self, mesh) -> None:
        """Shard subsequent batch calls over the ('data',) axis of
        ``mesh`` (SURVEY §2.3 DP row: batch sharded over chips, model
        tables replicated).  The pipeline needs NO collectives — every
        stage is row-local — so the same jits compile to per-shard
        programs under GSPMD.  In a multi-process (multi-host) run,
        each host passes only its LOCAL rows to align_batch and gets
        its local results back (per-host data loading; no cross-host
        traffic on the hot path).  Pass None to return to single-device."""
        self.mesh = mesh
        # device caches hold arrays with the previous placement
        for name in ("_graph_const_cache", "_stack_cache"):
            if hasattr(self, name):
                getattr(self, name).clear()
        if hasattr(self, "_uni"):
            delattr(self, "_uni")

    def _nd_local(self) -> int:
        """Local device count of the mesh (divides the local batch)."""
        if self.mesh is None:
            return 1
        import jax as _jax
        return max(1, self.mesh.devices.size // max(1, _jax.process_count()))

    def _chunk_size(self, B: int) -> int:
        """Upload/compute overlap granularity: 128 rows up to B=512 and
        256 at B>=1024 (fewer dispatches once the batch is big enough to
        keep the device busy anyway; not yet tuned on the GPU).
        SST_BATCH_CHUNK overrides."""
        env = os.environ.get("SST_BATCH_CHUNK")
        if env:
            return max(1, int(env))
        return 256 if B >= 1024 else 128

    def _put_batch(self, x, axis: int = 0):
        """device_put with the batch axis sharded over ('data',) when a
        mesh is active; assembles per-process local rows into the
        global array in multi-host runs."""
        if self.mesh is None:
            return jax.device_put(x)
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = [None] * np.ndim(x)
        spec[axis] = "data"
        sh = NamedSharding(self.mesh, P(*spec))
        if jax.process_count() > 1:
            return jax.make_array_from_process_local_data(sh, np.asarray(x))
        return jax.device_put(x, sh)

    def _put_rep(self, x):
        """Replicated placement over the mesh (model/graph tables)."""
        if self.mesh is None:
            return jnp.asarray(x)
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(self.mesh, P())
        if jax.process_count() > 1:
            return jax.make_array_from_process_local_data(sh, np.asarray(x))
        return jax.device_put(x, sh)

    def _fetch_rows(self, x):
        """Device->host rows of a batch result: all rows single-host,
        THIS host's rows (in order) under multi-host sharding."""
        if getattr(x, "is_fully_addressable", True):
            return np.asarray(x)
        from .parallel.multihost import local_results
        return local_results(x)

    def spectrogram(self, audio: np.ndarray,
                    smooth: bool = False) -> np.ndarray:
        """Mel log-spectra [n_frames, nfilt] float32 (the JS binding's
        spectrogram(), js/soundswallower.c:88-112)."""
        return self.fe.spectrogram(audio, smooth)

    # -- graph -------------------------------------------------------------

    def graph_for_text(self, text: str) -> AlignGraph:
        g = self._graph_cache.get(text)
        if g is None:
            wids = []
            for w in text.split():
                wid = self.dict.wordid(w)
                if wid < 0:
                    raise KeyError(f"Unknown word {w}")
                wids.append(wid)
            g = build_chain_graph(wids, self.dict, self.d2p, self.am,
                                  self.lmath, self.config)
            self._graph_cache[text] = g
        return g

    # -- single utterance --------------------------------------------------

    def align(self, audio: np.ndarray, text: str) -> list[WordSeg]:
        """Align one int16 utterance against a transcript."""
        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            raise TypeError("align expects int16 audio")
        if self.native_fe is not None:
            # Route through the batch pipeline so single and batched
            # alignment share one code path (and one wire format).
            out = self._align_batch_same(
                [audio], self.graph_for_text(text))[0]
            if out is None:
                raise RuntimeError("Alignment failed to reach final state")
            return out
        n = len(audio)
        T = self.fe.n_frames(n)
        # Pad the frame axis to a bucket so recompiles only happen per
        # 128-frame size class, not per utterance length.
        Tpad = max(128, -(-T // 128) * 128)
        g = self.graph_for_text(text)
        cep = self.fe.mfcc(jnp.asarray(audio.astype(np.float32)), n, Tpad)
        feats = feats_full_utt(cep, jnp.int32(T), self.config["cmn"])
        sen_g = score_frames_graph(self._graph_consts(g)["gs"], feats)
        path, final_sc = self._viterbi_graph(g, sen_g, jnp.int32(T))
        return self._extract(g, np.asarray(path), T, int(final_sc))

    def _viterbi(self, g: AlignGraph, senscr, T: int):
        entry = np.where(g.is_entry, g.entry_pen, WORST_SCORE).astype(np.int32)
        # senone ids remapped into the scorer's codebook-grouped layout
        senid_g = self.tables.sen_remap[g.senid].astype(np.int32)
        pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst, g.edge_pen,
                                      len(g.senid))
        tok_id, tok_score, out_score, out_hist = align_viterbi(
            senscr, jnp.asarray(senid_g), self.tmat_i32[jnp.asarray(g.tmatid)],
            jnp.asarray(pi), jnp.asarray(pp), jnp.asarray(pk),
            jnp.asarray(g.astart), jnp.asarray(g.aend),
            T, jnp.asarray(entry), False)
        fin = jnp.asarray(g.final_nodes)
        fsc = out_score[fin]
        best = jnp.argmax(fsc)
        final_node = fin[best]
        final_state = out_hist[final_node]
        final_score = out_score[final_node]
        path, _ = backtrace(tok_id, None, final_state, final_score,
                            jnp.int32(T))
        return path, final_score

    def _viterbi_graph(self, g: AlignGraph, sen_g, T):
        """Single-utterance Viterbi over graph-state scores [T, S] from
        score_frames_graph (senone gather already applied; the identity
        senid makes align_viterbi's internal gather a no-op)."""
        c = self._graph_consts(g)
        P, E = g.senid.shape
        ident = jnp.arange(P * E, dtype=jnp.int32).reshape(P, E)
        tok_id, _, out_score, out_hist = align_viterbi(
            sen_g, ident, c["tp"], c["pi"], c["pp"], c["pk"],
            c["ast"], c["aen"], T, c["entry"], False)
        fin = c["fin"]
        fsc = out_score[fin]
        final_node = fin[jnp.argmax(fsc)]
        final_state = out_hist[final_node]
        final_score = out_score[final_node]
        path, _ = backtrace(tok_id, None, final_state, final_score,
                            jnp.int32(T))
        return path, final_score

    def _extract(self, g: AlignGraph, path, T: int,
                 final_score: int, pscore=None, ch=None) -> list[WordSeg]:
        """Decoded state path -> word/phone segments.

        Follows state_align_search_finish's boundary rule
        (state_align_search.c:236-255): a state's segment starts at the
        frame after its backpointer changes.

        pscore (optional, [T] int32): cumulative Viterbi path score per
        frame (want_scores mode).  Per-phone score = the cumulative
        difference across the segment (alignment_propagate's roll-up,
        ps_alignment.c:316-352); word score = sum of its phones.
        """
        if path[T - 1] < 0:
            raise RuntimeError("Alignment failed to reach final state")
        # State runs over the path.  Interior boundaries are shifted +1 to
        # match the reference convention (state_align_search_finish uses
        # ent->start = cur_frame + 1, state_align_search.c:247): the first
        # segment absorbs one extra frame, the last loses one.
        # (vectorized: the per-frame Python loop was ~0.1 ms/utt, which
        # at B=512 batches was ~6% of end-to-end wall time)
        p = np.asarray(path[:T])
        if ch is None:
            ch = np.nonzero(p[1:] != p[:-1])[0]  # change between t=ch, ch+1
        else:
            # precomputed whole-batch change points (over the padded
            # row) — keep only those inside the live frame range
            ch = ch[ch < T - 1]
        E = g.senid.shape[1]
        # State runs -> phone runs, fully in numpy (the per-run Python
        # loop was ~45 ms/batch at B=512).  Run i covers frames
        # [starts[i], ends[i]); bounds partition [0, T] with the +1
        # interior shift of the reference convention, so only the LAST
        # run can be empty (when the last change lands at T-2).
        n_runs = len(ch) + 1
        states = np.empty(n_runs, np.int64)
        states[:-1] = p[ch]
        states[-1] = int(p[T - 1])
        starts = np.empty(n_runs, np.int64)
        starts[0] = 0
        starts[1:] = ch + 2                      # +1: reference convention
        ends = np.empty(n_runs, np.int64)
        ends[:-1] = ch + 2
        ends[-1] = T
        if n_runs > 1 and ends[-1] == starts[-1]:
            states, starts, ends = states[:-1], starts[:-1], ends[:-1]
        nodes = states // E
        # merge consecutive same-node runs into phone segments
        pb = np.nonzero(np.concatenate(([True], nodes[1:] != nodes[:-1])))[0]
        p_node = nodes[pb].tolist()
        p_start = starts[pb]
        p_end = np.concatenate((p_start[1:], ends[-1:]))
        if pscore is not None:
            hi = np.asarray(pscore)[p_end - 1].astype(np.int64)
            lo = np.where(p_start > 0,
                          np.asarray(pscore)[np.maximum(p_start, 1) - 1],
                          0).astype(np.int64)
            p_sc = (hi - lo).tolist()
        else:
            p_sc = [0] * len(pb)
        p_dur = (p_end - p_start).tolist()
        p_start = p_start.tolist()
        # per-run HMM-state segments (the innermost JSON nesting) —
        # run boundaries ARE state boundaries, so this is just a
        # senone lookup + per-run score diff
        st_per_phone = None
        if getattr(self, "want_states", False):
            emits = states % E
            senids = np.asarray(g.senid)[nodes, emits].tolist()
            if pscore is not None:
                ps = np.asarray(pscore)
                r_hi = ps[ends - 1].astype(np.int64)
                r_lo = np.where(starts > 0, ps[np.maximum(starts, 1) - 1],
                                0).astype(np.int64)
                r_sc = (r_hi - r_lo).tolist()
            else:
                r_sc = [0] * len(nodes)
            pb2 = pb.tolist() + [len(nodes)]
            r_starts = starts.tolist()
            r_durs = (ends - starts).tolist()
            st_per_phone = [
                [(senids[j], r_starts[j], r_durs[j], r_sc[j])
                 for j in range(pb2[i], pb2[i + 1])]
                for i in range(len(pb))
            ]
        # group phone nodes into words
        cur_word = None
        cur = None
        out: list[WordSeg] = []
        for i, (node, start, dur, sc) in enumerate(
                zip(p_node, p_start, p_dur, p_sc)):
            w = int(g.word_of[node])
            ci = self.am.mdef.ciphone_str(int(g.cipid[node]))
            sts = None if st_per_phone is None else [st_per_phone[i]]
            if w < 0:
                out.append(WordSeg("<sil>", start, dur, score=sc,
                                   phones=[(ci, start, dur, sc)],
                                   states=sts))
                cur_word = None
                continue
            if cur_word != w:
                cur = WordSeg(self.dict.wordstr(int(g.variant_of[node])),
                              start, 0, phones=[],
                              states=None if st_per_phone is None else [])
                out.append(cur)
                cur_word = w
            cur.duration += dur
            cur.score += sc
            cur.phones.append((ci, start, dur, sc))
            if st_per_phone is not None:
                cur.states.append(st_per_phone[i])
        return out

    # -- batch -------------------------------------------------------------

    def align_batch(self, audios: list[np.ndarray],
                    texts: list[str]) -> list[list[WordSeg]]:
        """Batch alignment.  Same-transcript batches run fully
        vectorized through the graph-restricted scorer; batches of
        DIFFERENT transcripts run as ONE multi-graph dispatch (dense
        scoring + per-row graph Viterbi — see _batch_begin_mixed)."""
        if len(set(texts)) != 1:
            out: list = [None] * len(audios)
            graphs, idxs = [], []
            for i, t in enumerate(texts):
                try:
                    graphs.append(self.graph_for_text(t))
                except KeyError:
                    continue  # unknown word: that utterance stays None
                idxs.append(i)
            if not idxs:
                return out
            h = self._batch_begin_mixed(graphs,
                                        [audios[i] for i in idxs])
            for i, segs in zip(idxs, self._batch_end(h)):
                out[i] = segs
            return out
        g = self.graph_for_text(texts[0])
        return self._align_batch_same(audios, g)

    def align_batch_scored(self, audios: list[np.ndarray],
                           texts: list[str]) -> list:
        """Batch alignment WITH per-segment scores (WordSeg.score and
        per-phone scores filled) — the CLI / result-JSON path.  Routes
        through the multi-graph dense-scoring dispatch even for
        same-text batches: the dense scorer normalizes 0=best per frame
        (like acmod's compallsen convention), so cumulative path-score
        differences give per-segment scores in the same units the
        reference's result JSON exponentiates (decoder_result_json,
        decoder.c:1502-1593)."""
        graphs = [self.graph_for_text(t) for t in texts]
        prev = self.want_scores
        self.want_scores = True
        try:
            return self._batch_end(
                self._batch_begin_mixed(graphs, audios))
        finally:
            self.want_scores = prev

    def decode_batch_scored(self, audios: list[np.ndarray]) -> list:
        """decode_batch WITH per-segment scores (see align_batch_scored;
        needs set_grammar() first).  Returns (hyp, segs) or None per
        utterance."""
        g = getattr(self, "_decode_graph", None)
        if g is None:
            raise RuntimeError("call set_grammar() first")
        prev = self.want_scores
        self.want_scores = True
        try:
            handle = self._batch_begin_mixed([g] * len(audios), audios)
        finally:
            self.want_scores = prev
        _, Ts, paths_d, pscore_d, _final_d, realB = handle
        paths = np.asarray(paths_d)
        pscores = np.asarray(pscore_d)
        results = []
        for i in range(realB):
            try:
                segs = self._extract_decode(g, paths[i], int(Ts[i]),
                                            pscores[i])
                hyp = " ".join(
                    self.dict.wordstr(self.dict.basewid_of(s.wid))
                    for s in segs if not self.dict.filler_word(s.wid))
                results.append((hyp, segs))
            except RuntimeError:
                results.append(None)
        return results

    def _align_batch_same(self, audios, g: AlignGraph):
        """Shared-graph batch alignment (also the single-utterance path
        when the native host FE is available)."""
        return self._batch_end(self._batch_begin(g, audios))

    # -- pipelined batch API ------------------------------------------------
    #
    # align_batch == align_batch_end(align_batch_begin(...)).  Splitting
    # the two lets a caller overlap batch k+1's host FE + h2d upload with
    # batch k's device compute + d2h download (the steady-state serving
    # pattern; serve.py and bench.py use it).  begin() does all host-side
    # work and *dispatches* everything (dispatch is async on this
    # platform); end() fetches the decoded paths and extracts segments.

    def align_batch_begin(self, audios: list[np.ndarray], texts: list[str]):
        """Dispatch one batch; returns a handle for align_batch_end.
        Same-transcript batches ride the graph-restricted scorer; mixed
        transcripts the multi-graph single dispatch.  Unknown words
        raise KeyError — callers needing per-request isolation should
        resolve graph_for_text per text first."""
        if len(set(texts)) == 1:
            g = self.graph_for_text(texts[0])
            return self._batch_begin(g, audios)
        graphs = [self.graph_for_text(t) for t in texts]
        return self._batch_begin_mixed(graphs, audios)

    def align_batch_end(self, handle) -> list[list[WordSeg]]:
        """Fetch + extract the results of an align_batch_begin batch."""
        return self._batch_end(handle)

    def _batch_end(self, handle):
        g, Ts, paths_d, pscore_d, final_d, realB = handle
        paths = self._fetch_rows(paths_d)
        pscores = None if pscore_d is None else self._fetch_rows(pscore_d)
        final_sc = self._fetch_rows(final_d)
        if realB == 0:
            return []
        if pscores is None and not getattr(self, "want_states", False):
            out = self._extract_batch_native(g, paths, Ts, realB)
            if out is not None:
                return out
        # One whole-batch change-point pass (paths[:,1:] != paths[:,:-1])
        # instead of a per-row nonzero: at B=512 the per-row numpy-call
        # overhead was ~half of a 50 ms extract stage.
        if realB and paths.shape[0]:
            diff = paths[:realB, 1:] != paths[:realB, :-1]
            rows, cols = np.nonzero(diff)
            split = np.searchsorted(rows, np.arange(realB + 1))
        return [
            self._extract_safe(g[i] if isinstance(g, list) else g,
                               paths[i], int(Ts[i]), int(final_sc[i]),
                               None if pscores is None else pscores[i],
                               ch=cols[split[i]:split[i + 1]])
            for i in range(realB)
        ]

    def _extract_batch_native(self, g, paths, Ts, realB):
        """Whole-batch segment extraction via native/sst_seg.cpp (the
        throughput path: no per-segment scores, no state level).
        Returns None when the library is unavailable, falling back to
        the Python extraction.  Semantics identical to _extract —
        tests/test_align_tpu.py compares the two."""
        import ctypes as ct

        if not hasattr(self, "_segl"):
            from .utils.native_build import load_native
            lib = load_native("libsst_seg.so")
            if lib is not None:
                i32p = np.ctypeslib.ndpointer(np.int32)
                i64p = np.ctypeslib.ndpointer(np.int64)
                lib.sst_extract_batch.restype = ct.c_int
                lib.sst_extract_batch.argtypes = [
                    np.ctypeslib.ndpointer(np.int16), ct.c_int, ct.c_int,
                    i64p, ct.c_int, i32p, i32p, i32p, i64p,
                    i32p, i32p, i32p, i32p, i32p, i32p,
                    i32p, i32p, i32p, ct.c_int64, ct.c_int64,
                ]
            self._segl = lib
        lib = self._segl
        if lib is None:
            return None
        graphs = g if isinstance(g, list) else [g] * realB
        # concatenated per-row node tables, cached per graph tuple
        if not hasattr(self, "_seg_tab_cache"):
            self._seg_tab_cache = {}
        key = tuple(gr.serial for gr in graphs)
        tab = self._seg_tab_cache.get(key)
        if tab is None:
            offs = np.zeros(realB + 1, np.int64)
            per: dict[int, int] = {}
            uniq = []
            for gr in graphs:
                if gr.serial not in per:
                    per[gr.serial] = len(uniq)
                    uniq.append(gr)
            starts = np.zeros(len(uniq), np.int64)
            pos = 0
            for i, gr in enumerate(uniq):
                starts[i] = pos
                pos += len(gr.word_of)
            wo = np.concatenate([gr.word_of for gr in uniq]).astype(np.int32)
            vo = np.concatenate(
                [gr.variant_of for gr in uniq]).astype(np.int32)
            cp = np.concatenate([gr.cipid for gr in uniq]).astype(np.int32)
            for b, gr in enumerate(graphs):
                offs[b] = starts[per[gr.serial]]
            tab = (wo, vo, cp, offs)
            if len(self._seg_tab_cache) >= 64:
                self._seg_tab_cache.pop(next(iter(self._seg_tab_cache)))
            self._seg_tab_cache[key] = tab
        wo, vo, cp, offs = tab
        paths = np.ascontiguousarray(paths[:realB], np.int16)
        Ts64 = np.ascontiguousarray(Ts[:realB], np.int64)
        E = graphs[0].senid.shape[1]
        cap_p = int(Ts64.sum()) + realB
        cap_w = cap_p
        nw = np.empty(realB, np.int32)
        w_kind = np.empty(cap_w, np.int32)
        w_var = np.empty(cap_w, np.int32)
        w_start = np.empty(cap_w, np.int32)
        w_dur = np.empty(cap_w, np.int32)
        w_np = np.empty(cap_w, np.int32)
        p_ci = np.empty(cap_p, np.int32)
        p_start = np.empty(cap_p, np.int32)
        p_dur = np.empty(cap_p, np.int32)
        rc = lib.sst_extract_batch(
            paths, realB, paths.shape[1], Ts64, E, wo, vo, cp, offs,
            nw, w_kind, w_var, w_start, w_dur, w_np,
            p_ci, p_start, p_dur, cap_w, cap_p)
        if rc != 0:
            return None
        ci_strs = self._ci_strs()
        wstr = self._wordstr_cache()
        out: list = []
        wi = pi = 0
        for b in range(realB):
            n = int(nw[b])
            if n < 0:
                out.append(None)
                continue
            segs = []
            for _ in range(n):
                np_ = int(w_np[wi])
                phones = [(ci_strs[p_ci[pi + j]], int(p_start[pi + j]),
                           int(p_dur[pi + j]), 0) for j in range(np_)]
                word = "<sil>" if w_kind[wi] else wstr(int(w_var[wi]))
                segs.append(WordSeg(word, int(w_start[wi]), int(w_dur[wi]),
                                    phones=phones))
                wi += 1
                pi += np_
            out.append(segs)
        return out

    def _ci_strs(self):
        if not hasattr(self, "_ci_str_list"):
            m = self.am.mdef
            self._ci_str_list = [m.ciphone_str(i)
                                 for i in range(m.n_ciphone)]
        return self._ci_str_list

    def _wordstr_cache(self):
        if not hasattr(self, "_wstr_map"):
            self._wstr_map = {}

        def wstr(wid: int) -> str:
            s = self._wstr_map.get(wid)
            if s is None:
                s = self._wstr_map[wid] = self.dict.wordstr(wid)
            return s

        return wstr

    def _batch_begin(self, g: AlignGraph, audios):
        """Shared chunk-pipelined batch path: per chunk, host FE (or
        device FE) -> upload -> dynamic features -> dense senone scoring
        with the [n_sen]->[S] graph gather folded in; then ONE whole-batch
        Viterbi + backtrace with the batch in the vector lanes
        (align_viterbi_batch).  Chunking exists so chunk i+1's host FE and
        h2d upload overlap chunk i's device compute; the Viterbi runs
        over the full batch because its scan cost is per-FRAME, not
        per-utterance, once the batch fills the lanes.  The wire path
        reads straight from the caller's per-utterance arrays (no padded
        [B, N] batch copy)."""
        realB = len(audios)
        if realB == 0:
            return (g, np.zeros(0, np.int64), np.zeros((0, 0), np.int16),
                    None, np.zeros(0, np.int32), 0)
        if self.am.backend == "ms":
            # ms models have no graph-restricted scorer: score dense
            # (score_frames' ms path) + per-row gather via the
            # multi-graph machinery
            return self._batch_begin_mixed([g] * realB, audios)
        # Bucket the batch size so serving-style variable batches reuse
        # a bounded set of compiled shapes (a first compile of a new
        # shape takes seconds); pad rows repeat the last utterance and are
        # dropped in _batch_end.
        B = (max(8, 1 << (realB - 1).bit_length()) if realB <= 64
             else -(-realB // 64) * 64)
        nd = self._nd_local()
        B = -(-B // nd) * nd              # divisible over the mesh shard
        audios = list(audios) + [audios[-1]] * (B - realB)
        ns = np.array([len(a) for a in audios])
        Ts = np.array([self.fe.n_frames(int(n)) for n in ns])
        Tmax = max(64, self.tmax_floor, -(-int(Ts.max()) // 64) * 64)
        chunk = self._chunk_size(B)
        if self.mesh is not None:
            # one chunk: chunked uploads would each shard over the whole
            # mesh and the concat would reshard (cross-device traffic)
            chunk = B
        buf = None
        fe_futs = None
        if self.native_fe is None or self.wire != "i16p":
            buf = np.zeros((B, int(ns.max())), np.int16)
            for i, a in enumerate(audios):
                buf[i, : len(a)] = a
        else:
            # Prefetch the host FE on a worker thread (the C FE releases
            # the GIL and threads internally): FE for chunk i+1 runs
            # while this thread blocks in the dispatch RPCs for chunk i.
            if not hasattr(self, "_fe_pool"):
                from concurrent.futures import ThreadPoolExecutor
                self._fe_pool = ThreadPoolExecutor(max_workers=1)
            fe_futs = [
                self._fe_pool.submit(self.native_fe.process_list_i16p,
                                     audios[i0:i0 + chunk], Tmax,
                                     self.wire_scale)
                for i0 in range(0, B, chunk)
            ]
        sen_chunks = []
        for ci, i0 in enumerate(range(0, B, chunk)):
            Ts_d = self._put_batch(Ts[i0:i0 + chunk])
            if fe_futs is not None:
                pl = fe_futs[ci].result()
                sen_g = self._score_chunk_planes(
                    g, self._put_batch(pl, axis=1), Ts_d, Tmax)
            elif self.native_fe is not None:
                cep = self.native_fe.process_batch(
                    buf[i0:i0 + chunk], ns[i0:i0 + chunk], Tmax)
                sen_g = self._score_chunk_cep(g, self._put_batch(cep), Ts_d,
                                              Tmax)
            else:
                buf_d = self._put_batch(buf[i0:i0 + chunk])
                ns_d = self._put_batch(ns[i0:i0 + chunk])
                sen_g = self._score_chunk_raw(g, buf_d, ns_d, Ts_d, Tmax)
            sen_chunks.append(sen_g)
        sen_all = sen_chunks[0] if len(sen_chunks) == 1 \
            else jnp.concatenate(sen_chunks, axis=0)
        paths, pscore, final_sc = self._vit_full(
            g, sen_all, self._put_batch(Ts.astype(np.int32)))
        if getattr(paths, "is_fully_addressable", True):
            paths.copy_to_host_async()
            if pscore is not None:
                pscore.copy_to_host_async()
            final_sc.copy_to_host_async()
        return (g, Ts[:realB], paths, pscore, final_sc, realB)

    def _batch_begin_mixed(self, graphs: list, audios):
        """ONE dispatch chain for a batch of DIFFERENT transcripts.

        Stages (none closes over graph data, so compiled shapes depend
        only on batch geometry + the (P, K) graph size class + the
        union working-set bucket, never on transcripts — a new
        transcript costs a host graph build, not a recompile):

        1. union-restricted senone scoring over all rows' frames
           (score_frames_graph on the batch's working-set union — see
           _union_scorer; falls back to dense score_frames for
           want_scores, whose "p" fields need the dense compallsen
           normalization, or once the working set covers most of the
           inventory),
        2. a per-row column gather into each row's graph-state order
           (_gather_cols with stack_graphs' sencols),
        3. per-row-graph lane-major Viterbi: align_viterbi_batch's
           [B, ...] form over stack_graphs tensors (banded transitions
           for chain graphs — see make_vit_step_lanes).

        The reference's real workload is one transcript per document
        (js/api.js:491)."""
        realB = len(audios)
        if realB == 0:
            return ([], np.zeros(0, np.int64), np.zeros((0, 0), np.int16),
                    None, np.zeros(0, np.int32), 0)
        B = (max(8, 1 << (realB - 1).bit_length()) if realB <= 64
             else -(-realB // 64) * 64)
        nd = self._nd_local()
        B = -(-B // nd) * nd              # divisible over the mesh shard
        audios = list(audios) + [audios[-1]] * (B - realB)
        graphs = list(graphs) + [graphs[-1]] * (B - realB)
        uni = None if self.want_scores else self._union_scorer(graphs)
        if uni is None:
            st = self._stacked_graphs(graphs)
        else:
            st = self._stacked_graphs(graphs, remap=uni["pos"],
                                      remap_ver=uni["ver"])
        # per-row codebook sets: each row is normalized over its own
        # graph's codebooks, so its scores equal those of the row aligned
        # alone (want_scores keeps compallsen scores for the "p" fields)
        row_cbs = None
        if not self.want_scores and self.am.backend != "ms":
            row_cbs = self._put_batch(self._row_codebooks(
                graphs, None if uni is None else uni["cb_row"]))
        ns = np.array([len(a) for a in audios])
        Ts = np.array([self.fe.n_frames(int(n)) for n in ns])
        Tmax = max(64, self.tmax_floor, -(-int(Ts.max()) // 64) * 64)
        chunk = self._chunk_size(B)
        if self.mesh is not None:
            chunk = B                     # see _batch_begin
        buf = None
        fe_futs = None
        if self.native_fe is None or self.wire != "i16p":
            buf = np.zeros((B, int(ns.max())), np.int16)
            for i, a in enumerate(audios):
                buf[i, : len(a)] = a
        else:
            if not hasattr(self, "_fe_pool"):
                from concurrent.futures import ThreadPoolExecutor
                self._fe_pool = ThreadPoolExecutor(max_workers=1)
            fe_futs = [
                self._fe_pool.submit(self.native_fe.process_list_i16p,
                                     audios[i0:i0 + chunk], Tmax,
                                     self.wire_scale)
                for i0 in range(0, B, chunk)
            ]
        sen_chunks = []
        for ci, i0 in enumerate(range(0, B, chunk)):
            Ts_d = self._put_batch(Ts[i0:i0 + chunk])
            if fe_futs is not None:
                pl = fe_futs[ci].result()
                feats = self._feats_chunk_planes(
                    self._put_batch(pl, axis=1), Ts_d, Tmax)
            elif self.native_fe is not None:
                cep = self.native_fe.process_batch(
                    buf[i0:i0 + chunk], ns[i0:i0 + chunk], Tmax)
                feats = self._feats_chunk_cep(self._put_batch(cep), Ts_d,
                                              Tmax)
            else:
                feats = self._feats_chunk_raw(
                    self._put_batch(buf[i0:i0 + chunk]),
                    self._put_batch(ns[i0:i0 + chunk]), Ts_d, Tmax)
            flat = feats.reshape((-1,) + feats.shape[2:])
            cbs = None if row_cbs is None else row_cbs[i0:i0 + chunk]
            if uni is not None:
                dense = score_frames_graph(uni["gs"], flat, cbs)  # [cT, Su]
            else:
                dense = score_frames(self.tables, flat, cbs)      # [cT, G]
            dense = dense.reshape(feats.shape[0], Tmax, -1)
            sen_chunks.append(
                _gather_cols(dense, st["sencols"][i0:i0 + chunk]))
        sen_all = sen_chunks[0] if len(sen_chunks) == 1 \
            else jnp.concatenate(sen_chunks, axis=0)
        paths, pscore, final_sc = self._vit_full_mg(
            st, sen_all, self._put_batch(Ts.astype(np.int32)))
        if getattr(paths, "is_fully_addressable", True):
            paths.copy_to_host_async()
            if pscore is not None:
                pscore.copy_to_host_async()
            final_sc.copy_to_host_async()
        return (graphs[:realB], Ts[:realB], paths, pscore, final_sc, realB)

    def _row_codebooks(self, graphs: list, cb_row=None) -> np.ndarray:
        """bool [B, C]: the codebooks each row's graph uses, as columns
        of the dense scorer (C = n_cb) or, given cb_row (codebook ->
        union-scorer row), of the union scorer."""
        sen2cb = np.asarray(self.am.sen2cb, np.int64)
        n = self.am.n_mgau if cb_row is None else int(cb_row.max()) + 1
        out = np.zeros((len(graphs), n), bool)
        for b, g in enumerate(graphs):
            cbs = np.unique(sen2cb[g.senid.ravel()])
            out[b, cbs if cb_row is None else cb_row[cbs]] = True
        return out

    # mixed batches switch from union-restricted to dense scoring once
    # the working set covers most of the senone inventory (the union
    # scorer's selection matmul would then cost MORE than dense)
    UNION_MAX_FRAC = 0.6

    def _union_scorer(self, graphs: list):
        """Working-set union scorer for mixed-transcript batches.

        Dense scoring evaluates all ~n_sen grouped senone columns per
        frame; a batch of B transcripts only ever reads the UNION of
        its graphs' senones (a few hundred for typical documents) —
        28x fewer mixture-eval columns on the reference workload.  The
        union grows MONOTONICALLY over the aligner's lifetime (the
        serving working set), bucketed to multiples of 256, so batch
        compositions never shrink the compiled shape class and a new
        transcript costs a scorer rebuild only when it grows the
        bucket.  Returns None once the working set exceeds
        UNION_MAX_FRAC of the inventory (dense is cheaper there).
        """
        u = getattr(self, "_uni", None)
        if u is None:
            u = self._uni = dict(ver=0, senset=np.zeros(0, np.int64),
                                 gs=None, Spad=0,
                                 dense=self.am.backend == "ms",
                                 pos=np.full(self.am.n_sen, -1, np.int32))
        if u["dense"]:
            return None
        need = np.unique(np.concatenate(
            [g.senid.ravel() for g in graphs]).astype(np.int64))
        if u["gs"] is None or np.any(u["pos"][need] < 0):
            senset = np.unique(np.concatenate([u["senset"], need]))
            if len(senset) > self.UNION_MAX_FRAC * self.am.n_sen:
                u["dense"] = True
                return None
            Spad = max(256, -(-len(senset) // 256) * 256, u["Spad"])
            senid_flat = np.zeros(Spad, np.int64)  # pad cols: senone 0
            senid_flat[: len(senset)] = senset
            pos = np.full(self.am.n_sen, -1, np.int32)
            pos[senset] = np.arange(len(senset), dtype=np.int32)
            gs = GraphScorer.build(self.am, self.tables, senid_flat)
            # codebook -> row of the union scorer (GraphScorer.build
            # keeps the used codebooks in sorted order)
            used = np.unique(np.asarray(self.am.sen2cb)[senid_flat])
            cb_row = np.full(self.am.n_mgau, -1, np.int64)
            cb_row[used] = np.arange(len(used))
            if self.mesh is not None:
                gs = jax.tree_util.tree_map(
                    lambda x: self._put_rep(np.asarray(x)), gs)
            u.update(ver=u["ver"] + 1, senset=senset, Spad=Spad, pos=pos,
                     gs=gs, cb_row=cb_row)
        return u

    def _stacked_graphs(self, graphs: list, remap: np.ndarray | None = None,
                        remap_ver: int = 0):
        """stack_graphs + device upload, cached by the graph-serial
        tuple (steady-state serving repeats batch compositions; the
        stack is a few ms of host work + ~MBs of upload, worth
        skipping).  ``remap`` overrides the senone-column remap
        (union-scorer positions instead of the dense grouped layout);
        ``remap_ver`` keys the cache for it."""
        if not hasattr(self, "_stack_cache"):
            self._stack_cache = {}
        key = (tuple(g.serial for g in graphs), remap_ver,
               self.graph_p_floor, self.graph_k_floor, self.graph_w_floor)
        st = self._stack_cache.get(key)
        if st is None:
            raw = stack_graphs(graphs, self.am.tmat.astype(np.int32),
                               self.tables.sen_remap if remap is None
                               else remap,
                               p_floor=self.graph_p_floor,
                               k_floor=self.graph_k_floor,
                               w_floor=self.graph_w_floor)
            # every stacked tensor is batch-major -> shard axis 0 when
            # a data mesh is active (tables are per-ROW graph data)
            st = {k: (self._put_batch(v) if isinstance(v, np.ndarray) else v)
                  for k, v in raw.items()}
            if len(self._stack_cache) >= 32:
                self._stack_cache.pop(next(iter(self._stack_cache)))
            self._stack_cache[key] = st
        return st

    def _vit_full_mg(self, st: dict, sen_all, Ts_d):
        """Whole-batch per-row-graph Viterbi + masked final-node select
        + batched backtrace.  One jax.jit: its cache keys on shapes
        (B, T, S, K), i.e. on size classes only."""
        if not hasattr(self, "_vit_mg_jit"):
            self._vit_mg_jit = {}
        ws = self.want_scores
        vit_j = self._vit_mg_jit.get(ws)
        if vit_j is None:
            def run(sg, tp, pi, pp, pk, ast, aen, entry, finmask, Ts,
                    band_pen=None, band_ok=None):
                tok_id, tok_sc, out_score, out_hist = align_viterbi_batch(
                    sg, tp, pi, pp, pk, ast, aen, Ts, ws, entry,
                    band_pen=band_pen, band_ok=band_ok)
                worst = jnp.int32(WORST_SCORE)
                fsc = jnp.where(finmask, out_score, worst)  # [B, P]
                final_node = jnp.argmax(fsc, axis=1)
                rows = jnp.arange(sg.shape[0])
                fscore = fsc[rows, final_node]
                # no final node reached -> backtrace from -1 so
                # extraction reports failure for that row only
                fstate = jnp.where(fscore > worst,
                                   out_hist[rows, final_node], -1)

                path, pscore = backtrace_batch(
                    tok_id, tok_sc if ws else None, fstate, fscore, Ts)
                if sg.shape[-1] < 32767:
                    path = path.astype(jnp.int16)
                return path, pscore, fscore

            vit_j = self._vit_mg_jit[ws] = jax.jit(run)
        return vit_j(sen_all, st["tp"], st["pred_idx"],
                     st["pred_pen"], st["pred_ok"],
                     st["astart"], st["aend"], st["entry"],
                     st["final_mask"], Ts_d,
                     band_pen=st.get("band_pen"),
                     band_ok=st.get("band_ok"))

    def _extract_safe(self, g, path, T, final_score, pscore=None,
                      ch=None):
        """Per-utterance failure isolation (SURVEY §5: an unreachable
        alignment flags THAT utterance, it doesn't kill the batch)."""
        try:
            return self._extract(g, path, T, final_score, pscore, ch=ch)
        except RuntimeError:
            return None

    # -- grammar decoding ----------------------------------------------------

    def set_grammar(self, fsg=None, jsgf_file: str | None = None,
                    jsgf_string: str | None = None):
        """Compile a grammar (FsgModel / JSGF) into a static decode
        graph for dense device Viterbi (ops/decode_graph.py).  Silence
        self-loops and alternate pronunciations are added per config
        like fsg_search_init (fsg_search.c:84-170)."""
        from .jsgf import Jsgf
        from .ops.decode_graph import build_fsg_graph

        if jsgf_file is not None or jsgf_string is not None:
            j = Jsgf.parse_file(jsgf_file) if jsgf_file \
                else Jsgf.parse_string(jsgf_string)
            rule = j.get_rule(self.config["toprule"]) \
                if self.config["toprule"] else j.default_rule()
            fsg = j.build_fsg(rule, self.lmath, self.config.get_float("lw"))
        if fsg is None:
            raise ValueError("need fsg, jsgf_file, or jsgf_string")
        if self.config.get_bool("fsgusefiller") and not fsg.has_sil:
            fsg.add_silence("<sil>", -1, self.config.get_float("silprob"))
            for wid in range(self.dict.filler_start,
                             self.dict.filler_end + 1):
                if wid in (self.dict.startwid, self.dict.finishwid,
                           self.dict.silwid):
                    continue
                fsg.add_silence(self.dict.wordstr(wid), -1,
                                self.config.get_float("fillprob"))
        if self.config.get_bool("fsgusealtpron") and not fsg.has_alt:
            for word in list(fsg.vocab):
                wid = self.dict.wordid(word)
                if wid < 0:
                    continue
                alt = self.dict.nextalt(wid)
                while alt >= 0:
                    fsg.add_alt(word, self.dict.wordstr(alt))
                    alt = self.dict.nextalt(alt)
        self._decode_graph = build_fsg_graph(
            fsg, self.dict, self.d2p, self.am, self.lmath, self.config)
        self._decode_fsg = fsg
        return self._decode_graph

    def decode(self, audio: np.ndarray) -> tuple[str, list[WordSeg]]:
        """Grammar decode one int16 utterance against the graph from
        set_grammar(): dense global Viterbi over the compiled search
        space (no beams — exact search).  Returns (hyp text, segs)."""
        g = getattr(self, "_decode_graph", None)
        if g is None:
            raise RuntimeError("call set_grammar() first")
        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            raise TypeError("decode expects int16 audio")
        if self.native_fe is not None:
            # Share the batch pipeline (and wire format) with
            # decode_batch so single and batched decode agree exactly.
            res = self.decode_batch([audio])[0]
            if res is None:
                raise RuntimeError("Decode failed to reach final state")
            return res
        n = len(audio)
        T = self.fe.n_frames(n)
        Tpad = max(128, -(-T // 128) * 128)
        cep = self.fe.mfcc(jnp.asarray(audio.astype(np.float32)), n, Tpad)
        feats = feats_full_utt(cep, jnp.int32(T), self.config["cmn"])
        sen_g = score_frames_graph(self._graph_consts(g)["gs"], feats)
        path, final_sc = self._viterbi_graph(g, sen_g, jnp.int32(T))
        segs = self._extract_decode(g, np.asarray(path), T)
        hyp = " ".join(
            self.dict.wordstr(self.dict.basewid_of(s.wid))
            for s in segs if not self.dict.filler_word(s.wid))
        return hyp, segs

    def decode_batch(self, audios: list[np.ndarray]) -> list:
        """Vectorized grammar decode of a batch against the graph from
        set_grammar(): the same chunk-pipelined path as align_batch
        (host FE -> upload -> scoring -> vmapped Viterbi).  Returns
        (hyp, segs) per utterance; None for failed utterances."""
        g = getattr(self, "_decode_graph", None)
        if g is None:
            raise RuntimeError("call set_grammar() first")
        B = len(audios)
        Ts = np.array([self.fe.n_frames(len(a)) for a in audios])
        _, _, paths_d, pscore_d, _final_d, _realB = self._batch_begin(
            g, audios)
        paths = np.asarray(paths_d)
        pscores = None if pscore_d is None else np.asarray(pscore_d)
        results = []
        for i in range(B):
            try:
                segs = self._extract_decode(
                    g, paths[i], int(Ts[i]),
                    None if pscores is None else pscores[i])
                hyp = " ".join(
                    self.dict.wordstr(self.dict.basewid_of(s.wid))
                    for s in segs if not self.dict.filler_word(s.wid))
                results.append((hyp, segs))
            except RuntimeError:
                results.append(None)
        return results

    def _extract_decode(self, g: AlignGraph, path, T: int,
                        pscore=None) -> list[WordSeg]:
        """Decode-path extraction: unlike the alignment chain, a graph
        traversal can RE-ENTER the same node (self-loop grammars).  A
        within-node HMM-state decrease marks the re-entry boundary;
        words group by runs of the same graph transition (word_of), with
        a new traversal starting whenever the phone position does not
        advance."""
        if path[T - 1] < 0:
            raise RuntimeError("Decode failed to reach final state")
        p = np.asarray(path[:T])
        E = g.senid.shape[1]
        node = p // E
        state = p % E
        change = (node[1:] != node[:-1]) | (state[1:] < state[:-1])
        ch = np.nonzero(change)[0]
        bounds = [0] + (ch + 2).tolist() + [T]
        nodes_seq = node[ch].tolist() + [int(node[T - 1])]
        def seg_score(s, e):  # frames [s, e)
            if pscore is None:
                return 0
            hi = int(pscore[min(e, T) - 1])
            lo = int(pscore[s - 1]) if s > 0 else 0
            return hi - lo

        segs: list[WordSeg] = []
        cur_ti = None
        last_pos = -1
        for i, nd in enumerate(nodes_seq):
            start = bounds[i]
            dur = bounds[i + 1] - bounds[i]
            if dur <= 0:
                continue
            ti = int(g.word_of[nd])
            pos = int(g.pos_of[nd])
            wid = int(g.variant_of[nd])
            ci = self.am.mdef.ciphone_str(int(g.cipid[nd]))
            if ti != cur_ti or pos <= last_pos:
                seg = WordSeg(self.dict.wordstr(wid), start, 0, phones=[])
                seg.wid = wid
                segs.append(seg)
                cur_ti = ti
            seg = segs[-1]
            sc = seg_score(start, start + dur)
            seg.phones.append((ci, start, dur, sc))
            seg.duration = start + dur - seg.start
            seg.score += sc
            last_pos = pos
        return segs

    # -- lattice / nbest (device scoring + host history search) -------------

    def _dense_scores_utt(self, audio: np.ndarray) -> np.ndarray:
        """Dense compallsen senone scores [T, n_sen] int16 for one
        utterance, computed on device, in reference senone order (the
        acmod_score contract the host search consumes)."""
        from .ops.senscore_jax import ungroup

        audio = np.asarray(audio)
        T = self.fe.n_frames(len(audio))
        Tpad = max(64, -(-T // 64) * 64)
        if self.native_fe is not None:
            cep = self.native_fe.process_batch(
                audio[None], np.array([len(audio)]), Tpad)[0]
            cep_d = jnp.asarray(cep)
        else:
            cep_d = self.fe.mfcc(jnp.asarray(audio.astype(np.float32)),
                                 len(audio), Tpad)
        feats = feats_full_utt(cep_d, jnp.int32(T), self.config["cmn"])
        dense = score_frames(self.tables, feats)
        return ungroup(self.tables, np.asarray(dense))[:T]

    def decode_search(self, audio: np.ndarray):
        """Grammar decode with the full HISTORY TABLE: device dense
        scoring (bit-exact compallsen, ops/senscore_jax) feeding the
        reference beam search + history dedup on host
        (search_fsg.FsgSearch) — the GPU-score/CPU-search split that
        yields lattices and n-best without the slow exact scorer.
        Returns the finished FsgSearch (hyp()/seg_iter() available;
        feed to Lattice.from_fsg_search)."""
        from .search_fsg import FsgSearch

        fsg = getattr(self, "_decode_fsg", None)
        if fsg is None:
            raise RuntimeError("call set_grammar() first")
        sen = self._dense_scores_utt(audio)
        search = FsgSearch(fsg, self.config, self.am, self.dict,
                           self.d2p, self.lmath)
        search.start()
        for t in range(len(sen)):
            search.step(sen[t], t)
        search.finish()
        return search

    def lattice(self, audio: np.ndarray):
        """Word DAG for one utterance against the set_grammar() grammar
        (decoder_lattice / fsg_search_lattice, fsg_search.c:1344-1524),
        built from the device-scored history search."""
        from .lattice import Lattice

        return Lattice.from_fsg_search(
            self.decode_search(audio), self.config)

    def nbest(self, audio: np.ndarray, sf: int = 0, ef: int = -1):
        """A* N-best iterator yielding (hyp, score) best-first
        (decoder_nbest semantics) at device scoring speed."""
        from .lattice import AstarSearch

        dag = self.lattice(audio)
        dag.bestpath(self.config.get_float("ascale"))
        astar = AstarSearch(dag, sf, ef)
        while True:
            p = astar.next()
            if p is None:
                return
            yield astar.hyp(p), p.score

    def stream(self, text: str):
        """Streaming alignment with explicit checkpointable state
        (see streaming.AlignStream): push int16 chunks, end() -> segs."""
        from .streaming import AlignStream

        return AlignStream(self, text)

    def align_longform_batch(self, audios: list[np.ndarray],
                             texts: list[str],
                             mesh=None) -> list[list[WordSeg]]:
        """Sequence-parallel alignment for long-form audio: the frame
        axis is sharded over a ('seq',) device mesh, the Viterbi carry
        rides a device ring, and token stacks stay sharded so maximum
        audio length scales with device count (parallel/seqpipe.py).
        Bit-identical to align()/align_batch on the same audio."""
        from .parallel.seqpipe import align_longform, seq_mesh

        if len(set(texts)) != 1:
            raise ValueError("align_longform_batch needs one shared "
                             "transcript (one graph) per call")
        if mesh is None:
            mesh = seq_mesh()
        nseq = mesh.devices.size
        g = self.graph_for_text(texts[0])
        ns = np.array([len(a) for a in audios])
        Ts = np.array([self.fe.n_frames(int(n)) for n in ns])
        N = int(ns.max())
        gran = 64 * nseq
        Tmax = max(gran, -(-int(Ts.max()) // gran) * gran)
        # FE + features + scoring are frame-local: score exactly like
        # the data-parallel path (same wire format, same graph-restricted
        # scorer, so results stay bit-identical with align_batch), then
        # run the ring-carried Viterbi with the frame axis sharded.
        Ts_d = jax.device_put(Ts)
        if self.native_fe is not None and self.wire == "i16p":
            pl = self.native_fe.process_list_i16p(audios, Tmax,
                                                  self.wire_scale)
            sen_g = self._score_chunk_planes(g, jax.device_put(pl), Ts_d,
                                             Tmax)
        else:
            buf = np.zeros((len(audios), N), np.int16)
            for i, a in enumerate(audios):
                buf[i, : len(a)] = a
            if self.native_fe is not None:
                cep = self.native_fe.process_batch(buf, ns, Tmax)
                sen_g = self._score_chunk_cep(g, jax.device_put(cep), Ts_d,
                                              Tmax)
            else:
                sen_g = self._score_chunk_raw(g, jax.device_put(buf),
                                              jax.device_put(ns), Ts_d,
                                              Tmax)
        B = len(audios)
        senscr = np.asarray(sen_g)
        P, E = g.senid.shape
        entry = np.where(g.is_entry, g.entry_pen, WORST_SCORE).astype(np.int32)
        senid = np.arange(P * E, dtype=np.int32).reshape(P, E)
        tp = np.asarray(self.am.tmat.astype(np.int32))[g.tmatid]
        pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst, g.edge_pen,
                                      len(g.senid))
        paths, scores = align_longform(
            mesh, senscr, senid, tp, pi, pp, pk, g.astart, g.aend,
            Ts.astype(np.int32), entry, g.final_nodes)
        paths, scores = np.asarray(paths), np.asarray(scores)
        return [self._extract_safe(g, paths[i], int(Ts[i]), int(scores[i]))
                for i in range(B)]

    def _feats_chunk_raw(self, buf, ns, Ts, Tmax: int):
        """Dynamic features with on-device FE: raw int16 audio [B, N]
        in, features [B, Tmax, F, L] out."""
        def fe_one(audio, n, T):
            cep = self.fe.mfcc(audio.astype(jnp.float32), n, Tmax)
            return feats_full_utt(cep, T, self.config["cmn"])

        # Separately-jitted stages: one fused mega-graph (or a vmapped
        # scorer) sends this environment's AOT compiler into multi-minute
        # compiles; staged dispatch reuses each stage's cached executable
        # and loses nothing at these sizes.
        if not hasattr(self, "_fe_batch_jit"):
            self._fe_batch_jit = {}
        key = (buf.shape, Tmax)
        fe_j = self._fe_batch_jit.get(key)
        if fe_j is None:
            fe_j = self._fe_batch_jit[key] = jax.jit(jax.vmap(fe_one))
        return fe_j(buf, ns, Ts)                        # [B,T,F,L]

    def _score_chunk_raw(self, g: AlignGraph, buf, ns, Ts, Tmax: int):
        """Chunk scoring with on-device FE: raw int16 audio [B, N] in,
        graph-gathered senone scores [B, Tmax, S] int32 out."""
        feats = self._feats_chunk_raw(buf, ns, Ts, Tmax)
        return self._score_graph_batch(g, feats, Tmax)

    def _feats_chunk_cep(self, cep, Ts, Tmax: int):
        """Dynamic features when cepstra came from the host FE: [B,
        Tmax, ncep] float32 in (bit-exact with the device FE; see
        fe/native_fe.py), vmapped feature computation on device."""
        cmn = self.config["cmn"]

        def feat_one(c, T):
            return feats_full_utt(c, T, cmn)

        if not hasattr(self, "_feat_batch_jit"):
            self._feat_batch_jit = {}
        key = (cep.shape, cmn)
        fj = self._feat_batch_jit.get(key)
        if fj is None:
            fj = self._feat_batch_jit[key] = jax.jit(jax.vmap(feat_one))
        return fj(cep, Ts)                              # [B,T,F,L]

    def _score_chunk_cep(self, g: AlignGraph, cep, Ts, Tmax: int):
        feats = self._feats_chunk_cep(cep, Ts, Tmax)
        return self._score_graph_batch(g, feats, Tmax)

    def _feats_chunk_planes(self, pl, Ts, Tmax: int):
        """Dynamic features from wire-quantized byte-plane cepstra (see
        NativeFrontend.process_batch_i16p): pl uint8 [2, B, Tmax, ncep].
        Dequant (hi << 8 | lo) / scale is folded into the feat jit;
        exact for power-of-two scales."""
        cmn = self.config["cmn"]
        inv = np.float32(1.0 / self.wire_scale)

        def feat_one(lo, hi, T):
            v = (hi.astype(jnp.int8).astype(jnp.int32) << 8) \
                | lo.astype(jnp.int32)
            return feats_full_utt(v.astype(jnp.float32) * inv, T, cmn)

        if not hasattr(self, "_featp_batch_jit"):
            self._featp_batch_jit = {}
        key = (pl.shape, cmn)
        fj = self._featp_batch_jit.get(key)
        if fj is None:
            fj = self._featp_batch_jit[key] = jax.jit(jax.vmap(feat_one))
        return fj(pl[0], pl[1], Ts)                     # [B,T,F,L]

    def _score_chunk_planes(self, g: AlignGraph, pl, Ts, Tmax: int):
        feats = self._feats_chunk_planes(pl, Ts, Tmax)
        return self._score_graph_batch(g, feats, Tmax)

    def _graph_consts(self, g: AlignGraph):
        """Device-resident per-graph Viterbi + scoring constants,
        cached (incl. the graph-restricted GraphScorer).  Under a data
        mesh the tables are REPLICATED across devices (SURVEY §2.3:
        model tables replicate, the batch shards)."""
        if not hasattr(self, "_graph_const_cache"):
            self._graph_const_cache = {}
        c = self._graph_const_cache.get(g.serial)
        if c is None:
            rep = self._put_rep
            entry = rep(np.where(g.is_entry, g.entry_pen,
                                 WORST_SCORE).astype(np.int32))
            senid = rep(self.tables.sen_remap[g.senid].astype(np.int32))
            tp = rep(np.asarray(self.am.tmat.astype(np.int32))[g.tmatid])
            pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst,
                                          g.edge_pen, len(g.senid))
            gs = GraphScorer.build(self.am, self.tables, g.senid)
            if self.mesh is not None:
                gs = jax.tree_util.tree_map(
                    lambda x: rep(np.asarray(x)), gs)
            c = dict(entry=entry, senid=senid, tp=tp,
                     pi=rep(pi), pp=rep(pp),
                     pk=rep(pk), ast=rep(g.astart),
                     aen=rep(g.aend),
                     fin=rep(g.final_nodes),
                     gs=gs)
            self._graph_const_cache[g.serial] = c
        return c

    def _score_graph_batch(self, g: AlignGraph, feats, Tmax: int):
        """Graph-restricted senone scoring over the folded [B*T] frame
        axis: distances + top-N only for the graph's codebooks, mixture
        eval only for its S = P*3 states (ops/senscore_jax.GraphScorer).
        Emits [B, Tmax, S] int32 scores directly in graph-state order —
        the old full-inventory score + [n_sen]->[S] gather did ~60x more
        mixture-eval work for identical Viterbi paths."""
        gs = self._graph_consts(g)["gs"]
        B = feats.shape[0]
        flat = feats.reshape((-1,) + feats.shape[2:])
        sen_g = score_frames_graph(gs, flat)                  # [B*T, S]
        return sen_g.reshape(B, Tmax, -1)

    def _vit_full(self, g: AlignGraph, sen_g, Ts):
        """Whole-batch lane-major Viterbi + final-node select + batched
        backtrace.  sen_g [B, T, S] int32 graph-gathered scores.
        Returns (path [B,T], path_score [B,T] or None, final [B]).

        Graph constants are passed as ARGUMENTS, never closed over, so
        one compiled program serves every graph of the same shape and
        the constants stay device-resident between launches."""
        c = self._graph_consts(g)
        if not hasattr(self, "_vit_batch_jit"):
            self._vit_batch_jit = {}
        ws = self.want_scores
        vit_j = self._vit_batch_jit.get(ws)
        if vit_j is None:
            def run(sg, tp, pi, pp, pk, ast, aen, entry, fin, Ts):
                tok_id, tok_sc, out_score, out_hist = align_viterbi_batch(
                    sg, tp, pi, pp, pk, ast, aen, Ts, ws, entry)
                fsc = out_score[:, fin]                    # [B, F]
                best = jnp.argmax(fsc, axis=1)
                final_node = fin[best]                     # [B]
                rows = jnp.arange(sg.shape[0])
                fstate = out_hist[rows, final_node]
                fscore = out_score[rows, final_node]
                path, pscore = backtrace_batch(
                    tok_id, tok_sc if ws else None, fstate, fscore, Ts)
                if sg.shape[-1] < 32767:
                    path = path.astype(jnp.int16)   # halves the d2h bytes
                return path, pscore, fscore

            vit_j = self._vit_batch_jit[ws] = jax.jit(run)
        return vit_j(sen_g, c["tp"], c["pi"], c["pp"], c["pk"], c["ast"],
                     c["aen"], c["entry"], c["fin"], Ts)
