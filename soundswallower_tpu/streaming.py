"""Streaming forced alignment on the device fast path.

The reference streams by mutating C buffers in place (fe overflow
samples, circular cep buffer, live CMN — SURVEY.md §5 "long-context").
The equivalent here is an EXPLICIT state object: every
`push(chunk)` consumes int16 samples and advances

  * FE state: pre-emphasis prior sample + unconsumed raw tail +
    noise-removal carry (fe_interface.c:393-575 semantics via
    Frontend.mfcc_chunk),
  * live CMN (cmn_live.c semantics, carried across the whole stream and
    across checkpoints, exactly like decoder_get_cmn/set_cmn),
  * the dynamic-feature window (last 2*FEAT_DCEP_WIN+2 cep rows),
  * the Viterbi carry (per-state scores + backpointer heads — the same
    step function as the offline aligner, ops/align_jax.make_vit_step),

and appends the chunk's backpointer tokens.  `state()` serializes all
of it as plain numpy — that pytree IS the checkpoint: a new
`AlignStream.restore()` on another process/host continues the stream
bit-identically (the reference's analogous state is the CMN repr string
plus its internal buffers; see decoder.c:488-516).

Token stacks grow with audio length on the host (int16 [T, S]); device
memory stays constant.  `result()` backtraces whatever has been fed so
far (partial results while streaming, final after `end()`).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .fe.cmn_live import CmnLive
from .fe.feat import FEAT_DCEP_WIN
from .ops.align_jax import WORST_SCORE, make_vit_step, vit_carry0
from .ops.senscore_jax import score_frames_graph

_W = FEAT_DCEP_WIN + 1  # 1s_c_d_dd window (3)


class AlignStream:
    """Streaming aligner for one utterance; create via
    TpuAligner.stream(text)."""

    CHUNK = 128  # frame bucket per Viterbi dispatch (compile-cache key)

    def __init__(self, aligner, text: str, _restore: dict | None = None):
        self.al = aligner
        self.text = text
        g = aligner.graph_for_text(text)
        self.g = g
        self._S = len(g.senid) * g.senid.shape[1]
        fe = aligner.fe
        self.shift, self.size = fe.frame_shift, fe.frame_size
        if _restore is None:
            self._prior = np.float32(0.0)
            self._raw = np.zeros(0, np.int16)
            self._noise = fe.noise_init()
            self._cmn = CmnLive(fe.num_cepstra,
                                aligner.config["cmninit"])
            self._cepq: list[np.ndarray] = []
            self._cep_base = 0
            self._pend = np.zeros((0, 0), np.int16)
            self._head_done = False
            self._nfeat = 0          # feature frames fully computed
            self._carry = vit_carry0(
                len(g.senid),
                jnp.asarray(np.where(g.is_entry, g.entry_pen,
                                     WORST_SCORE).astype(np.int32)))
            self._toks: list[np.ndarray] = []
            self._t = 0              # frames consumed by Viterbi
            self._ended = False
        else:
            self._load(_restore)

    # -- the jitted chunk step (cached per graph on the aligner) ------------

    def _vit_chunk(self, senscr_pad, t0, nvalid):
        al, g = self.al, self.g
        key = ("stream", id(g), self.CHUNK)
        if not hasattr(al, "_stream_jit"):
            al._stream_jit = {}
        fn = al._stream_jit.get(key)
        if fn is None:
            from .ops.align_jax import build_pred_table

            pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst,
                                          g.edge_pen, len(g.senid))
            consts = [jnp.asarray(x) for x in
                      (pi, pp, pk, g.astart, g.aend)]
            P = len(g.senid)
            E = self.g.senid.shape[1]
            senid = jnp.arange(P * E, dtype=jnp.int32).reshape(P, E)
            tp = al.tmat_i32[jnp.asarray(g.tmatid)]
            C = self.CHUNK

            def step_chunk(carry, sen, t0, nfr):
                st = make_vit_step(senid, tp, *consts, nfr, False,
                                   jnp.int16)
                ts = t0 + jnp.arange(C, dtype=jnp.int32)
                sen_g = sen.astype(jnp.int32)[:, senid]
                return jax.lax.scan(st, carry, (ts, sen_g), unroll=2)

            fn = al._stream_jit[key] = jax.jit(step_chunk)
        carry, (tok, _) = fn(self._carry, senscr_pad, jnp.int32(t0),
                             jnp.int32(t0 + nvalid))
        return carry, tok

    # -- feeding -------------------------------------------------------------

    def push(self, chunk: np.ndarray) -> int:
        """Feed int16 samples; returns new feature frames produced."""
        assert not self._ended, "stream already ended"
        chunk = np.asarray(chunk)
        if chunk.dtype != np.int16:
            raise TypeError("push expects int16 samples")
        self._raw = np.concatenate([self._raw, chunk])
        n = len(self._raw)
        nfr = 1 + (n - self.size) // self.shift if n >= self.size else 0
        if nfr > 0:
            self._fe_frames(nfr, tail=False)
        return self._advance()

    def _fe_frames(self, count: int, tail: bool):
        """Run the device FE on `count` frames from the raw buffer, then
        drop consumed samples (constant-memory streaming)."""
        fe = self.al.fe
        seg = self._raw if tail else \
            self._raw[: (count - 1) * self.shift + self.size]
        Tpad = max(32, -(-count // 32) * 32)
        # bucket the sample axis too: every distinct signal length is a
        # fresh jit shape (seconds of compile)
        n = len(seg)
        Npad = max(2048, -(-n // 2048) * 2048)
        segp = np.zeros(Npad, np.float32)
        segp[:n] = seg
        cep, self._noise = fe.mfcc_chunk(
            jnp.asarray(segp), n, Tpad,
            jnp.float32(self._prior), self._noise, jnp.int32(count))
        cep = np.asarray(cep[:count])
        consumed = count * self.shift
        if consumed > 0 and len(self._raw) >= consumed:
            self._prior = np.float32(self._raw[consumed - 1])
            self._raw = self._raw[consumed:]
        norm = self._cmn.process(cep)
        if not self._head_done and len(norm) > 0:
            for _ in range(_W):
                self._cepq.append(norm[0].copy())
            self._head_done = True
        for row in norm:
            self._cepq.append(row)

    def _advance(self) -> int:
        """Compute ready dynamic features + run Viterbi chunks.

        Row k of the cep queue holds cep frame (base + k); frame i's
        window is rows (i - base) .. (i - base + 2W).  Consumed rows are
        dropped, so queue memory is constant in stream length."""
        base = self._cep_base
        navail = base + len(self._cepq) - 2 * _W
        nnew = navail - self._nfeat
        if nnew <= 0:
            return 0
        q = np.stack(self._cepq)
        lo = self._nfeat - base                   # first window start row
        c = q[lo + _W: lo + _W + nnew]
        d = (q[lo + _W + 2: lo + _W + 2 + nnew]
             - q[lo + _W - 2: lo + _W - 2 + nnew]).astype(np.float32)
        d1 = (q[lo + _W + 3: lo + _W + 3 + nnew]
              - q[lo + _W - 1: lo + _W - 1 + nnew]).astype(np.float32)
        d2 = (q[lo + _W + 1: lo + _W + 1 + nnew]
              - q[lo + _W - 3: lo + _W - 3 + nnew]).astype(np.float32)
        feats = np.stack([c, d, (d1 - d2).astype(np.float32)], axis=1)
        self._nfeat = navail
        # drop rows no longer needed (frame navail's window starts at
        # queue row navail - base)
        drop = navail - base
        if drop > 0:
            self._cepq = self._cepq[drop:]
            self._cep_base = navail
        # score in 32-frame shape buckets (bounded set of jit shapes for
        # arbitrary push sizes)
        Tb = -(-nnew // 32) * 32
        fpad = np.zeros((Tb,) + feats.shape[1:], np.float32)
        fpad[:nnew] = feats
        # graph-restricted scorer: same scores as the batch fast path
        # (senone columns already in graph-state order; values fit i16)
        gs = self.al._graph_consts(self.g)["gs"]
        senscr = np.asarray(score_frames_graph(
            gs, jnp.asarray(fpad))).astype(np.int16)[:nnew]
        self._pend = np.concatenate([self._pend, senscr]) \
            if len(self._pend) else senscr
        # dispatch Viterbi only in FULL buckets; the remainder waits in
        # the pending buffer (flushed with padding at end())
        while len(self._pend) >= self.CHUNK:
            self._dispatch(self._pend[:self.CHUNK], self.CHUNK)
            self._pend = self._pend[self.CHUNK:]
        return nnew

    def _dispatch(self, sen: np.ndarray, nvalid: int):
        pad = np.zeros((self.CHUNK, sen.shape[1]), np.int16)
        pad[:len(sen)] = sen
        self._carry, tok = self._vit_chunk(jnp.asarray(pad),
                                           self._t, nvalid)
        self._toks.append(np.asarray(tok[:nvalid]))
        self._t += nvalid

    def end(self) -> list:
        """Flush the FE tail, final feature replication, final Viterbi
        frames; returns the final word segments."""
        if not self._ended:
            if len(self._raw) > 0:
                self._fe_frames(1, tail=True)
            if self._cepq:
                last = self._cepq[-1]
                for _ in range(_W):
                    self._cepq.append(last.copy())
            self._advance()
            if len(self._pend):
                self._dispatch(self._pend, len(self._pend))
                self._pend = np.zeros((0, 0), np.int16)
            self._cmn.update()  # fold pending sum (acmod_end_utt)
            self._ended = True
        return self.result()

    # -- results -------------------------------------------------------------

    def result(self) -> list:
        """Backtrace over everything fed so far (partial while
        streaming; exact-final after end())."""
        if self._t == 0:
            return []
        out_score = np.asarray(self._carry[2])
        out_hist = np.asarray(self._carry[3])
        fin = self.g.final_nodes
        best = int(fin[np.argmax(out_score[fin])])
        final_state, final_score = int(out_hist[best]), int(out_score[best])
        if final_state < 0:
            raise RuntimeError("Alignment failed to reach final state")
        toks = np.concatenate(self._toks)
        T = self._t
        path = np.empty(T, np.int32)
        # reference walk (state_align_search_finish): token at frame t-1
        # points to the state covering frame t-1
        cur = final_state
        for t in range(T - 1, -1, -1):
            path[t] = cur
            if t >= 1:
                cur = int(toks[t - 1, cur])
        return self.al._extract(self.g, path, T, final_score)

    # -- checkpoint / resume ---------------------------------------------------

    def state(self) -> dict:
        """Serialize the full stream state as plain numpy (the
        checkpoint; see module docstring)."""
        return dict(
            text=self.text,
            prior=np.float32(self._prior),
            raw=self._raw.copy(),
            noise=jax.tree_util.tree_map(np.asarray, self._noise),
            # exact CmnLive state (the repr string only carries the
            # mean; sum/nframe are needed for bit-exact resume)
            cmn_mean=self._cmn.mean.copy(), cmn_sum=self._cmn.sum.copy(),
            cmn_nframe=self._cmn.nframe,
            cepq=np.stack(self._cepq) if self._cepq else
                 np.zeros((0, self.al.fe.num_cepstra), np.float32),
            cep_base=self._cep_base,
            pend=self._pend.copy(),
            head_done=self._head_done, nfeat=self._nfeat,
            carry=jax.tree_util.tree_map(np.asarray, self._carry),
            toks=(np.concatenate(self._toks) if self._toks else
                  np.zeros((0, self._S), np.int16)),
            t=self._t, ended=self._ended,
        )

    @classmethod
    def restore(cls, aligner, state: dict) -> "AlignStream":
        return cls(aligner, state["text"], _restore=state)

    def _load(self, s: dict):
        fe = self.al.fe
        self._prior = np.float32(s["prior"])
        self._raw = np.asarray(s["raw"], np.int16)
        self._noise = jax.tree_util.tree_map(jnp.asarray, s["noise"])
        self._cmn = CmnLive(fe.num_cepstra)
        self._cmn.mean = np.asarray(s["cmn_mean"], np.float32).copy()
        self._cmn.sum = np.asarray(s["cmn_sum"], np.float32).copy()
        self._cmn.nframe = int(s["cmn_nframe"])
        self._cepq = [r for r in np.asarray(s["cepq"])]
        self._cep_base = int(s["cep_base"])
        self._pend = np.asarray(s["pend"], np.int16)
        self._head_done = bool(s["head_done"])
        self._nfeat = int(s["nfeat"])
        self._carry = jax.tree_util.tree_map(jnp.asarray, s["carry"])
        self._toks = [np.asarray(s["toks"], np.int16)] if len(s["toks"]) \
            else []
        self._t = int(s["t"])
        self._ended = bool(s["ended"])
