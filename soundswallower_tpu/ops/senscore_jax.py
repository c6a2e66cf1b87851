"""Batched device senone scoring (dense fast path).

Computes int16 senone scores for whole utterances in one jit:

1. Mahalanobis distances for every (frame, codebook, stream, density) via
   the same float32 fold as the C code (det - sum diff^2*var in dim
   order, no contracted multiply-add; see _distances_fold).
2. Per-frame top-N densities by final int32 distance via N iterative
   masked argmax rounds.  This
   intentionally drops two C quirks with negligible effect (measured
   3/35028 top-4 sets on goforward): eval_cb's dynamic-threshold early
   termination (ptm_mgau.c:181-209) and cross-frame seeding.
3. Integer normalization (codebook_norm semantics) and senone evaluation
   (senone_eval semantics) in a *codebook-grouped* senone layout
   [cb, M]: mixture-weight lookups become contiguous-row gathers and the
   8-bit log-add table is evaluated as a sum of threshold comparisons
   (the quantized table is a small non-increasing staircase), so the hot
   path has no scatter/gather at all beyond one row-gather.

Output layout: int16 [T, G] with G = n_cb * M; ``sen_remap[sen]`` maps a
reference senone id to its grouped column.  0 = best per frame
(compallsen convention); ungrouped columns behave like C's unevaluated
senones (score = -bestscore).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..am import AcousticModel
from ..logmath import SENSCR_SHIFT

MAX_NEG_ASCR = 96
MAX_NEG_INT32 = -2147483648



def mm_dtype():
    """Operand type of the one-hot mixture-weight matmuls.

    The one-hot selects a single integer weight <= 255 and the sum is
    taken in f32 (preferred_element_type), so bf16 and f32 are both
    exact.  On the GPU bf16 runs on the tensor cores at their full rate
    with half the bytes (an f32 operand would run as TF32 anyway).
    XLA's CPU backend has no batched bf16 x bf16 -> f32 dot, so the CPU
    keeps f32.  The tables are built in this type, and the one-hot
    follows the table's dtype."""
    return jnp.float32 if jax.default_backend() == "cpu" else jnp.bfloat16


@jax.tree_util.register_dataclass
@dataclass(eq=False)
class ScorerTables:
    """Device-resident model tables (a pytree: arrays are jit inputs,
    never baked into the graph as constants)."""

    means: jnp.ndarray      # f32 [cb, F, D, L]
    var_t: jnp.ndarray      # f32 [cb, F, D, L]
    det: jnp.ndarray        # f32 [cb, F, D]
    mixw_g: jnp.ndarray     # mm_dtype() [F, G, D, M] grouped mixture wts
    valid_g: jnp.ndarray    # bool [G, M] real senone mask
    cb_of: jnp.ndarray      # int32 [G] group -> codebook id
    table_thresh: jnp.ndarray  # int32 [K] log-add staircase thresholds
    sen_remap_dev: jnp.ndarray  # int32 [n_sen] senone id -> grouped column
    sen_remap: np.ndarray = field(metadata=dict(static=False))
    # ms backend only: untransposed mixture weights [S, F, D] int32,
    # the senone->codebook map, and the grouped-column inverse permutation
    mixw_ms: jnp.ndarray | None = None
    sen2cb: jnp.ndarray | None = None
    sen_inv: jnp.ndarray | None = None
    max_topn: int = field(metadata=dict(static=True), default=4)
    n_sen: int = field(metadata=dict(static=True), default=0)
    backend: str = field(metadata=dict(static=True), default="ptm")
    # semi 4-bit quirk: mixw + codeword score truncates to uint8 before
    # the log-add (s2_semi_mgau.c:452-461; see am.mixw_wrap_u8)
    wrap_u8: bool = field(metadata=dict(static=True), default=False)
    zero8: int = field(metadata=dict(static=True), default=0)
    aw: int = field(metadata=dict(static=True), default=1)

    @classmethod
    def from_am(cls, am: AcousticModel) -> "ScorerTables":
        n_sen = am.n_sen
        n_cb = am.n_mgau
        # Decode 4-bit clustered sendumps per the backend's own
        # convention (am.mixw_dense docstring; ptm and semi differ).
        mixw = am.mixw_dense().astype(np.uint8)  # [F, D, n_sen]
        # Group senones by codebook, splitting codebooks with more than
        # M=128 senones into several groups (each group carries its
        # codebook id in cb_of): keeps the grouped score matrix at
        # ~n_sen columns instead of n_cb * max_count, which is a 4x
        # reduction in scorer output bytes and mixture-eval FLOPs for
        # the shipped models.  Column remap: [n_sen] -> grp*M + slot.
        sen2cb = np.asarray(am.sen2cb, dtype=np.int64)
        counts = np.bincount(sen2cb, minlength=n_cb)
        # slots per group: 128 caps the grouped-matrix width for ptm /
        # semi; the ms 1:1 mapping (one senone per codebook) collapses
        # to M=1, which also makes sen_remap the identity
        M = min(128, max(1, int(counts.max())))
        grp_start = np.zeros(n_cb + 1, np.int64)
        grp_start[1:] = np.cumsum(np.maximum(1, -(-counts // M)))
        n_grp = int(grp_start[-1])
        cb_of = np.zeros(n_grp, np.int64)
        for cb in range(n_cb):
            cb_of[grp_start[cb]:grp_start[cb + 1]] = cb
        remap = np.zeros(n_sen, np.int64)
        slot = np.zeros(n_cb, np.int64)
        for s in range(n_sen):
            cb = sen2cb[s]
            grp = grp_start[cb] + slot[cb] // M
            remap[s] = grp * M + slot[cb] % M
            slot[cb] += 1
        F, D = mixw.shape[0], mixw.shape[1]
        mixw_g = np.full((F, n_grp, D, M), 255, np.uint8)
        cbcol = remap // M
        slotcol = remap % M
        mixw_g[:, cbcol, :, slotcol] = np.transpose(mixw, (2, 0, 1))
        valid_g = np.zeros((n_grp, M), bool)
        valid_g[cbcol, slotcol] = True
        # log-add staircase: table[d] = sum_k [d < thresh_k]
        # (the 8-bit table is non-increasing; thresh_k = first d where the
        # value drops below k)
        table = np.asarray(am.lmath_8b.table, dtype=np.int64)
        vmax = int(table[0])
        thresh = np.asarray(
            [int(np.searchsorted(-table, -(k - 0.5))) for k in range(1, vmax + 1)],
            np.int32,
        )
        # verify staircase reconstruction exactly
        d = np.arange(len(table))
        recon = (d[:, None] < thresh[None, :]).sum(1)
        assert (recon == table).all(), "log-add staircase mismatch"
        mixw_ms = None
        cb_dev = None
        inv_dev = None
        if am.backend == "ms":
            # untransposed [S, F, D] weights for the ms kernel
            mixw_ms = jnp.asarray(np.asarray(am.mixw).astype(np.int32))
            cb_dev = jnp.asarray(sen2cb.astype(np.int32))
            # senone-order scores -> grouped-column order (the inverse
            # of sen_remap; pad columns repeat senone 0, harmless: no
            # graph column ever references them)
            inv = np.zeros(n_grp * M, np.int32)
            inv[remap] = np.arange(n_sen, dtype=np.int32)
            inv_dev = jnp.asarray(inv)
        return cls(
            means=jnp.asarray(am.means),
            var_t=jnp.asarray(am.var_t),
            det=jnp.asarray(am.det),
            mixw_g=jnp.asarray(mixw_g, dtype=mm_dtype()),
            valid_g=jnp.asarray(valid_g),
            cb_of=jnp.asarray(cb_of.astype(np.int32)),
            table_thresh=jnp.asarray(thresh),
            sen_remap_dev=jnp.asarray(remap.astype(np.int32)),
            sen_remap=remap,
            mixw_ms=mixw_ms,
            sen2cb=cb_dev,
            sen_inv=inv_dev,
            max_topn=am.max_topn,
            n_sen=n_sen,
            backend=am.backend,
            wrap_u8=am.mixw_wrap_u8,
            zero8=int(am.lmath_8b.zero),
            aw=int(getattr(am, "aw", 1)),
        )

    @property
    def group_shape(self):
        return self.valid_g.shape


def _distances_fold(t: ScorerTables, feats):
    """f32 fold distances: feats [T, F, L] -> [T, cb, F, D] float32.

    One dimension at a time so no [T,cb,F,D,L] tensor ever materializes
    (with batching that would be tens of GB); XLA fuses the unrolled
    per-dim updates into one elementwise kernel.

    C rounding needs the product rounded before the subtract.  XLA's GPU
    backend contracts ``d - p`` into a fused multiply-add (no XLA flag
    turns that off), which moved ~2% of the int32 distances by 1-2
    units against the CPU.  The select on ``p == p`` (always true: p is
    never NaN here) sits between the multiply and the subtract, so no
    fused multiply-add can form, at no measured cost; chip_smoke.py
    phase 8(b) checks that the GPU's distances equal the CPU's."""
    L = t.means.shape[-1]
    T = feats.shape[0]
    shape = (T,) + t.det.shape
    d = jnp.broadcast_to(t.det[None], shape).astype(jnp.float32)
    for i in range(L):
        diff = feats[:, None, :, None, i] - t.means[None, :, :, :, i]
        p = (diff * diff) * t.var_t[None, :, :, :, i]
        d = d - jnp.where(p == p, p, jnp.float32(0))
    return d


def _int_dist(d):
    out = d.astype(jnp.int32)  # f32->s32 rounds toward zero (XLA convert)
    return jnp.where(d < jnp.float32(MAX_NEG_INT32),
                     jnp.int32(MAX_NEG_INT32), out)


def _topn_argmax(di, n):
    """Top-n scores+indices over the last axis (first-max-wins
    tie-breaking, same as lax.top_k's lowest-index tie rule and the C
    argmax loops).

    Implemented as n iterative masked argmax rounds (a few fused
    reductions over the last axis) rather than lax.top_k."""
    D = di.shape[-1]
    lane = jnp.arange(D, dtype=jnp.int32)
    taken = jnp.zeros(di.shape, bool)
    scs, cws = [], []
    for _ in range(n):
        cand = jnp.where(taken, jnp.int32(MAX_NEG_INT32), di)
        m = jnp.max(cand, axis=-1, keepdims=True)
        # lowest untaken lane at the max — distinct indices even when
        # values tie at the MAX_NEG_INT32 clamp (like top_k's ranking)
        sel = (cand == m) & ~taken
        idx = jnp.min(jnp.where(sel, lane, jnp.int32(D)),
                      axis=-1, keepdims=True)
        scs.append(m)
        cws.append(idx)
        taken = taken | (lane == idx)
    return jnp.concatenate(scs, -1), jnp.concatenate(cws, -1)


def _fast_logadd(x, y, thresh):
    """fast_logmath_add via the staircase: r - sum_k [|x-y| < thresh_k]."""
    d = jnp.abs(x - y)
    r = jnp.minimum(x, y)
    add = jnp.zeros_like(r)
    for k in range(thresh.shape[0]):
        add = add + (d < thresh[k]).astype(r.dtype)
    return r - add


@jax.jit
def _dist_stage(tables: ScorerTables, feats):
    """feats [T, F, L] float32 -> int32 distances [T, cb, F, D]."""
    return _int_dist(_distances_fold(tables, feats))


@jax.jit
def _topn_stage(tables: ScorerTables, di):
    return _topn_argmax(di, tables.max_topn)


def _codebook_norm(topn_scores, row_cbs=None):
    """codebook_norm (ptm_mgau.c:264-295): shifted top-N scores
    [T, C, F, N] -> per-codebook scores relative to the frame's best
    top-1 codebook, clamped at MAX_NEG_ASCR.

    row_cbs (optional bool [R, C]): the frames are R equal rows (a
    batch's utterances, flattened) and the best is taken only over the
    codebooks of each row's own graph, exactly as a scorer restricted
    to that graph alone would.  The clamp makes the norm's codebook set
    matter, so without this a row's scores would depend on which other
    utterances share its batch."""
    shifted = topn_scores >> SENSCR_SHIFT
    top1 = shifted[..., 0]                                 # [T, C, F]
    if row_cbs is not None:
        per_row = top1.shape[0] // row_cbs.shape[0]
        mask = jnp.repeat(row_cbs, per_row, axis=0)[..., None]
        top1 = jnp.where(mask, top1, jnp.iinfo(jnp.int32).min)
    norm = jnp.max(top1, axis=1, keepdims=True)            # [T, 1, F]
    return jnp.minimum(-(shifted - norm[..., None]), MAX_NEG_ASCR)


def _sen_eval(tables: ScorerTables, topn_scores, topn_cw, row_cbs=None):
    """Top-N codeword scores/ids [T,cb,F,N] -> grouped scores int16 [T,G]
    (plain function; _sen_stage is its jitted form).  row_cbs: see
    _codebook_norm (bool [R, n_cb])."""
    t = tables
    s = _codebook_norm(topn_scores, row_cbs)               # [T,cb,F,N]

    # senone_eval in grouped layout.  Per-group top-N codewords/scores
    # come from the group's codebook (cb_of gather, 42 -> G groups).
    # The mixture-weight lookup mw[t,g,m] = mixw[f, cw[t,g,f,j], m] is
    # computed as a one-hot batched matmul (contraction over the 128
    # densities), exact in the table's dtype (see mm_dtype).
    cw_g = topn_cw[:, t.cb_of]                             # [T,G,F,N]
    s_g = s[:, t.cb_of]                                    # [T,G,F,N]
    F = t.mixw_g.shape[0]
    mixw = t.mixw_g                                        # [F,G,D,M]
    D = mixw.shape[2]
    ascore = None
    for f in range(F):
        fden = None
        for j in range(t.max_topn):
            oh = jax.nn.one_hot(cw_g[:, :, f, j], D, dtype=mixw.dtype)
            mw = jnp.einsum("tgd,gdm->tgm", oh, mixw[f],
                            preferred_element_type=jnp.float32)
            mw = mw.astype(jnp.int32)                      # [T,G,M]
            term = mw + s_g[:, :, f, j][..., None]         # [T,G,M]
            if t.wrap_u8:
                term = term & 0xFF
            if fden is None:
                fden = term
            else:
                fden = _fast_logadd(fden, term, t.table_thresh)
        ascore = fden if ascore is None else ascore + fden
    # bestscore over real senones; pad columns mimic C's unevaluated
    # senones (memset 0 then -= best)
    out = jnp.where(t.valid_g[None], ascore, 0).astype(jnp.int16)
    if t.backend != "semi":
        # ptm subtracts the best evaluated score (ptm_mgau.c:397-400);
        # the semi-continuous scorer does not (s2_semi_mgau.c:826-875)
        big = jnp.int32(1 << 30)
        best = jnp.min(jnp.where(t.valid_g[None], ascore, big), axis=(1, 2))
        out = out - best[:, None, None].astype(jnp.int16)
    T = out.shape[0]
    return out.reshape(T, -1)


_sen_stage = jax.jit(_sen_eval)


@jax.jit
def _dist_stage_ms(tables: ScorerTables, feats):
    """feats [T, F, L] -> FLOAT distances [T, cb, F, D] (the ms top-N
    ranks by float, ms_gauden.c compute_dist)."""
    return _distances_fold(tables, feats)


@jax.jit
def _ms_stage(tables: ScorerTables, di_f):
    """Float distances [T, C, F, D] -> int16 senone scores [T, S] with
    exact ms semantics (ms_gauden.c compute_dist top-N incl. its
    insertion tie rule and WORST_DIST floor; ms_senone.c senone_eval's
    rounded-up SENSCR_SHIFT, full logmath_add on the 8-bit shifted
    table, acoustic-weight truncation; ms_mgau.c's int16-clamped
    best-subtraction).  Bit-exact vs ops/senscore.MsScorerNp /
    the C oracle (tests/test_senscore.py)."""
    t = tables
    T, C, F, D = di_f.shape
    N = min(t.max_topn, D) if t.max_topn > 0 else D
    WD = jnp.float32(MAX_NEG_INT32)
    i64 = jnp.int64
    if N >= D:
        # compute_dist_all: densities in INDEX order, unsorted
        cw = jnp.broadcast_to(jnp.arange(D, dtype=jnp.int32), di_f.shape)
        dval = di_f
    else:
        # top-N by float distance; the C's insertion puts an EQUAL
        # newcomer above the incumbent (ms_gauden.c:385-433), i.e.
        # ties break toward the LATER density: pack the
        # order-preserving integer view of the f32 with the density
        # index.  (The per-dim early-termination checks are lossless:
        # the fold is monotonically non-increasing in float, so a
        # candidate failing a checkpoint fails the final test too.)
        u = jax.lax.bitcast_convert_type(di_f, jnp.int32).astype(i64)
        ub = u & i64(0xFFFFFFFF)
        key = jnp.where(u < 0, (~ub) & i64(0xFFFFFFFF),
                        ub | i64(0x80000000))
        key = key * D + jnp.arange(D, dtype=i64)
        key = jnp.where(di_f < WD, i64(-1), key)  # WORST_DIST floor
        topk, idx = jax.lax.top_k(key, N)
        cw = idx.astype(jnp.int32)
        dval = jnp.take_along_axis(di_f, idx, axis=-1)
        bad = topk < 0
        dval = jnp.where(bad, WD, dval)
        cw = jnp.where(bad, 0, cw)
    # fden: rounded-up shift of the int-cast distance (senone_eval)
    di = dval.astype(i64)
    fden = jnp.where(dval < WD, i64(MAX_NEG_INT32 >> SENSCR_SHIFT),
                     (di + ((1 << SENSCR_SHIFT) - 1)) >> SENSCR_SHIFT)
    S = t.sen2cb.shape[0]
    fden_s = fden[:, t.sen2cb]                      # [T, S, F, N]
    cw_s = cw[:, t.sen2cb]
    sidx = jnp.arange(S)[None, :, None, None]
    fidx = jnp.arange(F)[None, None, :, None]
    mw = t.mixw_ms[sidx, fidx, cw_s].astype(i64)    # [T, S, F, N]
    fwscr = fden_s - mw
    zero = i64(t.zero8)
    fscr = fwscr[..., 0]
    for j in range(1, N):
        x, y = fscr, fwscr[..., j]
        r = jnp.maximum(x, y)
        d_ = r - jnp.minimum(x, y)
        add = jnp.zeros_like(r)
        for k in range(t.table_thresh.shape[0]):
            add = add + (d_ < t.table_thresh[k]).astype(r.dtype)
        res = r + add
        res = jnp.where(x <= zero, y, res)
        res = jnp.where(y <= zero, jnp.where(x <= zero, res, x), res)
        fscr = res
    scr = -jnp.sum(fscr, axis=2)                    # [T, S]
    if t.aw != 1:
        scr = jnp.sign(scr) * (jnp.abs(scr) // t.aw)
    scr = jnp.clip(scr, -32768, 32767)
    best = jnp.min(scr, axis=1, keepdims=True)
    return jnp.clip(scr - best, -32768, 32767).astype(jnp.int16)


def score_frames(tables: ScorerTables, feats, row_cbs=None):
    """feats [T, F, L] float32 -> grouped senone scores int16 [T, G].

    Without row_cbs these are compallsen scores (0 = best per frame).
    With row_cbs (bool [R, n_cb], see _codebook_norm) each row is
    normalized over its own graph's codebooks; ms models ignore it (no
    cross-codebook norm).

    Three separately dispatched jits (distances, top-N, senone eval)
    that materialize the distance tensor between stages; dispatches are
    async, so staging costs only host-side microseconds.
    """
    if tables.backend == "ms":
        # fully-continuous path: float top-N + ms_senone semantics,
        # permuted from senone order into the grouped-column layout
        # (identity for the 1:1 mapping)
        return _ms_stage(tables, _dist_stage_ms(tables, feats)
                         )[:, tables.sen_inv]
    di = _dist_stage(tables, feats)
    topn_scores, topn_cw = _topn_stage(tables, di)
    return _sen_stage(tables, topn_scores, topn_cw, row_cbs)


def ungroup(tables: ScorerTables, grouped: np.ndarray) -> np.ndarray:
    """[..., G] grouped scores -> [..., n_sen] reference senone order."""
    return np.asarray(grouped)[..., tables.sen_remap]


# ---------------------------------------------------------------------------
# Graph-restricted scoring (the alignment/decode fast path)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(eq=False)
class GraphScorer:
    """Scoring restricted to the codebooks and senones a decode graph
    actually uses.

    An alignment chain touches ~1/3 of the codebooks and ~1/60 of the
    senone columns of the en-us model, so scoring the full inventory and
    then gathering [n_sen] -> [S] throws away almost all the work.  This
    scorer evaluates distances + top-N only for the used codebooks and
    the mixture sum only for the S = P*3 graph states, emitting senone
    scores already in graph-state order.

    Normalization: per-frame norms (codebook_norm's cross-codebook max,
    ptm's best-senone subtraction) are taken over the RESTRICTED sets.
    A per-frame norm shifts every state's score equally and cancels in
    the Viterbi argmax -- exactly, except where the MAX_NEG_ASCR clamp
    saturates: the restricted norm is <= the full norm, so fewer
    codeword terms hit the 96-cap (strictly LESS saturation than
    compallsen, and the same situation as the C reference's active-set
    scoring, whose norm runs over the active subset --
    ptm_mgau.c:264-295 normalizes whatever was evaluated that frame).
    The residual deviations touch only senones whose top-N codewords
    are already >= 96<<SENSCR_SHIFT below the frame best;
    tests/test_senscore.py asserts they are bounded and that Viterbi
    paths match the full scorer exactly on the reference data.
    """

    means: jnp.ndarray       # f32 [Cu, F, D, L] used-codebook rows
    var_t: jnp.ndarray       # f32 [Cu, F, D, L]
    det: jnp.ndarray         # f32 [Cu, F, D]
    wsel: jnp.ndarray        # mm_dtype() [F, Cu*D, S] mixture columns
    cb_pos: jnp.ndarray      # int32 [S] graph state -> used-codebook row
    table_thresh: jnp.ndarray  # int32 [K] log-add staircase
    max_topn: int = field(metadata=dict(static=True), default=4)
    wrap_u8: bool = field(metadata=dict(static=True), default=False)

    @classmethod
    def build(cls, am: AcousticModel, tables: ScorerTables,
              senid_flat: np.ndarray) -> "GraphScorer":
        """senid_flat [S]: reference senone id per graph state."""
        if am.backend == "ms":
            # ms senone eval (rounded shifts, full logmath_add, aw)
            # does not share the ptm/semi grouped pipeline; the aligner
            # routes ms models through the dense score_frames path
            raise NotImplementedError(
                "graph-restricted scoring is ptm/semi only; ms models "
                "use dense score_frames (aligner mixed path)")
        senid_flat = np.asarray(senid_flat, np.int64).reshape(-1)
        S = len(senid_flat)
        sen2cb = np.asarray(am.sen2cb, np.int64)
        used_cb = np.unique(sen2cb[senid_flat])
        # NOTE: the used-codebook count Cu is NOT bucketed — every
        # distinct Cu compiles its own distance/top-N shapes.  Serving
        # workloads with many transcripts ride the multi-graph path
        # (aligner._batch_begin_mixed), whose compiled shapes are
        # transcript-independent.
        n_cb_total = int(sen2cb.max()) + 1
        cb_row = np.full(n_cb_total, -1, np.int64)
        cb_row[used_cb] = np.arange(len(used_cb))
        cb_pos = cb_row[sen2cb[senid_flat]].astype(np.int32)
        # mixture weights for the graph senones (4-bit clustered
        # sendumps decode per the backend's convention — see
        # am.mixw_dense; same decode as ScorerTables.from_am)
        mixw_s = am.mixw_dense(senid_flat).astype(np.int64)  # [F, D, S]
        F, D = mixw_s.shape[0], mixw_s.shape[1]
        Cu = len(used_cb)
        # wsel[f, c*D+d, s] = mixw_s[f, d, s] iff graph state s uses
        # codebook row c: one [T, Cu*D] one-hot matmul then yields the
        # per-state mixture weight mw[t, s] (exact; see mm_dtype).
        wsel = np.zeros((F, Cu * D, S), np.float32)
        rows = cb_pos[None, :] * D + np.arange(D)[:, None]   # [D, S]
        wsel[:, rows, np.arange(S)[None, :]] = mixw_s
        return cls(
            means=jnp.asarray(np.asarray(am.means)[used_cb]),
            var_t=jnp.asarray(np.asarray(am.var_t)[used_cb]),
            det=jnp.asarray(np.asarray(am.det)[used_cb]),
            wsel=jnp.asarray(wsel, dtype=mm_dtype()),
            cb_pos=jnp.asarray(cb_pos),
            table_thresh=tables.table_thresh,
            max_topn=tables.max_topn,
            wrap_u8=am.mixw_wrap_u8,
        )


@jax.jit
def _dist_stage_graph(gs: GraphScorer, feats):
    """feats [T, F, L] -> int32 distances [T, Cu, F, D] over used
    codebooks (the same fold as _dist_stage on the full table)."""
    return _int_dist(_distances_fold(gs, feats))


@jax.jit
def _topn_sen_stage_graph(gs: GraphScorer, di, row_cbs=None):
    """int32 distances [T, Cu, F, D] -> graph-state senone scores
    int32 [T, S] (top-N + codebook_norm + senone_eval, restricted).
    row_cbs: see _codebook_norm (bool [R, Cu])."""
    topn_scores, topn_cw = _topn_argmax(di, gs.max_topn)
    s = _codebook_norm(topn_scores, row_cbs)
    T, Cu, F, N = s.shape
    D = di.shape[-1]
    mm_dtype = gs.wsel.dtype
    ascore = None
    for f in range(F):
        fden = None
        for j in range(N):
            oh = jax.nn.one_hot(topn_cw[:, :, f, j], D, dtype=mm_dtype)
            mw = jnp.dot(oh.reshape(T, Cu * D), gs.wsel[f],
                         preferred_element_type=jnp.float32)
            mw = mw.astype(jnp.int32)                     # [T, S]
            term = mw + s[:, :, f, j][:, gs.cb_pos]       # [T, S]
            if gs.wrap_u8:
                term = term & 0xFF
            if fden is None:
                fden = term
            else:
                fden = _fast_logadd(fden, term, gs.table_thresh)
        ascore = fden if ascore is None else ascore + fden
    return ascore


def score_frames_graph(gs: GraphScorer, feats, row_cbs=None):
    """feats [T, F, L] float32 -> int32 graph-state scores [T, S].

    row_cbs (bool [R, Cu], see _codebook_norm): per-row normalization
    for a scorer shared by R rows of different graphs (the mixed-batch
    union scorer).

    Same two-dispatch staging rationale as score_frames.  Scores are
    NOT shifted to 0=best per frame: the per-frame best is a constant
    shift that cancels in the Viterbi argmax, and skipping it avoids
    a full [T, S] reduction.  Magnitudes stay small (<= F * ~1120), so
    the scan's renormalization (state_align_search.c:193-197 rule)
    triggers no more than once per ~1000 frames.
    """
    di = _dist_stage_graph(gs, feats)
    return _topn_sen_stage_graph(gs, di, row_cbs)
