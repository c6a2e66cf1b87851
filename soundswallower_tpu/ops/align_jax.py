"""Device forced-alignment Viterbi over a phone graph.

The reference aligns in two passes: an FSG beam search over a linear word
chain with silence self-loops (fsg_search.c), then a constrained
state-level Viterbi over the resulting word windows
(state_align_search.c).  On the device we recast this as ONE masked
Viterbi DP over a *phone graph* built on the host (see graph builder in
ops/align_graph.py): the word chain with optional silence phones between
words, boundary-phone triphone variants for both context paths, and
word/silence entry penalties mirroring the pass-1 FSG costs
(wip/pip/silprob under the language weight).

Single-pass global Viterbi over this graph finds the same optimum the
two-pass heuristic converges to (pass-1 windows only constrain pass-2;
empirically boundaries match bit-for-bit on the reference test set - see
tests/test_align_tpu.py), in one fused jitted scan that runs entirely on
device:

* per-frame HMM update: vectorized hmm_vit_eval_3st over all phones
  (exact int32 semantics of hmm.c:482-567, incl. WORST_SCORE clamps and
  skip-transition handling)
* cross-phone transitions via 2-predecessor gathers
* score renormalization like state_align_search.c:193-197
* token stack emitted per frame; backtrace as a reverse scan on device

Shapes: P phones, 3 emitting states, T frames.  Batching over utterances
is a vmap over the leading axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

WORST_SCORE = -0x20000000
TMAT_WORST = -255
NEG_INF = jnp.int32(-2147483648)


# Scan unroll factors of the batched Viterbi and backtrace on an
# accelerator (chip_smoke.py times them against 1 on the card).
VITERBI_UNROLL = 4
BACKTRACE_UNROLL = 8


def _scan_unroll(n: int) -> int:
    """Scan unroll factor: n on an accelerator, 1 on the CPU backend,
    where XLA's compile time scales with the unrolled body (a cold
    8-virtual-device CPU compile of the batched Viterbi took minutes at
    unroll=4, with no runtime gain there)."""
    return n if jax.default_backend() != "cpu" else 1


def _eval_3st(score, hist, out_score, out_hist, senscr, tp, active):
    """Vectorized hmm_vit_eval_3st_lr over phones.

    score [P,3] int32 (in,s1,s2), hist [P,3], out_score [P], out_hist [P],
    senscr [P,3] int32 (non-negative senone scores), tp [P,3,4] int32
    (quantized negated probs), active [P] bool.
    Returns updated (score, hist, out_score, out_hist, best_per_phone).
    """
    i32 = jnp.int32

    def tprob(i, j):
        return -tp[:, i, j]

    s0 = score[:, 0] + -senscr[:, 0]
    s1 = score[:, 1] + -senscr[:, 1]
    s2 = score[:, 2] + -senscr[:, 2]

    worst = i32(WORST_SCORE)
    best = jnp.full_like(s0, worst)

    # --- state 3 (out, non-emitting) ---
    # C quirk: t2 initialized once to INT_MIN and reused by the state-2
    # block when the 0->2 skip is absent (hmm.c:497,552).
    t2_init = NEG_INF
    t1 = s2 + tprob(2, 3)
    skip13 = tprob(1, 3) > TMAT_WORST
    t2 = jnp.where(skip13, s1 + tprob(1, 3), t2_init)
    s3 = jnp.where(t1 > t2, t1, t2)
    new_out_hist = jnp.where(t1 > t2, hist[:, 2], hist[:, 1])
    s3 = jnp.maximum(s3, worst)
    do3 = active & (s1 > worst)
    out_score = jnp.where(do3, s3, out_score)
    out_hist = jnp.where(do3, new_out_hist, out_hist)
    best = jnp.where(do3, s3, best)
    t2_carry = jnp.where(skip13, s1 + tprob(1, 3), t2_init)

    # --- state 2 ---
    t0 = s2 + tprob(2, 2)
    t1 = s1 + tprob(1, 2)
    skip02 = tprob(0, 2) > TMAT_WORST
    t2 = jnp.where(skip02, s0 + tprob(0, 2), t2_carry)
    # if t0 > t1: (t2 > t0 ? from0 : stay2) else (t2 > t1 ? from0 : from1)
    branch_a = t0 > t1
    use_t2 = jnp.where(branch_a, t2 > t0, t2 > t1)
    ns2 = jnp.where(use_t2, t2, jnp.where(branch_a, t0, t1))
    nh2 = jnp.where(use_t2, hist[:, 0],
                    jnp.where(branch_a, hist[:, 2], hist[:, 1]))
    ns2 = jnp.maximum(ns2, worst)
    best = jnp.maximum(best, jnp.where(active, ns2, worst))

    # --- state 1 ---
    t0 = s1 + tprob(1, 1)
    t1 = s0 + tprob(0, 1)
    ns1 = jnp.where(t0 > t1, t0, t1)
    nh1 = jnp.where(t0 > t1, hist[:, 1], hist[:, 0])
    ns1 = jnp.maximum(ns1, worst)
    best = jnp.maximum(best, jnp.where(active, ns1, worst))

    # --- state 0 ---
    ns0 = jnp.maximum(s0 + tprob(0, 0), worst)
    best = jnp.maximum(best, jnp.where(active, ns0, worst))

    new_score = jnp.stack([ns0, ns1, ns2], axis=1)
    new_hist = jnp.stack([hist[:, 0], nh1, nh2], axis=1)
    score = jnp.where(active[:, None], new_score, score)
    hist = jnp.where(active[:, None], new_hist, hist)
    return score, hist, out_score, out_hist, best


def _eval_5st(score, hist, out_score, out_hist, senscr, tp, active):
    """Vectorized hmm_vit_eval_5st_lr over phones (hmm.c:166-305; the
    scalar spec is hmm.py vit_eval_5st).

    score [P,5] int32, hist [P,5], out_score [P], out_hist [P],
    senscr [P,5] int32, tp [P,5,6] int32 (quantized negated probs),
    active [P] bool.  Unlike the 3-state kernel there is no t2-reuse
    quirk: every 3-way select reads its own transition row, and the
    state-4 / state-3 blocks are guarded by the C's
    ``if (s2 > WORST)`` / ``if (s1 > WORST)`` checks.
    """
    i32 = jnp.int32

    def tprob(i, j):
        t = tp[:, i, j]
        return -(t[:, None] if t.ndim == 1 and score.ndim == 3 else t)

    s = [score[:, i] + -senscr[:, i] for i in range(5)]
    worst = i32(WORST_SCORE)
    best = jnp.full_like(s[0], worst)

    def sel3(t0, t1, t2, h_self, h_t1, h_t2):
        """C's nested if: if t0>t1 (t2>t0 ? t2 : t0) else (t2>t1 ? t2 : t1)
        with matching history choice."""
        branch_a = t0 > t1
        use_t2 = jnp.where(branch_a, t2 > t0, t2 > t1)
        ns = jnp.where(use_t2, t2, jnp.where(branch_a, t0, t1))
        nh = jnp.where(use_t2, h_t2, jnp.where(branch_a, h_self, h_t1))
        return jnp.maximum(ns, worst), nh

    # --- state 5 (out, non-emitting): from 4 and 3, guarded by s3 ---
    t1 = s[4] + tprob(4, 5)
    t2 = s[3] + tprob(3, 5)
    s5 = jnp.maximum(jnp.where(t1 > t2, t1, t2), worst)
    nh5 = jnp.where(t1 > t2, hist[:, 4], hist[:, 3])
    do5 = active & (s[3] > worst)
    out_score = jnp.where(do5, s5, out_score)
    out_hist = jnp.where(do5, nh5, out_hist)
    best = jnp.where(do5, s5, best)

    # --- state 4: from 4/3/2, guarded by s2 ---
    g4 = active & (s[2] > worst)
    ns4, nh4 = sel3(s[4] + tprob(4, 4), s[3] + tprob(3, 4),
                    s[2] + tprob(2, 4), hist[:, 4], hist[:, 3], hist[:, 2])
    best = jnp.maximum(best, jnp.where(g4, ns4, worst))

    # --- state 3: from 3/2/1, guarded by s1 ---
    g3 = active & (s[1] > worst)
    ns3, nh3 = sel3(s[3] + tprob(3, 3), s[2] + tprob(2, 3),
                    s[1] + tprob(1, 3), hist[:, 3], hist[:, 2], hist[:, 1])
    best = jnp.maximum(best, jnp.where(g3, ns3, worst))

    # --- state 2: from 2/1/0 (unguarded) ---
    ns2, nh2 = sel3(s[2] + tprob(2, 2), s[1] + tprob(1, 2),
                    s[0] + tprob(0, 2), hist[:, 2], hist[:, 1], hist[:, 0])
    best = jnp.maximum(best, jnp.where(active, ns2, worst))

    # --- state 1 ---
    t0 = s[1] + tprob(1, 1)
    t1 = s[0] + tprob(0, 1)
    ns1 = jnp.maximum(jnp.where(t0 > t1, t0, t1), worst)
    nh1 = jnp.where(t0 > t1, hist[:, 1], hist[:, 0])
    best = jnp.maximum(best, jnp.where(active, ns1, worst))

    # --- state 0 ---
    ns0 = jnp.maximum(s[0] + tprob(0, 0), worst)
    best = jnp.maximum(best, jnp.where(active, ns0, worst))

    ax = 1
    new_score = jnp.stack([
        jnp.where(active, ns0, score[:, 0]),
        jnp.where(active, ns1, score[:, 1]),
        jnp.where(active, ns2, score[:, 2]),
        jnp.where(g3, ns3, score[:, 3]),
        jnp.where(g4, ns4, score[:, 4]),
    ], axis=ax)
    new_hist = jnp.stack([
        hist[:, 0],
        jnp.where(active, nh1, hist[:, 1]),
        jnp.where(active, nh2, hist[:, 2]),
        jnp.where(g3, nh3, hist[:, 3]),
        jnp.where(g4, nh4, hist[:, 4]),
    ], axis=ax)
    return new_score, new_hist, out_score, out_hist, best


def _eval_emit(score, hist, out_score, out_hist, senscr, tp, active,
               lanes: bool):
    """Dispatch the per-topology HMM kernel by emitting-state count
    (hmm_vit_eval, hmm.c:741-759; anytopo models stay on the host
    path — hmm.py vit_eval_anytopo).  tp is [P, E, E+1] or the
    lane-major [P, E, E+1, B], so E is always axis 1."""
    E = tp.shape[1]
    if E == 3:
        f = _eval_3st_lanes if lanes else _eval_3st
        return f(score, hist, out_score, out_hist, senscr, tp, active)
    if E == 5:
        # _eval_5st's tprob broadcasts for both layouts
        return _eval_5st(score, hist, out_score, out_hist, senscr, tp,
                         active)
    raise NotImplementedError(
        f"device Viterbi supports 3/5 emitting states, got {E} "
        "(use the host decoder path for anytopo models)")


def build_pred_table(edge_src, edge_dst, edge_pen, n_nodes: int,
                     k_pad: int | None = None):
    """Edge list -> dense padded predecessor table.

    Returns (pred_idx [P, K] int32, pred_pen [P, K] int32, pred_ok
    [P, K] bool) with K = max in-degree (or ``k_pad`` if given and
    larger, so graphs stacked into one batch share a slot count);
    empty slots point at node 0 with pred_ok False.  Slots are filled
    in edge order, so a first-max-wins argmax over slots reproduces
    the C edge-iteration tie-break (phone_transition,
    state_align_search.c:108-133).

    This dense form replaces a segment-max over the edge list: a
    [P, K] gather + max is one fused vector op per scan step, with no
    scatter-style segment ops or int64 (score, idx) packing.
    """
    edge_src = np.asarray(edge_src)
    edge_dst = np.asarray(edge_dst)
    edge_pen = np.asarray(edge_pen)
    counts = np.bincount(edge_dst, minlength=n_nodes)
    K = max(1, int(counts.max()) if len(edge_dst) else 1)
    if k_pad is not None:
        if K > k_pad:
            raise ValueError(f"in-degree {K} exceeds k_pad {k_pad}")
        K = k_pad
    pred_idx = np.zeros((n_nodes, K), np.int32)
    pred_pen = np.zeros((n_nodes, K), np.int32)
    pred_ok = np.zeros((n_nodes, K), bool)
    slot = np.zeros(n_nodes, np.int64)
    for s, d, p in zip(edge_src, edge_dst, edge_pen):
        k = slot[d]
        pred_idx[d, k] = s
        pred_pen[d, k] = p
        pred_ok[d, k] = True
        slot[d] += 1
    return pred_idx, pred_pen, pred_ok


def make_vit_step(senid, tp, pred_idx, pred_pen, pred_ok, astart, aend,
                  n_frames, with_scores: bool, tok_dtype):
    """Build the per-frame Viterbi step function (shared by the
    single-device scan below and the sequence-parallel chunked scan in
    parallel/seqpipe.py).  xs = (t, sen [P,3]); carry = (score [P,3],
    hist [P,3], out_score [P], out_hist [P], best_prev)."""
    P, E = senid.shape
    i32 = jnp.int32
    worst = i32(WORST_SCORE)
    sidx = (jnp.arange(P)[:, None] * E + jnp.arange(E)[None, :]).astype(i32)

    def step(carry, xs):
        score, hist, out_score, out_hist, best_prev = carry
        t, sen = xs
        valid_frame = t < n_frames
        active = (t >= astart) & (t <= aend) & valid_frame

        # renormalize (state_align_search.c:193-197)
        renorm = (best_prev - 0x300000) < worst
        score = jnp.where(renorm & (score > worst), score - best_prev, score)

        score, hist, out_score, out_hist, bestv = _eval_emit(
            score, hist, out_score, out_hist, sen, tp, active, lanes=False)
        best = jnp.max(jnp.where(active, bestv, worst))

        # phone transitions (phone_transition, state_align_search.c:108-133):
        # a phone enters from a predecessor when the predecessor remains
        # active into the next frame (survived its window).  Dense
        # [P, K] predecessor gather + first-max-wins argmax.
        nf = t + 1
        active_next = active & (nf <= aend)
        src_ok = pred_ok & active_next[pred_idx]
        vals = jnp.where(src_ok, out_score[pred_idx] + pred_pen, worst)
        best_k = jnp.argmax(vals, axis=1)
        rows = jnp.arange(P)
        ent_score = vals[rows, best_k]
        has_edge = src_ok[rows, best_k]
        ent_hist = jnp.where(has_edge, out_hist[pred_idx[rows, best_k]], -1)
        can_enter = has_edge & (nf >= astart) & (nf <= aend)
        # C rule: enter if target was inactive, or entering score better
        was_active = active
        do_enter = can_enter & ((~was_active) | (ent_score > score[:, 0]))
        score = score.at[:, 0].set(
            jnp.where(do_enter, ent_score, score[:, 0]))
        hist = hist.at[:, 0].set(jnp.where(do_enter, ent_hist, hist[:, 0]))

        # record tokens (record_transitions, state_align_search.c:149-175).
        # C records phones with hmm_frame >= frame_idx: active this frame
        # OR freshly entered for the next frame.
        recorded = active | do_enter
        tok_id = jnp.where(recorded[:, None], hist, -1) \
            .astype(tok_dtype).reshape(P * E)
        if with_scores:
            tok_score = jnp.where(recorded[:, None], score, -1).reshape(P * E)
        else:
            tok_score = None
        hist = jnp.where(recorded[:, None], sidx, hist)

        return (score, hist, out_score, out_hist, best), (tok_id, tok_score)

    return step


def vit_carry0(P: int, entry_score=None, n_emit: int = 3):
    """Initial Viterbi carry (score/hist/out/out_hist/best_prev)."""
    i32 = jnp.int32
    worst = i32(WORST_SCORE)
    score0 = jnp.full((P, n_emit), worst, dtype=i32)
    if entry_score is None:
        score0 = score0.at[0, 0].set(0)
    else:
        # entry_score [P]: initial in-state score for entry nodes (their
        # pass-1-equivalent entry penalty), WORST_SCORE elsewhere.
        score0 = score0.at[:, 0].set(entry_score.astype(i32))
    hist0 = jnp.full((P, n_emit), -1, dtype=i32)
    out0 = jnp.full((P,), worst, dtype=i32)
    outh0 = jnp.full((P,), -1, dtype=i32)
    return (score0, hist0, out0, outh0, i32(0))


@partial(jax.jit, static_argnums=(10,))
def align_viterbi(senscr, senid, tp, pred_idx, pred_pen, pred_ok,
                  astart, aend, n_frames, entry_score=None,
                  with_scores: bool = True):
    """Run the masked Viterbi DP over a phone graph.

    senscr [T, n_sen] int16/32 senone scores (0=best per frame)
    senid [P, 3] int32, tp [P, 3, 4] int32
    pred_idx/pred_pen/pred_ok [P, K]: padded predecessor table from
      build_pred_table (penalties <= 0)
    astart/aend [P] int32 active frame windows
    n_frames: int32 actual frame count (T may be padded)
    with_scores: also emit the per-frame token scores (needed only when
      the caller reports per-segment scores; the throughput path skips
      them, halving the token-stack memory traffic)

    Returns (tok_id [T, P*3] int16/int32, tok_score [T, P*3] int32 or
             None, final_out_score [P] int32, final_out_hist [P] int32).
    Token ids are int16 when P*3 fits (saves d2h + HBM bytes).
    """
    T = senscr.shape[0]
    P, E = senid.shape
    i32 = jnp.int32
    tok_dtype = jnp.int16 if P * E < 32767 else jnp.int32
    # Pre-gather per-frame per-state senone scores once, outside the
    # scan: one big [T, P, E] gather beats a per-step dynamic-slice +
    # gather chain inside the loop.
    sen_all = senscr.astype(i32)[:, senid]  # [T, P, E]
    step = make_vit_step(senid, tp, pred_idx, pred_pen, pred_ok,
                         astart, aend, n_frames, with_scores, tok_dtype)
    carry0 = vit_carry0(P, entry_score, E)
    (score, hist, out_score, out_hist, _), (tok_id, tok_score) = \
        jax.lax.scan(step, carry0, (jnp.arange(T, dtype=i32), sen_all),
                     unroll=_scan_unroll(VITERBI_UNROLL))
    return tok_id, tok_score, out_score, out_hist


def _eval_3st_lanes(score, hist, out_score, out_hist, senscr, tp, active):
    """Batch-in-lanes hmm_vit_eval_3st_lr: identical arithmetic to
    _eval_3st but with the BATCH as the minor (lane) dimension.

    score/hist/senscr [P, 3, B], out_score/out_hist [P, B], tp [P, 3, 4]
    (per-phone constants, broadcast over lanes) OR [P, 3, 4, B]
    (per-LANE transition matrices, the multi-graph batch path),
    active [P, B] bool.

    Why: with [B, P, 3] layouts every per-state array has a minor dim
    of 3; putting B in the minor dimension keeps the per-frame state
    ~P*3*B*4 dense, contiguous bytes.  (The layout was chosen for a
    machine with 128-wide vector lanes; whether it is the best layout
    on the GPU is for a trace to decide.)
    """
    i32 = jnp.int32

    def tprob(i, j):
        t = tp[:, i, j]
        # [P] -> [P, 1] broadcast over lanes; [P, B] stays per-lane
        return -(t[:, None] if t.ndim == 1 else t)

    s0 = score[:, 0] + -senscr[:, 0]
    s1 = score[:, 1] + -senscr[:, 1]
    s2 = score[:, 2] + -senscr[:, 2]

    worst = i32(WORST_SCORE)
    best = jnp.full_like(s0, worst)

    # --- state 3 (out, non-emitting) --- (same t2 quirk as _eval_3st)
    t1 = s2 + tprob(2, 3)
    skip13 = tprob(1, 3) > TMAT_WORST       # [P, 1]
    t2 = jnp.where(skip13, s1 + tprob(1, 3), NEG_INF)
    s3 = jnp.where(t1 > t2, t1, t2)
    new_out_hist = jnp.where(t1 > t2, hist[:, 2], hist[:, 1])
    s3 = jnp.maximum(s3, worst)
    do3 = active & (s1 > worst)
    out_score = jnp.where(do3, s3, out_score)
    out_hist = jnp.where(do3, new_out_hist, out_hist)
    best = jnp.where(do3, s3, best)
    t2_carry = jnp.where(skip13, s1 + tprob(1, 3), NEG_INF)

    # --- state 2 ---
    t0 = s2 + tprob(2, 2)
    t1 = s1 + tprob(1, 2)
    skip02 = tprob(0, 2) > TMAT_WORST
    t2 = jnp.where(skip02, s0 + tprob(0, 2), t2_carry)
    branch_a = t0 > t1
    use_t2 = jnp.where(branch_a, t2 > t0, t2 > t1)
    ns2 = jnp.where(use_t2, t2, jnp.where(branch_a, t0, t1))
    nh2 = jnp.where(use_t2, hist[:, 0],
                    jnp.where(branch_a, hist[:, 2], hist[:, 1]))
    ns2 = jnp.maximum(ns2, worst)
    best = jnp.maximum(best, jnp.where(active, ns2, worst))

    # --- state 1 ---
    t0 = s1 + tprob(1, 1)
    t1 = s0 + tprob(0, 1)
    ns1 = jnp.where(t0 > t1, t0, t1)
    nh1 = jnp.where(t0 > t1, hist[:, 1], hist[:, 0])
    ns1 = jnp.maximum(ns1, worst)
    best = jnp.maximum(best, jnp.where(active, ns1, worst))

    # --- state 0 ---
    ns0 = jnp.maximum(s0 + tprob(0, 0), worst)
    best = jnp.maximum(best, jnp.where(active, ns0, worst))

    new_score = jnp.stack([ns0, ns1, ns2], axis=1)
    new_hist = jnp.stack([hist[:, 0], nh1, nh2], axis=1)
    score = jnp.where(active[:, None], new_score, score)
    hist = jnp.where(active[:, None], new_hist, hist)
    return score, hist, out_score, out_hist, best


def _shift_down(x, d: int, fill):
    """Shift rows of x [P, ...] down by static d (row p reads row p-d);
    vacated rows take ``fill``.  Static pad+slice — no gather."""
    pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([pad, x[:-d]], axis=0)


def make_vit_step_lanes(tp, pred_idx, pred_pen, pred_ok, astart, aend,
                        n_frames, with_scores: bool, tok_dtype,
                        band=None):
    """Batch-in-lanes per-frame Viterbi step (see _eval_3st_lanes).

    xs = (t, sen [P, 3, B]); carry = (score [P,3,B], hist [P,3,B],
    out_score [P,B], out_hist [P,B], best_prev [B]).  n_frames is a
    per-lane [B] vector.  Arithmetic is identical to make_vit_step —
    tests/test_align_tpu.py checks the two paths bit-match.

    Two graph-tensor forms:

    * shared graph (one transcript for the whole batch): tp [P,3,4],
      pred_* [P,K], astart/aend [P] — per-phone constants broadcast
      over lanes;
    * per-lane graphs (a DIFFERENT transcript per batch row, the mixed
      serving workload): tp [P,3,4,B], pred_* [P,K,B], astart/aend
      [P,B] — predecessor lookups become per-lane take_along_axis
      gathers over the phone axis, everything else broadcasts.

    ``band`` (per-lane form only): (band_pen [W,P,B] int32, band_ok
    [W,P,B] bool) banded predecessor tables — slot i holds the edge
    from node p-(W-i) to p, or absent.  Alignment chain graphs are
    near-linear (offsets dst-src are small and positive), so the
    per-lane gather becomes W static row-shifts + selects instead of a
    per-lane take_along_axis inside the scan (the gather was far slower
    on the machine this was written for; not yet measured on the GPU).
    Tie-break: slots iterate d descending = src
    ascending, with strict >, reproducing build_pred_table's
    first-max-wins edge order.
    """
    P = tp.shape[0]
    E = tp.shape[1]
    K = pred_idx.shape[1]
    per_lane = pred_idx.ndim == 3
    astart_b = astart if astart.ndim == 2 else astart[:, None]  # [P,B]|[P,1]
    aend_b = aend if aend.ndim == 2 else aend[:, None]
    i32 = jnp.int32
    worst = i32(WORST_SCORE)
    sidx = (jnp.arange(P)[:, None] * E + jnp.arange(E)[None, :]).astype(i32)

    def step(carry, xs):
        score, hist, out_score, out_hist, best_prev = carry
        t, sen = xs
        valid_frame = (t < n_frames)[None, :]            # [1, B]
        in_win = (t >= astart_b) & (t <= aend_b)         # [P,B] or [P,1]
        active = in_win & valid_frame                    # [P, B]

        # renormalize (state_align_search.c:193-197), per lane
        renorm = ((best_prev - 0x300000) < worst)[None, None, :]
        score = jnp.where(renorm & (score > worst),
                          score - best_prev[None, None, :], score)

        score, hist, out_score, out_hist, bestv = _eval_emit(
            score, hist, out_score, out_hist, sen, tp, active, lanes=True)
        best = jnp.max(jnp.where(active, bestv, worst), axis=0)   # [B]

        # phone transitions: K-slot predecessor max, first-max-wins over
        # slots in edge order (matches build_pred_table + argmax).
        nf = t + 1
        active_next = active & (nf <= aend_b)
        ent_score = jnp.full((P, out_score.shape[1]), worst, i32)
        ent_hist = jnp.full_like(out_hist, -1)
        ent_ok = jnp.zeros_like(active)
        if band is not None:
            band_pen, band_ok = band                      # [W, P, B]
            W = band_pen.shape[0]
            for i in range(W):
                d = W - i                                 # descending
                sc_s = _shift_down(out_score, d, worst)
                hi_s = _shift_down(out_hist, d, -1)
                ac_s = _shift_down(active_next, d, False)
                ok_k = band_ok[i] & ac_s
                val_k = jnp.where(ok_k, sc_s + band_pen[i], worst)
                upd = val_k > ent_score                   # strict: first wins
                ent_score = jnp.where(upd, val_k, ent_score)
                ent_hist = jnp.where(upd, hi_s, ent_hist)
                ent_ok = jnp.where(upd, ok_k, ent_ok)
        else:
            for k in range(K):
                if per_lane:
                    src = pred_idx[:, k, :]               # [P, B]
                    ok_k = pred_ok[:, k, :] \
                        & jnp.take_along_axis(active_next, src, axis=0)
                    val_k = jnp.where(
                        ok_k,
                        jnp.take_along_axis(out_score, src, axis=0)
                        + pred_pen[:, k, :], worst)
                    hist_k = jnp.take_along_axis(out_hist, src, axis=0)
                else:
                    src = pred_idx[:, k]                  # [P]
                    ok_k = pred_ok[:, k][:, None] & active_next[src]
                    val_k = jnp.where(
                        ok_k, out_score[src] + pred_pen[:, k][:, None],
                        worst)
                    hist_k = out_hist[src]
                upd = val_k > ent_score                   # strict: first wins
                ent_score = jnp.where(upd, val_k, ent_score)
                ent_hist = jnp.where(upd, hist_k, ent_hist)
                ent_ok = jnp.where(upd, ok_k, ent_ok)
        ent_hist = jnp.where(ent_ok, ent_hist, -1)
        can_enter = ent_ok & (nf >= astart_b) & (nf <= aend_b) \
            & valid_frame
        do_enter = can_enter & ((~active) | (ent_score > score[:, 0]))
        score = score.at[:, 0].set(
            jnp.where(do_enter, ent_score, score[:, 0]))
        hist = hist.at[:, 0].set(jnp.where(do_enter, ent_hist, hist[:, 0]))

        recorded = active | do_enter                      # [P, B]
        S = P * E
        B = out_score.shape[1]
        tok_id = jnp.where(recorded[:, None, :], hist, -1) \
            .astype(tok_dtype).reshape(S, B)
        if with_scores:
            tok_score = jnp.where(recorded[:, None, :], score, -1) \
                .reshape(S, B)
        else:
            tok_score = None
        hist = jnp.where(recorded[:, None, :], sidx[:, :, None], hist)

        return (score, hist, out_score, out_hist, best), (tok_id, tok_score)

    return step


def vit_carry0_lanes(P: int, B: int, entry_score=None, n_emit: int = 3):
    """Initial batch-in-lanes Viterbi carry.  entry_score is [P] (shared
    graph) or [B, P] (per-lane graphs)."""
    i32 = jnp.int32
    worst = i32(WORST_SCORE)
    score0 = jnp.full((P, n_emit, B), worst, dtype=i32)
    if entry_score is None:
        score0 = score0.at[0, 0, :].set(0)
    else:
        es = entry_score.astype(i32)
        score0 = score0.at[:, 0, :].set(es.T if es.ndim == 2 else es[:, None])
    hist0 = jnp.full((P, n_emit, B), -1, dtype=i32)
    out0 = jnp.full((P, B), worst, dtype=i32)
    outh0 = jnp.full((P, B), -1, dtype=i32)
    return (score0, hist0, out0, outh0, jnp.zeros((B,), i32))


@partial(jax.jit, static_argnums=(8,))
def align_viterbi_batch(sen_g, tp, pred_idx, pred_pen, pred_ok,
                        astart, aend, n_frames, with_scores: bool = False,
                        entry_score=None, band_pen=None, band_ok=None):
    """Whole-batch Viterbi with the batch in the lane dimension.

    sen_g [B, T, S=P*3] int16/int32: senone scores already gathered per
    graph state (the caller folds the [n_sen]->[S] gather into the
    scoring stage — as an exact one-hot f32 matmul on the shared-graph
    path, or a per-row column gather on the mixed path).
    n_frames [B] int32 per-utterance frame counts.

    Graph tensors come in two forms (see make_vit_step_lanes): shared
    (tp [P,3,4], pred_* [P,K], astart/aend [P], entry_score [P]) or
    per-row for a batch of DIFFERENT transcripts (tp [B,P,3,4],
    pred_* [B,P,K], astart/aend [B,P], entry_score [B,P]) — the
    per-row form is transposed to lane-major here so the batch stays
    in the vector lanes either way.

    band_pen/band_ok [B, W, P] (per-row form only): banded predecessor
    tables from stack_graphs; when given, the K-slot gather loop is
    replaced by W static row-shifts (see make_vit_step_lanes).

    Returns (tok_id [B, T, S], tok_score or None, out_score [B, P],
    out_hist [B, P]).  Bit-identical to vmap(align_viterbi) — the lane
    layout changes only how XLA tiles the arrays, not the arithmetic.
    """
    B, T, S = sen_g.shape
    E = tp.shape[-2]                       # emitting states (3 or 5)
    P = S // E
    i32 = jnp.int32
    tok_dtype = jnp.int16 if S < 32767 else jnp.int32
    band = None
    if tp.ndim == 4:                       # per-row graphs -> lane-major
        tp = tp.transpose(1, 2, 3, 0)                  # [P,E,E+1,B]
        pred_idx = pred_idx.transpose(1, 2, 0)         # [P,K,B]
        pred_pen = pred_pen.transpose(1, 2, 0)
        pred_ok = pred_ok.transpose(1, 2, 0)
        astart = astart.T                              # [P,B]
        aend = aend.T
        if band_pen is not None:
            band = (band_pen.transpose(1, 2, 0),       # [W,P,B]
                    band_ok.transpose(1, 2, 0))
    sen_l = sen_g.astype(i32).transpose(1, 2, 0).reshape(T, P, E, B)
    step = make_vit_step_lanes(tp, pred_idx, pred_pen, pred_ok,
                               astart, aend, n_frames, with_scores,
                               tok_dtype, band=band)
    carry0 = vit_carry0_lanes(P, B, entry_score, E)
    (score, hist, out_score, out_hist, _), (tok_id, tok_score) = \
        jax.lax.scan(step, carry0, (jnp.arange(T, dtype=i32), sen_l),
                     unroll=_scan_unroll(VITERBI_UNROLL))
    tok_id = tok_id.transpose(2, 0, 1)                    # [B, T, S]
    if with_scores:
        tok_score = tok_score.transpose(2, 0, 1)
    return tok_id, tok_score, out_score.T, out_hist.T


@partial(jax.jit, static_argnums=())
def backtrace(tok_id, tok_score, final_state, final_score, n_frames):
    """Device backtrace: walk the token stack backwards.

    Returns (path [T] int32 state ids active at each frame,
             path_score [T] int32, or None if tok_score is None).
    Frames >= n_frames hold -1.
    Mirrors state_align_search_finish's walk (state_align_search.c:226-255):
    the state at frame t is determined scanning from the last frame's
    winner backwards through tok_id.
    """
    T = tok_id.shape[0]
    with_scores = tok_score is not None

    def step(carry, t):
        cur_id, cur_score = carry
        # t runs T-1 .. 0; the "current" state covers frame t+1; token at
        # frame t points to the state covering frame t.
        in_range = t < n_frames - 1
        nid = jnp.where(in_range, tok_id[t, cur_id].astype(jnp.int32),
                        cur_id)
        out = jnp.where(t < n_frames, cur_id, -1)
        if with_scores:
            nscore = jnp.where(in_range, tok_score[t, cur_id], cur_score)
            outs = jnp.where(t < n_frames, cur_score, -1)
        else:
            nscore, outs = None, None
        return (nid, nscore), (out, outs)

    (first_id, _), (path_rev, score_rev) = jax.lax.scan(
        step, (final_state, final_score if with_scores else None),
        jnp.arange(T - 1, -1, -1, dtype=jnp.int32),
        unroll=_scan_unroll(BACKTRACE_UNROLL))
    return path_rev[::-1], (score_rev[::-1] if with_scores else None)


@jax.jit
def backtrace_batch(tok_id, tok_score, final_state, final_score, n_frames):
    """Batched device backtrace with the batch in the lane dimension.

    tok_id [B, T, S], final_state/final_score/n_frames [B] ->
    (path [B, T] int32, path_score [B, T] int32 or None).  Equivalent
    to vmap(backtrace), but the per-lane token lookup tok[t, cur_id_b]
    is a one-hot masked max over states ([S, B] elementwise ops per
    step) instead of a batched dynamic gather inside the scan (the same
    choice as the per-lane predecessor gathers, see
    make_vit_step_lanes).

    Failed rows (final_state < 0) match vmap(backtrace)'s contract at
    the only frame extraction reads: path[n_frames-1] stays negative.
    """
    B, T, S = tok_id.shape
    i32 = jnp.int32
    with_scores = tok_score is not None
    MIN = i32(-(1 << 30))
    tok_rev = tok_id.transpose(1, 2, 0)[::-1]               # [T, S, B]
    tsc_rev = (tok_score.transpose(1, 2, 0)[::-1]
               if with_scores else None)
    iota = jnp.arange(S, dtype=i32)[:, None]                # [S, 1]
    ts = jnp.arange(T - 1, -1, -1, dtype=i32)

    def step(carry, xs):
        cur_id, cur_score = carry                           # [B]
        if with_scores:
            t, tok_t, tsc_t = xs
        else:
            t, tok_t = xs
            tsc_t = None
        oh = iota == cur_id[None, :]                        # [S, B]
        cand = jnp.max(jnp.where(oh, tok_t.astype(i32), MIN), axis=0)
        in_range = t < n_frames - 1
        nid = jnp.where(in_range, cand, cur_id)
        out = jnp.where(t < n_frames, cur_id, -1)
        if with_scores:
            csc = jnp.max(jnp.where(oh, tsc_t, MIN), axis=0)
            nscore = jnp.where(in_range, csc, cur_score)
            outs = jnp.where(t < n_frames, cur_score, -1)
        else:
            nscore, outs = None, None
        return (nid, nscore), (out, outs)

    xs = (ts, tok_rev, tsc_rev) if with_scores else (ts, tok_rev)
    (_, _), (path_rev, score_rev) = jax.lax.scan(
        step, (final_state,
               final_score if with_scores else None), xs,
        unroll=_scan_unroll(BACKTRACE_UNROLL))
    path = path_rev[::-1].T                                 # [B, T]
    return path, (score_rev[::-1].T if with_scores else None)
