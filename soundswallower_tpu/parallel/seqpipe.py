"""Sequence-parallel long-form alignment: ring-carried Viterbi over a
('seq',) mesh axis.

The reference handles long audio by streaming on one core (SURVEY.md §5
"long-context": chunked FE, circular buffers, live CMN).  The device
equivalent: shard the FRAME axis of an utterance across devices and pipe
the Viterbi recurrence's carry (per-state scores + backpointer heads,
~P*3 ints) around the ring with `ppermute` — the only sequential
dependency in the whole pipeline.  Senone scoring and dynamic features
are frame-local and run fully parallel on each shard.

A single utterance would leave P-1 devices idle while its carry walks
the ring, so the kernel runs a WAVEFRONT over a batch: at ring step k,
device p processes chunk p of utterance k-p.  With B utterances in
flight, utilization is B/(B+P-1) -> 1.  Token stacks (the [T, S] uint16
backpointer history, the memory hog for long audio) stay sharded: each
device keeps only its own chunk's tokens, so maximum audio length
scales linearly with the number of devices.  The backtrace is a second,
reverse wavefront carrying just (state, score) per utterance.

Exactness: the forward step function is the SAME `make_vit_step` the
single-device scan uses (ops/align_jax.py), so chunked output is
bit-identical to single-device output (verified in
tests/test_seqpipe.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.align_jax import (WORST_SCORE, make_vit_step, vit_carry0)


def seq_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("seq",))


def _pvary(x):
    return jax.lax.pcast(x, ("seq",), to="varying")


def _ring_perm(n, reverse=False):
    if reverse:
        return [(i, i - 1) for i in range(1, n)]
    return [(i, i + 1) for i in range(n - 1)]


def align_longform(mesh: Mesh, senscr, senid, tp, pred_idx, pred_pen,
                   pred_ok, astart, aend, n_frames, entry_score,
                   final_nodes):
    """Sequence-parallel Viterbi + backtrace.

    senscr [B, T, G] int16 (T divisible by mesh size; frames >= n_frames
    are padding), senid [P,3], tp [P,3,4], pred_* [P,K], astart/aend [P],
    n_frames [B] int32, entry_score [P] int32, final_nodes [F] int32.

    Returns (path [B, T] int32, final_score [B] int32); bit-identical to
    the single-device align_viterbi + backtrace.
    """
    nseq = mesh.devices.size
    B, T, G = senscr.shape
    assert T % nseq == 0, "frame axis must divide the seq mesh"
    C = T // nseq
    Pn = senid.shape[0]
    S = Pn * senid.shape[1]
    tok_dtype = jnp.int16 if S < 32767 else jnp.int32

    shard = NamedSharding(mesh, P(None, "seq", None))
    senscr = jax.device_put(senscr, shard)
    consts = jax.device_put(
        dict(senid=jnp.asarray(senid), tp=jnp.asarray(tp),
             pi=jnp.asarray(pred_idx), pp=jnp.asarray(pred_pen),
             pk=jnp.asarray(pred_ok), astart=jnp.asarray(astart),
             aend=jnp.asarray(aend), nfr=jnp.asarray(n_frames),
             entry=jnp.asarray(entry_score),
             fin=jnp.asarray(final_nodes)),
        NamedSharding(mesh, P()))

    fwd = jax.jit(
        jax.shard_map(
            partial(_forward, nseq=nseq, tok_dtype=tok_dtype),
            mesh=mesh,
            in_specs=(P(None, "seq", None), P()),
            out_specs=(P(None, "seq", None), P(), P()),
        ))
    tok_local, out_score, out_hist = fwd(senscr, consts)

    # pick the best final node per utterance (host-trivial, [B, F])
    fsc = out_score[:, consts["fin"]]
    best = jnp.argmax(fsc, axis=1)
    rows = jnp.arange(B)
    final_node = consts["fin"][best]
    final_state = out_hist[rows, final_node]
    final_score = out_score[rows, final_node]

    bwd = jax.jit(
        jax.shard_map(
            partial(_backward, nseq=nseq),
            mesh=mesh,
            in_specs=(P(None, "seq", None), P(), P(), P()),
            out_specs=P(None, "seq"),
        ))
    path = bwd(tok_local, final_state.astype(jnp.int32),
               consts["nfr"], consts)
    return path, final_score


def _forward(senscr_local, consts, *, nseq, tok_dtype):
    """Per-device forward wavefront.  senscr_local [B, C, G]."""
    B, C, G = senscr_local.shape
    Pn = consts["senid"].shape[0]
    S = Pn * consts["senid"].shape[1]
    idx = jax.lax.axis_index("seq")
    t0 = idx * C
    i32 = jnp.int32
    ts = t0 + jnp.arange(C, dtype=i32)

    def chunk_scan(carry, sen_b, nfr_b):
        stepb = make_vit_step(consts["senid"], consts["tp"], consts["pi"],
                              consts["pp"], consts["pk"], consts["astart"],
                              consts["aend"], nfr_b, False, tok_dtype)
        return jax.lax.scan(stepb, carry, (ts, sen_b), unroll=2)

    K = B + nseq - 1
    tok_buf = jnp.full((B, C, S), -1, tok_dtype)
    fin_score = jnp.zeros((B, Pn), i32)
    fin_hist = jnp.zeros((B, Pn), i32)
    carry = vit_carry0(Pn, consts["entry"])

    def outer(k, state):
        tok_buf, fin_score, fin_hist, carry = state
        b = k - idx
        valid = (b >= 0) & (b < B)
        bc = jnp.clip(b, 0, B - 1)
        sen_b = senscr_local[bc].astype(i32)[:, consts["senid"]]  # [C,P,3]
        nfr_b = consts["nfr"][bc]
        # fresh entry carry for the first chunk of each utterance
        carry_in = jax.tree_util.tree_map(
            lambda f, c: jnp.where(idx == 0, f, c),
            vit_carry0(Pn, consts["entry"]), carry)
        new_carry, (tok_c, _) = chunk_scan(carry_in, sen_b, nfr_b)
        # commit outputs only when this step was real work
        tok_buf = jnp.where(
            valid, tok_buf.at[bc].set(tok_c), tok_buf)
        is_last = (idx == nseq - 1) & valid
        fin_score = jnp.where(
            is_last, fin_score.at[bc].set(new_carry[2]), fin_score)
        fin_hist = jnp.where(
            is_last, fin_hist.at[bc].set(new_carry[3]), fin_hist)
        carry = jax.tree_util.tree_map(
            lambda n, c: jnp.where(valid, n, c), new_carry, carry)
        # ring-forward the carry
        carry = jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, "seq", _ring_perm(nseq)), carry)
        return tok_buf, fin_score, fin_hist, carry

    # mark the loop state as device-varying over 'seq' (it becomes so
    # after the first ppermute; fori_loop needs matching carry types)
    state0 = jax.tree_util.tree_map(
        lambda x: _pvary(x), (tok_buf, fin_score, fin_hist, carry))
    tok_buf, fin_score, fin_hist, _ = jax.lax.fori_loop(0, K, outer, state0)
    # final carries live on the last device; replicate via psum
    mask = (idx == nseq - 1).astype(i32)
    fin_score = jax.lax.psum(fin_score * mask, "seq")
    fin_hist = jax.lax.psum(fin_hist * mask, "seq")
    return tok_buf, fin_score, fin_hist


def _backward(tok_local, final_state, nfr, consts, *, nseq):
    """Reverse wavefront backtrace.  tok_local [B, C, S] on each device;
    emits path chunks [B, C]."""
    B, C, S = tok_local.shape
    idx = jax.lax.axis_index("seq")
    t0 = idx * C
    i32 = jnp.int32
    ts_rev = t0 + jnp.arange(C - 1, -1, -1, dtype=i32)

    def chunk_back(cur_id, toks, nfr_b):
        def step(cid, t):
            local_t = t - t0
            in_range = t < nfr_b - 1
            nid = jnp.where(in_range, toks[local_t, cid].astype(i32), cid)
            out = jnp.where(t < nfr_b, cid, -1)
            return nid, out
        cid, path_rev = jax.lax.scan(step, cur_id, ts_rev, unroll=2)
        return cid, path_rev[::-1]

    K = B + nseq - 1
    path_buf = jnp.full((B, C), -1, i32)
    carry = jnp.int32(0)

    def outer(k, state):
        path_buf, carry = state
        # device p handles utterance b at reverse step k when
        # k == b + (nseq - 1 - p)
        b = k - (nseq - 1 - idx)
        valid = (b >= 0) & (b < B)
        bc = jnp.clip(b, 0, B - 1)
        carry_in = jnp.where(idx == nseq - 1, final_state[bc], carry)
        new_carry, path_c = chunk_back(carry_in, tok_local[bc], nfr[bc])
        path_buf = jnp.where(valid, path_buf.at[bc].set(path_c), path_buf)
        carry = jnp.where(valid, new_carry, carry)
        # ring-backward the carry
        carry = jax.lax.ppermute(carry, "seq", _ring_perm(nseq, reverse=True))
        return path_buf, carry

    state0 = jax.tree_util.tree_map(lambda x: _pvary(x), (path_buf, carry))
    path_buf, _ = jax.lax.fori_loop(0, K, outer, state0)
    return path_buf
