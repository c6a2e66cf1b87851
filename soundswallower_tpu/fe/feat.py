"""Dynamic feature computation: MFCC -> model feature vectors.

Reimplements ``src/feat.c`` (1s_c_d_dd at :588-632, block-utterance path at
:977-1007) and ``src/cmn.c`` batch CMN (:159-225), with float32 arithmetic
matching the C order of operations:

* CMN batch ("current"): per-dim float32 running sum over frames in frame
  order, skipping frames whose c0 < 0; mean = sum/nframe (float32 divide);
  mean subtracted from every frame (cmn.c:159-225).
* Edge padding: first/last frame replicated ``win`` times *after* CMN
  (feat_s2mfc2feat_block_utt, feat.c:977-1007).
* 1s_c_d_dd: d[t] = c[t+2]-c[t-2]; dd[t] = (c[t+3]-c[t-1])-(c[t+1]-c[t-3])
  (feat_1s_c_d_dd_cep2feat, feat.c:588-632); all float32 subtractions.
* Subvector projection 0-12/13-25/26-38 is a reshape to 3 streams of 13
  (parse_subvecs/feat_subvec_project, feat.c:181,346).

Everything here is jittable JAX; the scan for CMN keeps the exact float32
accumulation order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

FEAT_DCEP_WIN = 2
WIN = FEAT_DCEP_WIN + 1  # feat window size for 1s_c_d_dd


# ---------------------------------------------------------------------------
# Exact host (numpy) reference path.
#
# XLA with --xla_allow_excess_precision (the default in some deployments) may
# evaluate f32 chains in f64 on CPU, which breaks bit-parity of the float32
# accumulation in CMN.  The numpy path below is the exactness oracle used by
# the decoder's parity-critical path and by tests; the jitted path is used
# for batched device throughput.
# ---------------------------------------------------------------------------

def cmn_batch_np(cep: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Batch CMN, exact float32 (cmn(), src/cmn.c:159-225)."""
    s = np.zeros(cep.shape[1], np.float32)
    n = 0
    for f in range(len(cep)):
        if cep[f, 0] < 0:
            continue
        s = (s + cep[f]).astype(np.float32)
        n += 1
    mean = (s / np.float32(n)).astype(np.float32)
    return (cep - mean[None, :]).astype(np.float32), mean


def feats_full_utt_np(cep: np.ndarray, cmn_mode: str = "batch") -> np.ndarray:
    """Exact host path: [T, ncep] float32 -> [T, 3, ncep] float32.

    Mirrors feat_s2mfc2feat_block_utt (feat.c:977-1007): CMN, then edge
    replication by WIN frames, then 1s_c_d_dd dynamic features.
    """
    if cmn_mode in ("batch", "current"):
        cep, _ = cmn_batch_np(cep)
    T, ncep = cep.shape
    padded = np.concatenate(
        [np.tile(cep[0], (WIN, 1)), cep, np.tile(cep[-1], (WIN, 1))], axis=0
    ).astype(np.float32)
    c = padded[WIN : WIN + T]
    d = (padded[WIN + 2 : WIN + T + 2] - padded[WIN - 2 : WIN + T - 2]).astype(np.float32)
    d1 = (padded[WIN + 3 : WIN + T + 3] - padded[WIN - 1 : WIN + T - 1]).astype(np.float32)
    d2 = (padded[WIN + 1 : WIN + T + 1] - padded[WIN - 3 : WIN + T - 3]).astype(np.float32)
    dd = (d1 - d2).astype(np.float32)
    return np.stack([c, d, dd], axis=1)


@partial(jax.jit, static_argnums=())
def cmn_batch(cep, n_frames):
    """Batch CMN over the first n_frames rows of cep [T, ncep] float32.

    Returns (cep_normalized, mean).  Frames with c0 < 0 are excluded from
    the mean but still normalized (cmn.c:175-196).
    """
    T = cep.shape[0]
    idx = jnp.arange(T)
    valid = (idx < n_frames) & (cep[:, 0] >= 0)

    def step(carry, x):
        s, n = carry
        frame, v = x
        s = jnp.where(v, s + frame, s)  # float32 add in frame order
        n = jnp.where(v, n + 1, n)
        return (s, n), None

    (s, n), _ = jax.lax.scan(
        step, (jnp.zeros(cep.shape[1], jnp.float32), jnp.int32(0)), (cep, valid)
    )
    mean = s / n.astype(jnp.float32)
    return cep - mean[None, :], mean


def compute_feat_1s_c_d_dd(cep_padded):
    """[T + 2*WIN, ncep] padded cepstra -> [T, 3*ncep] features (float32)."""
    c = cep_padded[WIN:-WIN]
    d = cep_padded[WIN + 2 : cep_padded.shape[0] - WIN + 2] - \
        cep_padded[WIN - 2 : cep_padded.shape[0] - WIN - 2]
    d1 = cep_padded[WIN + 3 : cep_padded.shape[0] - WIN + 3] - \
        cep_padded[WIN - 1 : cep_padded.shape[0] - WIN - 1]
    d2 = cep_padded[WIN + 1 : cep_padded.shape[0] - WIN + 1] - \
        cep_padded[WIN - 3 : cep_padded.shape[0] - WIN - 3]
    dd = d1 - d2
    return jnp.concatenate([c, d, dd], axis=-1)


# ---------------------------------------------------------------------------
# Full feature-type registry (feat_init_s3file, feat.c:732-927) + LDA
# (lda.c:125-144) + subvector projection (feat.c:181-368).
#
# The shipped models use 1s_c_d_dd (fast paths above); the variants below
# are the exact host path for the remaining reference feature types.  All
# arithmetic is float32 in the C operation order (each subtraction cast).
# ---------------------------------------------------------------------------

def parse_subvecs(spec: str) -> list[list[int]]:
    """parse_subvecs (feat.c:181-277): '/'-separated subvectors, each a
    comma list of dims or a-b ranges; duplicates within a subvector are
    errors."""
    out = []
    for sv in spec.split("/"):
        dims: list[int] = []
        if not sv:
            raise ValueError(f"'{spec}': 0-length subvector")
        for part in sv.split(","):
            if "-" in part[1:]:  # allow leading '-'? C sscanf reads ints
                a_s, b_s = part.split("-", 1)
                a, b = int(a_s), int(b_s)
            else:
                a = b = int(part)
            if a < 0 or a > b:
                raise ValueError(f"'{spec}': bad subrange spec {part}")
            for n in range(a, b + 1):
                if n in dims:
                    raise ValueError(f"'{spec}': duplicate dimension {n}")
                dims.append(n)
        out.append(dims)
    return out


def _f32(x):
    return np.asarray(x, np.float32)


class FeatPipeline:
    """Feature-type registry + LDA + subvector projection (exact host
    path).  Mirrors feat_init_s3file (feat.c:732-927): ``feat_type``
    selects stream shapes, window size, and the cep->feat function;
    ``lda``/``ldadim`` apply a linear transform (single-stream only,
    lda.c:84-144); ``svspec`` projects dimensions into subvector streams
    (feat.c:289-368)."""

    def __init__(self, feat_type: str = "1s_c_d_dd", cepsize: int = 13,
                 lda: np.ndarray | None = None, ldadim: int = 0,
                 svspec: str | None = None):
        t = feat_type
        self.name = t
        self.cepsize = cepsize
        if t == "s2_4x":
            if cepsize != 13:
                raise ValueError("s2_4x features require cepsize == 13")
            self.n_stream, self.stream_len = 4, [12, 24, 3, 12]
            self.window_size = 4
            self._compute = self._s2_4x
        elif t in ("s3_1x39", "1s_12c_12d_3p_12dd"):
            if cepsize != 13:
                raise ValueError("s3_1x39 features require cepsize == 13")
            self.n_stream, self.stream_len = 1, [39]
            self.window_size = 3
            self._compute = self._s3_1x39
        elif t.startswith("1s_c_d_dd"):
            self.n_stream, self.stream_len = 1, [cepsize * 3]
            self.window_size = FEAT_DCEP_WIN + 1
            self._compute = self._1s_c_d_dd
        elif t.startswith("1s_c_d_ld_dd"):
            self.n_stream, self.stream_len = 1, [cepsize * 4]
            self.window_size = FEAT_DCEP_WIN * 2
            self._compute = self._1s_c_d_ld_dd
        elif t.startswith("cep_dcep") or t.startswith("1s_c_d"):
            self.n_stream, self.stream_len = 1, [cepsize * 2]
            self.window_size = 2
            self._compute = self._cep_dcep
        elif t.startswith("cep") or t.startswith("1s_c"):
            self.n_stream, self.stream_len = 1, [cepsize]
            self.window_size = 0
            self._compute = self._copy
        elif t.startswith("1s_3c") or t.startswith("1s_4c"):
            self.window_size = 3 if t.startswith("1s_3c") else 4
            self.n_stream = 1
            self.stream_len = [cepsize * (2 * self.window_size + 1)]
            self._compute = self._copy
        else:
            # generic "%d,%d,...[:win]" comma list of stream widths
            self.window_size = 0
            if ":" in t:
                t, win_s = t.split(":", 1)
                self.window_size = int(win_s)
            widths = [int(w) for w in t.split(",")]
            if any(w <= 0 for w in widths):
                raise ValueError("Bad feature type argument")
            self.n_stream = len(widths)
            if sum(widths) != cepsize:
                raise ValueError("Bad feature type argument")
            self._in_widths = widths
            self.stream_len = [w * (2 * self.window_size + 1)
                               for w in widths]
            self._compute = self._copy_streams
        self.out_dim = sum(self.stream_len)

        self.lda = None
        if lda is not None:
            if self.n_stream != 1:
                raise ValueError("LDA incompatible with multi-stream features")
            lda = np.asarray(lda, np.float32)
            if lda.ndim == 3:
                lda = lda[0]
            if lda.shape[1] != self.stream_len[0]:
                raise ValueError(
                    f"LDA matrix dimension {lda.shape[1]} doesn't match "
                    f"feature stream size {self.stream_len[0]}")
            self.lda = lda
            m = lda.shape[0]
            self.out_dim = m if (ldadim <= 0 or ldadim > m) else ldadim

        self.subvecs = None
        self.sv_len = None
        if svspec:
            if self.n_stream != 1:
                raise ValueError(
                    "Subvector specifications require single-stream features")
            self.subvecs = parse_subvecs(svspec)
            n_dim = sum(len(s) for s in self.subvecs)
            if n_dim > self.out_dim:
                raise ValueError(
                    f"Total dimensionality of subvector specification "
                    f"{n_dim} > feature dimensionality {self.out_dim}")
            self.sv_len = [len(s) for s in self.subvecs]

    # -- output shape as the scorer consumes it -----------------------------

    @property
    def shape(self) -> tuple[int, int]:
        """(n_feat, max stream length) of the final per-frame output."""
        if self.subvecs is not None:
            return len(self.subvecs), max(self.sv_len)
        return self.n_stream, max(self.stream_len)

    # -- per-type compute functions (padded [T+2w, ncep] -> streams) --------

    def _win(self, p, off):
        w = self.window_size
        T = p.shape[0] - 2 * w
        return p[w + off: w + off + T]

    def _s2_4x(self, p):
        c = self._win(p, 0)
        d_s = _f32(self._win(p, 2)[:, 1:] - self._win(p, -2)[:, 1:])
        d_l = _f32(self._win(p, 4)[:, 1:] - self._win(p, -4)[:, 1:])
        d1 = _f32(self._win(p, 3) - self._win(p, -1))
        d2 = _f32(self._win(p, 1) - self._win(p, -3))
        dd = _f32(d1 - d2)
        pow3 = np.stack([c[:, 0],
                         _f32(self._win(p, 2)[:, 0] - self._win(p, -2)[:, 0]),
                         dd[:, 0]], axis=1)
        return [c[:, 1:], np.concatenate([d_s, d_l], 1), pow3, dd[:, 1:]]

    def _s3_1x39(self, p):
        c = self._win(p, 0)
        d = _f32(self._win(p, 2) - self._win(p, -2))
        d1 = _f32(self._win(p, 3) - self._win(p, -1))
        d2 = _f32(self._win(p, 1) - self._win(p, -3))
        dd = _f32(d1 - d2)
        pow3 = np.stack([c[:, 0], d[:, 0], dd[:, 0]], axis=1)
        return [np.concatenate([c[:, 1:], d[:, 1:], pow3, dd[:, 1:]], 1)]

    def _1s_c_d_dd(self, p):
        w = FEAT_DCEP_WIN
        c = self._win(p, 0)
        d = _f32(self._win(p, w) - self._win(p, -w))
        d1 = _f32(self._win(p, w + 1) - self._win(p, -w + 1))
        d2 = _f32(self._win(p, w - 1) - self._win(p, -w - 1))
        dd = _f32(d1 - d2)
        return [np.concatenate([c, d, dd], 1)]

    def _1s_c_d_ld_dd(self, p):
        w = FEAT_DCEP_WIN
        c = self._win(p, 0)
        d = _f32(self._win(p, w) - self._win(p, -w))
        ld = _f32(self._win(p, 2 * w) - self._win(p, -2 * w))
        d1 = _f32(self._win(p, w + 1) - self._win(p, -w + 1))
        d2 = _f32(self._win(p, w - 1) - self._win(p, -w - 1))
        dd = _f32(d1 - d2)
        return [np.concatenate([c, d, ld, dd], 1)]

    def _cep_dcep(self, p):
        c = self._win(p, 0)
        d = _f32(self._win(p, 2) - self._win(p, -2))
        return [np.concatenate([c, d], 1)]

    def _copy(self, p):
        w = self.window_size
        return [np.concatenate([self._win(p, i) for i in range(-w, w + 1)],
                               1)]

    def _copy_streams(self, p):
        w = self.window_size
        outs = []
        pos = 0
        for width in self._in_widths:
            cols = [self._win(p, i)[:, pos:pos + width]
                    for i in range(-w, w + 1)]
            outs.append(np.concatenate(cols, 1))
            pos += width
        return outs

    # -- full-utterance pipeline --------------------------------------------

    def _project(self, streams: list[np.ndarray]) -> np.ndarray:
        """LDA + subvector projection + pad to [T, n_feat, max_len]."""
        T = streams[0].shape[0]
        if self.lda is not None:
            # feat_lda_transform (lda.c:125-144): tmp[j] = sum_k x[k]*A[j,k]
            # in ascending-k float32 accumulation; only out_dim rows kept
            x = streams[0]
            out = np.zeros((T, self.out_dim), np.float32)
            for k in range(x.shape[1]):
                out += x[:, k:k + 1] * self.lda[None, :self.out_dim, k]
                out = out.astype(np.float32)
            streams = [out]
        if self.subvecs is not None:
            flat = streams[0]
            streams = [flat[:, dims] for dims in self.subvecs]
        n_feat = len(streams)
        maxlen = max(s.shape[1] for s in streams)
        out = np.zeros((T, n_feat, maxlen), np.float32)
        for i, s in enumerate(streams):
            out[:, i, :s.shape[1]] = s
        return out

    def compute_full(self, cep: np.ndarray,
                     cmn_mode: str = "batch") -> np.ndarray:
        """[T, ncep] float32 -> [T, n_feat, max_len] float32 (zero-padded
        ragged streams).  CMN, then edge replication by window_size
        (feat_s2mfc2feat_block_utt, feat.c:977-1007), per-type dynamic
        features, LDA, subvector projection."""
        cep = np.asarray(cep, np.float32)
        if cmn_mode in ("batch", "current"):
            cep, _ = cmn_batch_np(cep)
        w = self.window_size
        if w:
            p = np.concatenate([np.tile(cep[0], (w, 1)), cep,
                                np.tile(cep[-1], (w, 1))]).astype(np.float32)
        else:
            p = cep
        return self._project(self._compute(p))

    def compute_window(self, win: np.ndarray) -> np.ndarray:
        """One frame from its [2*window_size+1, ncep] context window
        (already CMN'd) -> [n_feat, max_len] (the live/chunked path)."""
        assert win.shape[0] == 2 * self.window_size + 1
        return self._project(self._compute(np.asarray(win, np.float32)))[0]


@partial(jax.jit, static_argnums=(2,))
def feats_full_utt(cep, n_frames, cmn_mode: str = "batch"):
    """Full-utterance features: [T, ncep] -> [T, 3, ncep] float32.

    Mirrors acmod_process_full_cep -> feat_s2mfc2feat_live(beginutt=endutt=1)
    -> feat_s2mfc2feat_block_utt.  Rows >= n_frames are garbage (masked by
    caller).  The edge replication uses rows 0 and n_frames-1.
    """
    if cmn_mode in ("batch", "current"):
        cep, _ = cmn_batch(cep, n_frames)
    T, ncep = cep.shape
    first = cep[0]
    last = cep[jnp.maximum(n_frames - 1, 0)]
    # Build padded array [T + 2*WIN, ncep]: WIN copies of first, the data
    # (rows >= n_frames replaced by `last` so the tail windows replicate),
    idx = jnp.arange(T)
    body = jnp.where((idx < n_frames)[:, None], cep, last[None, :])
    padded = jnp.concatenate(
        [jnp.tile(first[None, :], (WIN, 1)), body, jnp.tile(last[None, :], (WIN, 1))],
        axis=0,
    )
    feat = compute_feat_1s_c_d_dd(padded)  # [T, 3*ncep]
    return feat.reshape(T, 3, ncep)
