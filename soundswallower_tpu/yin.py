"""YIN pitch estimator (reference: src/yin.c, include/soundswallower/yin.h).

Two paths:

* **Exact fixed-point path** (`Yin`): bit-identical to the reference's
  block-floating-point Q15 cumulative-mean-normalized-difference (CMND)
  implementation (yin.c:69-130) and its smoothed circular-window state
  machine (yin_write yin.c:198, yin_read yin.c:223).  The inner
  accumulation's dynamic shifting is sequential, so this lives in native
  C++ (native/sst_yin.cpp) bound via ctypes, with a pure-Python fallback
  when the shared library is not built.

* **Batched device path** (`cmnd_batch`, `pitch_batch`): float32 CMND over a
  whole ``[..., frame_size]`` frame tensor, computed as difference-energy
  d(t) = sum_j (x[j] - x[t+j])^2 via FFT-free windowed ops, then the
  cumulative-mean normalization and the same threshold-then-argmin period
  pick, all vectorized (one `argmax` over a boolean mask instead of the
  reference's early-exit scan).  Suitable for `vmap`/`jit`.

The estimator is standalone in the reference (not in the decode path);
it is exposed here for API completeness and as a batched voicing
feature extractor.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_TRIED = False


def _lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    from .utils.native_build import load_native
    lib = load_native("libsst_yin.so")
    if lib is None:
        return None
    lib.sst_yin_init.restype = ctypes.c_void_p
    lib.sst_yin_init.argtypes = [ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_int]
    lib.sst_yin_free.argtypes = [ctypes.c_void_p]
    lib.sst_yin_start.argtypes = [ctypes.c_void_p]
    lib.sst_yin_end.argtypes = [ctypes.c_void_p]
    lib.sst_yin_write.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int16)]
    lib.sst_yin_read.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint16),
                                 ctypes.POINTER(ctypes.c_uint16)]
    lib.sst_yin_read.restype = ctypes.c_int
    lib.sst_yin_cmn_diff.argtypes = [ctypes.POINTER(ctypes.c_int16),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.c_int]
    _LIB = lib
    return lib


def cmn_diff_exact(signal: np.ndarray, ndiff: int) -> np.ndarray:
    """Bit-exact Q15 CMND of one frame (yin.c:69-130).

    signal: int16 [>= 2*ndiff].  Returns int32 [ndiff]."""
    signal = np.ascontiguousarray(signal, dtype=np.int16)
    lib = _lib()
    if lib is not None:
        out = np.empty(ndiff, np.int32)
        lib.sst_yin_cmn_diff(
            signal.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ndiff)
        return out
    return _cmn_diff_py(signal, ndiff)


def _cmn_diff_py(signal: np.ndarray, ndiff: int) -> np.ndarray:
    """Pure-Python fallback, same block-floating-point semantics."""
    out = np.empty(ndiff, np.int32)
    out[0] = 32768
    cum = 0
    cshift = 0
    tscale = 0
    while tscale < 32 and not (ndiff & (1 << (31 - tscale))):
        tscale += 1
    tscale -= 1
    sig = signal.astype(np.int64)
    for t in range(1, ndiff):
        dd = 0
        dshift = 0
        lim = 1 << tscale
        for j in range(ndiff):
            diff = int(sig[j]) - int(sig[t + j])
            if dd > lim:
                dd >>= 1
                dshift += 1
            dd += (diff * diff) >> dshift
        if dshift > cshift:
            cum += dd << (dshift - cshift)
        else:
            cum += dd >> (cshift - dshift)
        while cum > lim:
            cum >>= 1
            cshift += 1
        if cum == 0:
            cum = 1
        norm = ((t << tscale) & 0xFFFFFFFF) // cum
        shift = tscale - 15 + cshift - dshift
        prod = dd * norm
        v = (prod >> shift) if shift >= 0 else (prod << -shift)
        out[t] = np.int32(v & 0xFFFFFFFF) if v <= 0x7FFFFFFF else np.int32(
            (v & 0xFFFFFFFF) - (1 << 32) if (v & 0x80000000) else v & 0x7FFFFFFF)
    return out


class Yin:
    """Moving-window pitch estimator, reference-equivalent API
    (yin_init/start/write/read/end, yin.h:63-106).

    frame_size: analysis frame length in samples (lags searched up to
    frame_size/2); search_threshold/search_range in [0,1) (quantized to
    Q15 like yin_init, yin.c:136-139); smooth_window: half-width of the
    period smoothing window."""

    def __init__(self, frame_size: int, search_threshold: float = 0.1,
                 search_range: float = 0.2, smooth_window: int = 2):
        self.frame_size = frame_size
        self.search_threshold = int(search_threshold * 32768)
        self.search_range = int(search_range * 32768)
        self.wsize = smooth_window * 2 + 1
        lib = _lib()
        if lib is not None:
            self._h = lib.sst_yin_init(frame_size,
                                       ctypes.c_float(search_threshold),
                                       ctypes.c_float(search_range),
                                       smooth_window)
            self._lib = lib
        else:
            self._h = None
            self._lib = None
            self._diff = np.zeros((self.wsize, frame_size // 2), np.int32)
            self._period = np.zeros(self.wsize, np.uint16)
            self._wstart = self._wcur = self._nfr = 0
            self._endut = False

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.sst_yin_free(self._h)
            self._h = None

    def start(self):
        if self._h is not None:
            self._lib.sst_yin_start(self._h)
        else:
            self._wstart = self._nfr = 0
            self._endut = False

    def end(self):
        if self._h is not None:
            self._lib.sst_yin_end(self._h)
        else:
            self._endut = True

    def write(self, frame: np.ndarray):
        frame = np.ascontiguousarray(frame, dtype=np.int16)
        if len(frame) < self.frame_size:
            raise ValueError("frame shorter than frame_size")
        if self._h is not None:
            self._lib.sst_yin_write(
                self._h, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
            return
        # fallback mirror of yin_write (yin.c:198-221)
        self._wstart += 1
        outptr = self._wstart - 1
        if self._wstart == self.wsize:
            self._wstart = 0
        difflen = self.frame_size // 2
        self._diff[outptr] = _cmn_diff_py(frame, difflen)
        self._period[outptr] = _thresholded_search_py(
            self._diff[outptr], self.search_threshold, 0, difflen)
        self._nfr += 1

    def read(self):
        """Returns (period_samples, bestdiff_q15) or None if no frame is
        available yet (yin_read, yin.c:223-326)."""
        if self._h is not None:
            period = ctypes.c_uint16()
            bdiff = ctypes.c_uint16()
            if self._lib.sst_yin_read(self._h, ctypes.byref(period),
                                      ctypes.byref(bdiff)):
                return int(period.value), int(bdiff.value)
            return None
        return self._read_py()

    def _read_py(self):
        half = (self.wsize - 1) // 2
        if half == 0:
            if self._endut:
                return None
            p = int(self._period[0])
            return p, int(self._diff[0][p])
        if not self._endut and self._nfr < half + 1:
            return None
        if self._endut:
            if self._wcur == self._wstart:
                return None
            wstart = (self._wcur + self.wsize - half) % self.wsize
            wlen = self._wstart - wstart
            if wlen < 0:
                wlen += self.wsize
        elif self._nfr < self.wsize:
            wstart, wlen = 0, self._nfr
        else:
            wstart, wlen = self._wstart, self.wsize
        best = int(self._period[self._wcur])
        best_diff = int(self._diff[self._wcur][best])
        for i in range(wlen):
            j = (wstart + i) % self.wsize
            d = int(self._diff[j][self._period[j]])
            if d < best_diff:
                best_diff = d
                best = int(self._period[j])
        if best == int(self._period[self._wcur]):
            self._wcur = (self._wcur + 1) % self.wsize
            return best, best_diff
        width = best * self.search_range // 32768
        if width == 0:
            width = 1
        lo = max(0, best - width)
        hi = min(self.frame_size // 2, best + width)
        best = _thresholded_search_py(self._diff[self._wcur],
                                      self.search_threshold, lo, hi)
        best_diff = int(self._diff[self._wcur][best])
        self._wcur = (self._wcur + 1) % self.wsize
        return min(best, 32768), min(best_diff, 32768)


def _thresholded_search_py(dw, threshold, start, end):
    best, argmin = 1 << 62, 0
    for i in range(start, end):
        d = int(dw[i])
        if d < threshold:
            return i
        if d < best:
            best, argmin = d, i
    return argmin


# ---------------------------------------------------------------------------
# Batched float device path
# ---------------------------------------------------------------------------

def cmnd_batch(frames, ndiff: int | None = None):
    """Float CMND over a frame tensor ``[..., frame_size]`` -> [..., ndiff].

    d(t) = sum_j (x[j] - x[t+j])^2; d'(0)=1, d'(t) = d(t) * t / cumsum(d).
    Output scaled to Q15 range (x32768) so thresholds match the exact path.
    jit/vmap-friendly (static shapes, no data-dependent control flow)."""
    import jax.numpy as jnp

    frame_size = frames.shape[-1]
    if ndiff is None:
        ndiff = frame_size // 2
    x = frames.astype(jnp.float32)
    base = x[..., :ndiff]                               # [..., ndiff]
    # lag matrix via gather: idx[t, j] = t + j
    idx = jnp.arange(ndiff)[:, None] + jnp.arange(ndiff)[None, :]
    shifted = x[..., idx]                               # [..., ndiff, ndiff]
    d = jnp.sum((base[..., None, :] - shifted) ** 2, axis=-1)  # [..., ndiff]
    t = jnp.arange(ndiff, dtype=jnp.float32)
    cum = jnp.cumsum(d, axis=-1)
    cum = jnp.where(cum <= 0.0, 1.0, cum)
    dprime = d * t / cum
    dprime = dprime.at[..., 0].set(1.0)
    return dprime * 32768.0


def pitch_batch(frames, search_threshold: float = 0.1):
    """Batched period estimate: for each frame, the first lag whose CMND
    falls under threshold, else the argmin (thresholded_search semantics,
    yin.c:174-196).  Returns (period [...,], bestdiff_q15 [...,])."""
    import jax.numpy as jnp

    d = cmnd_batch(frames)
    thr = search_threshold * 32768.0
    under = d < thr
    any_under = jnp.any(under, axis=-1)
    first = jnp.argmax(under, axis=-1)
    amin = jnp.argmin(d, axis=-1)
    period = jnp.where(any_under, first, amin)
    best = jnp.take_along_axis(d, period[..., None], axis=-1)[..., 0]
    return period, best
