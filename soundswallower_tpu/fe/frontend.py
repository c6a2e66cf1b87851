"""Signal-processing front end: audio -> MFCC, as a jittable JAX pipeline.

Reimplements the reference front end (``src/fe_interface.c``,
``src/fe_sigproc.c``, ``src/fe_noise.c``) with bit-compatible float
semantics:

* All frame/spectrum internals are float64 (``fe_type.h:42-44``:
  frame_t/powspec_t/window_t are float64), cepstral outputs float32.
* The FFT is the reference's in-place real-valued radix-2 algorithm
  (``fe_fft_real``, fe_sigproc.c:461-557) vectorized stage-by-stage: per
  array element the arithmetic sequence is identical, so results match the
  C code bit-for-bit (a library rfft would differ in final ulps).
* The mel filterbank is built with the reference's float32 arithmetic
  (``fe_build_melfilters``, fe_sigproc.c:85-199, round_filters/unit_area
  defaults), and filter accumulation is a sequential float64 fold in filter
  coefficient order (``fe_mel_spec``, fe_sigproc.c:588-607).
* Noise removal is the Doblinger/PNCC-style recurrence of fe_noise.c,
  expressed as a ``lax.scan`` over frames.
* DCT-II accumulates into a float32 accumulator per coefficient in filter
  order (``fe_dct2``, fe_sigproc.c:677-699), matching C rounding.

Frame extraction follows the streaming state machine semantics of
``fe_process`` + ``fe_end`` (fe_interface.c:577-712) for the full-utterance
case: frame f covers samples [f*shift, f*shift+frame_size); a final short
zero-padded frame covers the tail if any samples remain; pre-emphasis uses
the true previous sample across frame boundaries (prior = 0 at utterance
start).

Design note: this module runs under jit on any backend.  float64 is
slower than float32 on an accelerator, but the FE is a negligible
fraction of decode FLOPs (the GMM stage dominates) and the default host
FE (fe/native_fe.py) takes it off the device; parity is worth more than
the microseconds.  A
float32 fast path can be selected with ``dtype=jnp.float32`` for
throughput experiments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Host-side precomputation
# ---------------------------------------------------------------------------

def _f32(x) -> np.float32:
    return np.float32(x)


def _mel(x_f32: np.float32, warp=None) -> np.float32:
    """fe_mel (fe_sigproc.c:70-76): warp, then mel scale."""
    if warp is not None:
        x_f32 = warp.unwarped_to_warped(np.float32(x_f32))
    return np.float32(2595.0 * math.log10(1.0 + float(x_f32) / 700.0))


def _melinv(x_f32: np.float32, warp=None) -> np.float32:
    """fe_melinv (fe_sigproc.c:78-83): inverse mel scale, then unwarp."""
    f = np.float32(700.0 * (math.pow(10.0, float(x_f32) / 2595.0) - 1.0))
    if warp is not None:
        f = warp.warped_to_unwarped(f)
    return f


def build_melfilters(
    sampling_rate: float,
    fft_size: int,
    num_filters: int,
    lower_filt_freq: float,
    upper_filt_freq: float,
    doublewide: bool = False,
    round_filters: bool = True,
    unit_area: bool = True,
    warp=None,
):
    """fe_build_melfilters (fe_sigproc.c:85-199) with float32 arithmetic.

    Returns (spec_start[int32 per filter], widths, coeffs list of float32
    arrays).
    """
    melmin = _mel(_f32(lower_filt_freq), warp)
    melmax = _mel(_f32(upper_filt_freq), warp)
    melbw = np.float32((melmax - melmin) / np.float32(num_filters + 1))
    if doublewide:
        melmin = np.float32(melmin - melbw)
        melmax = np.float32(melmax + melbw)
    fftfreq = np.float32(np.float32(sampling_rate) / np.float32(fft_size))

    spec_start = np.full(num_filters, -1, dtype=np.int32)
    widths = np.zeros(num_filters, dtype=np.int32)
    coeffs = []
    for i in range(num_filters):
        freqs = []
        for j in range(3):
            if doublewide:
                f = _melinv(np.float32(np.float32((i + j * 2)) * melbw + melmin), warp)
            else:
                f = _melinv(np.float32(np.float32((i + j)) * melbw + melmin), warp)
            if round_filters:
                # ((int)(freqs[j] / fftfreq + 0.5)) * fftfreq; the +0.5 is a
                # double op in C (0.5 literal), int cast truncates.
                f = np.float32(int(float(np.float32(f / fftfreq)) + 0.5) * fftfreq)
            freqs.append(np.float32(f))
        start = -1
        width = 0
        for j in range(fft_size // 2 + 1):
            hz = np.float32(np.float32(j) * fftfreq)
            if hz < freqs[0]:
                continue
            elif hz > freqs[2] or j == fft_size // 2:
                width = j - start
                break
            if start == -1:
                start = j
        spec_start[i] = start
        widths[i] = width
        cf = np.zeros(width, dtype=np.float32)
        for j in range(width):
            hz = np.float32(np.float32(start + j) * fftfreq)
            loslope = np.float32((hz - freqs[0]) / np.float32(freqs[1] - freqs[0]))
            hislope = np.float32((freqs[2] - hz) / np.float32(freqs[2] - freqs[1]))
            if unit_area:
                scale = np.float32(np.float32(2.0) / np.float32(freqs[2] - freqs[0]))
                loslope = np.float32(loslope * scale)
                hislope = np.float32(hislope * scale)
            cf[j] = loslope if loslope < hislope else hislope
        coeffs.append(cf)
    return spec_start, widths, coeffs


def _fft_stage_indices(n: int):
    """Precompute per-stage butterfly index arrays for fe_fft_real.

    Returns (bitrev_perm, stages) where each stage (for k=1..m-1) is a dict
    of numpy index arrays for the vectorized update.
    """
    m = int(round(math.log2(n)))
    # Bit reversal permutation: replicate the C loop (fe_sigproc.c:472-485)
    perm = np.arange(n)
    j = 0
    for i in range(n - 1):
        if i < j:
            perm[i], perm[j] = perm[j], perm[i]
        k = n // 2
        while k <= j:
            j -= k
            k //= 2
        j += k
    stages = []
    for k in range(1, m):
        n4, n2, n1 = k - 1, k, k + 1
        blocks = np.arange(0, n, 1 << n1)
        i_a = blocks                      # x[i]
        i_b = blocks + (1 << n2)          # x[i + 2^k]
        i_c = blocks + (1 << n2) + (1 << n4)  # negate
        js = np.arange(1, 1 << n4)
        if len(js):
            jj, bb = np.meshgrid(js, blocks)
            i1 = (bb + jj).ravel()
            i2 = (bb + (1 << n2) - jj).ravel()
            i3 = (bb + (1 << n2) + jj).ravel()
            i4 = (bb + (1 << n2) + (1 << n2) - jj).ravel()
            tw = (jj << (m - n1)).ravel()
        else:
            i1 = i2 = i3 = i4 = tw = np.zeros(0, dtype=np.int64)
        stages.append(dict(i_a=i_a, i_b=i_b, i_c=i_c, i1=i1, i2=i2, i3=i3, i4=i4, tw=tw))
    return perm, stages


@dataclass(eq=False)  # identity hash so the bound jit cache works
class Frontend:
    """Precomputed FE parameters + jittable compute functions."""

    sampling_rate: int = 16000
    frame_rate: int = 100
    window_length: float = 0.025625
    fft_size: int = 0  # 0 = auto: next power of two >= frame_size
    num_cepstra: int = 13
    num_filters: int = 40
    lower_filt_freq: float = 133.33334
    upper_filt_freq: float = 6855.4976
    pre_emphasis_alpha: float = 0.97
    lifter_val: int = 0
    transform: str = "legacy"
    warp_type: str = "inverse_linear"
    warp_params: str | None = None
    remove_noise: bool = False
    remove_dc: bool = False
    round_filters: bool = True
    unit_area: bool = True
    doublewide: bool = False
    dtype: object = jnp.float64

    def __post_init__(self):
        # fe_init (fe_interface.c:263-266): +0.5 rounding
        self.frame_shift = int(self.sampling_rate / self.frame_rate + 0.5)
        self.frame_size = int(self.window_length * self.sampling_rate + 0.5)
        if self.fft_size == 0:
            n = 1
            while n < self.frame_size:
                n <<= 1
            self.fft_size = n
        assert self.frame_size <= self.fft_size

        # Hamming window (fe_create_hamming, fe_sigproc.c:258-269): only the
        # first half is stored; we expand to full length symmetrically.
        half = np.zeros(self.frame_size // 2, dtype=np.float64)
        for i in range(self.frame_size // 2):
            half[i] = 0.54 - 0.46 * math.cos(
                2 * math.pi * i / (float(self.frame_size) - 1.0)
            )
        win = np.ones(self.frame_size, dtype=np.float64)
        win[: self.frame_size // 2] = half
        win[self.frame_size - 1 : self.frame_size - 1 - self.frame_size // 2 : -1] = half
        self._window = win

        # Twiddles (fe_create_twiddle, fe_sigproc.c:449-459)
        idx = np.arange(self.fft_size // 4)
        ang = 2 * np.pi * idx / self.fft_size
        self._ccc = np.cos(ang)
        self._sss = np.sin(ang)
        self._perm, self._stages = _fft_stage_indices(self.fft_size)

        from .warp import Warp

        warp = Warp(self.warp_type, self.warp_params, self.sampling_rate)
        spec_start, widths, coeffs = build_melfilters(
            self.sampling_rate,
            self.fft_size,
            self.num_filters,
            self.lower_filt_freq,
            self.upper_filt_freq,
            self.doublewide,
            self.round_filters,
            self.unit_area,
            warp,
        )
        self._spec_start = spec_start
        self._widths = widths
        maxw = int(widths.max())
        self._maxw = maxw
        # Padded coefficient matrix [nfilt, maxw] and per-filter gather base.
        cmat = np.zeros((self.num_filters, maxw), dtype=np.float32)
        for i, cf in enumerate(coeffs):
            cmat[i, : len(cf)] = cf
        self._coeff_mat = cmat

        # DCT basis (fe_compute_melcosine, fe_sigproc.c:201-236): float32
        freqstep = math.pi / self.num_filters
        mc = np.zeros((self.num_cepstra, self.num_filters), dtype=np.float32)
        for i in range(self.num_cepstra):
            for j in range(self.num_filters):
                mc[i, j] = np.float32(math.cos(freqstep * i * (j + 0.5)))
        self._mel_cosine = mc
        self._sqrt_inv_n = np.float32(math.sqrt(1.0 / self.num_filters))
        self._sqrt_inv_2n = np.float32(math.sqrt(2.0 / self.num_filters))
        if self.lifter_val:
            lift = np.zeros(self.num_cepstra, dtype=np.float32)
            for i in range(self.num_cepstra):
                lift[i] = np.float32(
                    1 + self.lifter_val / 2 * math.sin(i * math.pi / self.lifter_val)
                )
            self._lifter = lift
        else:
            self._lifter = None

    @classmethod
    def from_config(cls, c) -> "Frontend":
        """The front end a ``Config`` describes (fe_init's parameters)."""
        return cls(
            sampling_rate=c.get_int("samprate"),
            frame_rate=c.get_int("frate"),
            window_length=c.get_float("wlen"),
            fft_size=c.get_int("nfft"),
            num_cepstra=c.get_int("ncep"),
            num_filters=c.get_int("nfilt"),
            lower_filt_freq=c.get_float("lowerf"),
            upper_filt_freq=c.get_float("upperf"),
            pre_emphasis_alpha=c.get_float("alpha"),
            lifter_val=c.get_int("lifter"),
            transform=c["transform"],
            warp_type=c["warp_type"] or "inverse_linear",
            warp_params=c["warp_params"],
            remove_noise=c.get_bool("remove_noise"),
            remove_dc=c.get_bool("remove_dc"),
        )

    # -- frame counting (output_frame_count, fe_interface.c:379-391) -------

    def n_frames(self, n_samps: int) -> int:
        """Number of output frames for a full utterance of n_samps samples
        (fe_process full frames + fe_end tail frame)."""
        if n_samps < self.frame_size:
            return 1 if n_samps > 0 else 0
        nfull = 1 + (n_samps - self.frame_size) // self.frame_shift
        tail = n_samps - nfull * self.frame_shift
        return nfull + (1 if tail > 0 else 0)

    # -- the jittable pipeline --------------------------------------------

    def _fft_real(self, x):
        """Vectorized fe_fft_real over [..., fft_size] float64."""
        n = self.fft_size
        ccc = jnp.asarray(self._ccc, dtype=self.dtype)
        sss = jnp.asarray(self._sss, dtype=self.dtype)
        x = x[..., jnp.asarray(self._perm)]
        # Stage 0: 2-point butterflies (fe_sigproc.c:491-495)
        e = x[..., 0::2]
        o = x[..., 1::2]
        x = jnp.stack([e + o, e - o], axis=-1).reshape(x.shape)
        for st in self._stages:
            i_a = jnp.asarray(st["i_a"])
            i_b = jnp.asarray(st["i_b"])
            i_c = jnp.asarray(st["i_c"])
            xa = x[..., i_a]
            xb = x[..., i_b]
            x = x.at[..., i_a].set(xa + xb)
            x = x.at[..., i_b].set(xa - xb)
            x = x.at[..., i_c].set(-x[..., i_c])
            if len(st["i1"]):
                i1 = jnp.asarray(st["i1"])
                i2 = jnp.asarray(st["i2"])
                i3 = jnp.asarray(st["i3"])
                i4 = jnp.asarray(st["i4"])
                cc = ccc[jnp.asarray(st["tw"])]
                ss = sss[jnp.asarray(st["tw"])]
                x1, x2, x3, x4 = x[..., i1], x[..., i2], x[..., i3], x[..., i4]
                t1 = x3 * cc + x4 * ss
                t2 = x3 * ss - x4 * cc
                x = x.at[..., i4].set(x2 - t2)
                x = x.at[..., i3].set(-x2 - t2)
                x = x.at[..., i2].set(x1 - t1)
                x = x.at[..., i1].set(x1 + t1)
        return x

    def _mel_spec(self, spec):
        """fe_mel_spec: sequential float64 fold per filter over coeffs."""
        # spec: [T, nfft/2+1]; gather windows [T, nfilt, maxw]
        base = jnp.asarray(self._spec_start)  # [nfilt]
        offs = jnp.arange(self._maxw)
        idx = jnp.clip(base[:, None] + offs[None, :], 0, self.fft_size // 2)
        wins = spec[..., idx]  # [T, nfilt, maxw]
        cm = jnp.asarray(self._coeff_mat)  # f32 [nfilt, maxw]
        valid = (offs[None, :] < jnp.asarray(self._widths)[:, None])
        # Sequential left fold in coefficient order, matching C accumulation
        # (fe_sigproc.c:603-605).  maxw is small (<= ~40).
        acc = jnp.zeros(wins.shape[:-1], dtype=self.dtype)
        for j in range(self._maxw):
            term = wins[..., j] * cm[:, j].astype(self.dtype)
            acc = jnp.where(valid[:, j], acc + term, acc)
        return acc

    def noise_init(self):
        """Fresh noise-removal state (fe_reset_noisestats)."""
        import jax.numpy as jnp
        z = jnp.zeros(self.num_filters, dtype=self.dtype)
        return (z, z, z, z, jnp.ones((), bool))

    def _remove_noise_scan(self, mfspec, init, valid=None):
        """fe_remove_noise (fe_noise.c:265-327) as a scan over frames,
        with an explicit carry so chunked processing preserves the
        cross-frame recurrence.  ``valid`` [T] bool freezes the carry on
        padded frames (needed whenever the carry outlives this call)."""
        lambda_power = 0.7
        lambda_a = 0.995
        lambda_b = 0.5
        lambda_t = 0.85
        mu_t = 0.2
        max_gain = 20.0
        smooth_window = 4
        nf = self.num_filters

        def step(carry, mfs):
            power, noise, floor, peak, undef = carry
            power = jnp.where(undef, mfs, power)
            noise = jnp.where(undef, mfs / max_gain, noise)
            floor = jnp.where(undef, mfs / max_gain, floor)
            peak = jnp.where(undef, jnp.zeros_like(mfs), peak)
            # smoothed power
            power = lambda_power * power + (1 - lambda_power) * mfs
            # lower envelope -> noise
            noise = jnp.where(
                power >= noise,
                lambda_a * noise + (1 - lambda_a) * power,
                lambda_b * noise + (1 - lambda_b) * power,
            )
            signal = jnp.maximum(power - noise, 1.0)
            cur_in = signal
            # lower envelope -> floor
            floor = jnp.where(
                signal >= floor,
                lambda_a * floor + (1 - lambda_a) * signal,
                lambda_b * floor + (1 - lambda_b) * signal,
            )
            # temporal masking (fe_temp_masking, fe_noise.c:135-157):
            # peak *= lambda_t; if (sig < lambda_t*peak) sig = peak*mu_t;
            # if (cur_in > peak) peak = cur_in
            peak = peak * lambda_t
            signal = jnp.where(signal < lambda_t * peak, peak * mu_t, signal)
            peak = jnp.where(cur_in > peak, cur_in, peak)
            signal = jnp.maximum(signal, floor)
            gain = jnp.where(
                signal < max_gain * power, signal / power, jnp.full_like(signal, max_gain)
            )
            gain = jnp.maximum(gain, 1.0 / max_gain)
            # weight smoothing (fe_weight_smooth, fe_noise.c:160-186):
            # sequential fold over the +-smooth_window window in index
            # order to match C float64 accumulation exactly.
            l1 = np.maximum(np.arange(nf) - smooth_window, 0)
            l2 = np.minimum(np.arange(nf) + smooth_window, nf - 1)
            coef = jnp.zeros_like(gain)
            for o in range(2 * smooth_window + 1):
                j = np.minimum(l1 + o, l2)
                take = (l1 + o) <= l2
                coef = jnp.where(jnp.asarray(take), coef + gain[jnp.asarray(j)], coef)
            out = mfs * (coef / jnp.asarray((l2 - l1 + 1), dtype=gain.dtype))
            return (power, noise, floor, peak, jnp.zeros((), bool)), out

        def step_masked(carry, xs):
            mfs, v = xs
            new_carry, out = step(carry, mfs)
            # padded rows must not advance the cross-frame recurrence
            # (streaming carries this state to the next chunk)
            kept = jax.tree_util.tree_map(
                lambda n, c: jnp.where(v, n, c), new_carry, carry)
            return kept, out

        if valid is None:
            carry, out = jax.lax.scan(step, init, mfspec)
        else:
            carry, out = jax.lax.scan(step_masked, init, (mfspec, valid))
        return out, carry

    def _dct(self, logspec):
        """fe_dct2 (dct) / fe_spec2cep (legacy): float32 accumulator folds."""
        mc = self._mel_cosine  # [ncep, nfilt] f32
        nfilt = self.num_filters
        T = logspec.shape[0]
        out = []
        if self.transform == "dct" or self.transform == "htk":
            # c0: float32 acc over filters (fe_dct2, fe_sigproc.c:683-690)
            acc = logspec[:, 0].astype(jnp.float32)
            for j in range(1, nfilt):
                acc = (acc.astype(self.dtype) + logspec[:, j]).astype(jnp.float32)
            scale = self._sqrt_inv_2n if self.transform == "htk" else self._sqrt_inv_n
            out.append(acc * jnp.float32(scale))
            for i in range(1, self.num_cepstra):
                acc = jnp.zeros(T, dtype=jnp.float32)
                for j in range(nfilt):
                    term = logspec[:, j] * jnp.asarray(mc[i, j], dtype=self.dtype)
                    acc = (acc.astype(self.dtype) + term).astype(jnp.float32)
                out.append(acc * jnp.float32(self._sqrt_inv_2n))
        else:
            # legacy fe_spec2cep (fe_sigproc.c:647-675)
            acc = (logspec[:, 0] / 2).astype(jnp.float32)
            for j in range(1, nfilt):
                acc = (acc.astype(self.dtype) + logspec[:, j]).astype(jnp.float32)
            out.append((acc / jnp.asarray(float(nfilt), self.dtype)).astype(jnp.float32))
            for i in range(1, self.num_cepstra):
                acc = jnp.zeros(T, dtype=jnp.float32)
                for j in range(nfilt):
                    beta = 1.0 if j == 0 else 2.0
                    term = logspec[:, j] * jnp.asarray(mc[i, j], dtype=self.dtype) * beta
                    acc = (acc.astype(self.dtype) + term).astype(jnp.float32)
                out.append(
                    (acc / jnp.asarray(float(nfilt) * 2, self.dtype)).astype(jnp.float32)
                )
        return jnp.stack(out, axis=-1)  # [T, ncep] float32

    def mfcc(self, signal_f32, n_samps, max_frames: int):
        """Full-utterance MFCC: float32 sample values -> [max_frames, ncep].

        signal_f32: float32 [N] of *sample values* (int16 range; callers
        scale float32 [-1,1) audio by 32768 to match fe_read_frame_float32's
        FLOAT32_SCALE).  Frames beyond n_frames(n_samps) are garbage; callers
        mask with the host-computed frame count.
        """
        cep, _ = self.mfcc_chunk(signal_f32, n_samps, max_frames,
                                 jnp.float32(0.0), self.noise_init())
        return cep

    @partial(jax.jit, static_argnums=(0, 3))
    def mfcc_chunk(self, signal_f32, n_samps, max_frames: int, prior,
                   noise_state, n_frames=None):
        """Chunk MFCC with explicit streaming state: ``prior`` is the
        sample preceding the chunk (pre-emphasis continuity,
        fe_interface.c:393-575 overflow semantics) and ``noise_state`` the
        noise-removal carry.  ``n_frames`` (traced int) bounds the rows
        that advance the noise carry — REQUIRED when the returned state
        feeds a next chunk, else padding pollutes the recurrence.
        Returns (cep, new_noise_state)."""
        logspec, noise_state = self._logspec_body(signal_f32, n_samps,
                                                  max_frames, prior,
                                                  noise_state, n_frames)
        mfcep = self._dct(logspec)
        if self._lifter is not None:
            mfcep = mfcep * jnp.asarray(self._lifter)
        return mfcep, noise_state

    def _logspec_body(self, signal_f32, n_samps, max_frames: int, prior,
                      noise_state, n_frames=None):
        """Shared pipeline through the mel log-spectrum [max_frames,
        nfilt] float (pre-emphasis, framing, window, FFT, mel,
        noise removal, log with LOG_FLOOR)."""
        dt = self.dtype
        shift, size, nfft = self.frame_shift, self.frame_size, self.fft_size
        sig = signal_f32
        n = sig.shape[0]
        # pre-emphasis in float64 over the whole signal (fe_pre_emphasis,
        # fe_sigproc.c:238-247, with cross-frame prior semantics)
        alpha = jnp.asarray(np.float32(self.pre_emphasis_alpha), dtype=dt)
        prev = jnp.concatenate([jnp.reshape(prior, (1,)).astype(sig.dtype),
                                sig[:-1]])
        # zero out samples at/after n_samps so padding can't leak in
        valid = jnp.arange(n) < n_samps
        sig = jnp.where(valid, sig, 0.0)
        prev = jnp.where(valid, prev, 0.0)
        pre = sig.astype(dt) - prev.astype(dt) * alpha

        # frame gather [max_frames, frame_size]
        starts = jnp.arange(max_frames) * shift
        fidx = starts[:, None] + jnp.arange(size)[None, :]
        in_range = fidx < n
        fidx = jnp.clip(fidx, 0, n - 1)
        frames = jnp.where(in_range, pre[fidx], 0.0)
        # the final (partial) frame must also zero samples >= n_samps
        frames = jnp.where(starts[:, None] + jnp.arange(size)[None, :] < n_samps,
                           frames, 0.0)
        if self.remove_dc:
            mean = jnp.sum(frames, axis=-1, keepdims=True) / size
            frames = frames - mean
        frames = frames * jnp.asarray(self._window, dtype=dt)
        # zero-pad to fft size
        frames = jnp.pad(frames, ((0, 0), (0, nfft - size)))
        fft = self._fft_real(frames)
        # fe_spec_magnitude (fe_sigproc.c:559-586)
        j = jnp.arange(1, nfft // 2 + 1)
        spec0 = (fft[..., 0] * fft[..., 0])[..., None]
        spec = fft[..., j] * fft[..., j] + fft[..., nfft - j] * fft[..., nfft - j]
        spec = jnp.concatenate([spec0, spec], axis=-1)
        mfspec = self._mel_spec(spec)
        if self.remove_noise:
            valid_fr = None if n_frames is None else \
                (jnp.arange(max_frames) < n_frames)
            mfspec, noise_state = self._remove_noise_scan(
                mfspec, noise_state, valid_fr)
        logspec = jnp.log(mfspec + 1e-4)  # LOG_FLOOR, fe_sigproc.c:609
        return logspec, noise_state

    @partial(jax.jit, static_argnums=(0, 3))
    def logspec_chunk(self, signal_f32, n_samps, max_frames: int):
        """Mel log-spectra [max_frames, nfilt] float64 (the f64
        powspec_t values the C pipeline carries before casting)."""
        logspec, _ = self._logspec_body(signal_f32, n_samps, max_frames,
                                        jnp.float32(0.0), self.noise_init())
        return logspec

    def _smooth_logspec(self, ls: np.ndarray) -> np.ndarray:
        """SMOOTH_LOG_SPEC (fe_mel_cep, fe_sigproc.c:624-637): DCT-II to
        num_cepstra coefficients, DCT-III back — cepstral-truncation
        smoothing.  Pure numpy with the C accumulation dtypes exactly
        (mfcc_t f32 accumulators rounded per add, powspec_t f64 for the
        DCT-III sums); the jitted equivalent picked up 1-ulp XLA
        reassociation diffs, and this is a host visualization API."""
        T = len(ls)
        nfilt, ncep = self.num_filters, self.num_cepstra
        mc = np.asarray(self._mel_cosine, np.float32)
        cep = np.zeros((T, ncep), np.float32)
        acc = ls[:, 0].astype(np.float32)
        for j in range(1, nfilt):
            acc = (acc.astype(np.float64) + ls[:, j]).astype(np.float32)
        cep[:, 0] = acc * np.float32(self._sqrt_inv_n)
        for i in range(1, ncep):
            acc = np.zeros(T, np.float32)
            for j in range(nfilt):
                term = ls[:, j] * np.float64(mc[i, j])
                acc = (acc.astype(np.float64) + term).astype(np.float32)
            cep[:, i] = acc * np.float32(self._sqrt_inv_2n)
        out = np.zeros((T, nfilt), np.float32)
        sqrt_half = np.float32(0.707106781186548)  # SQRT_HALF, fe.h:367
        for i in range(nfilt):
            acc = (cep[:, 0] * sqrt_half).astype(np.float64)
            for j in range(1, ncep):
                acc = acc + (cep[:, j] * mc[j, i]).astype(np.float64)
            out[:, i] = (acc * np.float64(np.float32(self._sqrt_inv_2n))) \
                .astype(np.float32)
        return out

    def spectrogram(self, audio: np.ndarray,
                    smooth: bool = False) -> np.ndarray:
        """Host helper: int16 samples (or float32 sample values in
        int16 range) -> [n_frames, nfilt] float32 mel log-spectra —
        the JS binding's spectrogram() (js/soundswallower.c:88-112):
        RAW_LOG_SPEC as-is, or SMOOTH_LOG_SPEC when ``smooth``."""
        audio = np.asarray(audio)
        n = len(audio)
        nfr = self.n_frames(n)
        if nfr == 0:
            return np.zeros((0, self.num_filters), np.float32)
        sig = jnp.asarray(audio.astype(np.float32))
        ls = np.asarray(self.logspec_chunk(sig, n, nfr), np.float64)[:nfr]
        if smooth:
            return self._smooth_logspec(ls)
        return ls.astype(np.float32)

    # -- convenience -------------------------------------------------------

    def process_int16(self, audio: np.ndarray) -> np.ndarray:
        """Host helper: int16 samples -> [n_frames, ncep] float32 numpy."""
        n = len(audio)
        nfr = self.n_frames(n)
        if nfr == 0:
            return np.zeros((0, self.num_cepstra), dtype=np.float32)
        sig = jnp.asarray(audio.astype(np.float32))
        out = self.mfcc(sig, n, nfr)
        return np.asarray(out[:nfr])
