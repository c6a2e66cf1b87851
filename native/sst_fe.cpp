// Native (host-side) MFCC front end for soundswallower_tpu.
//
// Bit-exact with the JAX front end in soundswallower_tpu/fe/frontend.py
// (itself bit-exact with the reference C front end, src/fe_sigproc.c /
// src/fe_interface.c / src/fe_noise.c): identical IEEE f64/f32 operation
// sequences, same radix-2 real FFT butterfly order (fe_fft_real,
// fe_sigproc.c:461-557), same sequential mel-filter and DCT accumulation
// folds.  Build with -ffp-contract=off so the compiler cannot fuse
// multiply-adds (FMA changes rounding).
//
// All precomputed tables (Hamming window, FFT twiddles + bit-reversal
// permutation, mel filter coefficients, DCT basis, lifter) are supplied by
// the Python caller so both paths share one table-construction code path.
//
// Why this exists: computing 13-dim cepstra on the host uploads ~6.7x
// fewer bytes than raw audio and keeps the float64 FE off the device.
// The batch API is threaded over utterances.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct FeState {
  int frame_shift, frame_size, nfft, ncep, nfilt, maxw;
  double alpha;          // pre-emphasis (already f32-rounded by caller)
  int transform;         // 0=legacy 1=dct 2=htk
  int remove_noise, remove_dc;
  std::vector<double> window;       // [frame_size]
  std::vector<double> ccc, sss;     // [nfft/4]
  std::vector<int32_t> perm;        // [nfft]
  std::vector<int32_t> spec_start;  // [nfilt]
  std::vector<int32_t> widths;      // [nfilt]
  std::vector<float> coeff;         // [nfilt * maxw]
  std::vector<float> mel_cosine;    // [ncep * nfilt]
  std::vector<float> lifter;        // [ncep] or empty
  float sqrt_inv_n, sqrt_inv_2n;
  int m;  // log2(nfft)
};

// fe_fft_real (fe_sigproc.c:461-557): in-place real-valued radix-2 FFT.
// Identical arithmetic order to Frontend._fft_real (read x1..x4 first,
// then write; the i_c negation cannot overlap the j-loop indices).
void fft_real(const FeState& st, double* x) {
  const int n = st.nfft, m = st.m;
  // bit-reversal permutation
  {
    double tmp[4096];
    for (int i = 0; i < n; i++) tmp[i] = x[st.perm[i]];
    std::memcpy(x, tmp, n * sizeof(double));
  }
  // stage 0: 2-point butterflies
  for (int i = 0; i < n; i += 2) {
    double e = x[i], o = x[i + 1];
    x[i] = e + o;
    x[i + 1] = e - o;
  }
  for (int k = 1; k < m; k++) {
    const int n4 = 1 << (k - 1), n2 = 1 << k, n1 = 1 << (k + 1);
    for (int blk = 0; blk < n; blk += n1) {
      double xa = x[blk], xb = x[blk + n2];
      x[blk] = xa + xb;
      x[blk + n2] = xa - xb;
      x[blk + n2 + n4] = -x[blk + n2 + n4];
      for (int j = 1; j < n4; j++) {
        const int i1 = blk + j;
        const int i2 = blk + n2 - j;
        const int i3 = blk + n2 + j;
        const int i4 = blk + n2 + n2 - j;
        const int tw = j << (m - (k + 1));
        const double cc = st.ccc[tw], ss = st.sss[tw];
        const double x1 = x[i1], x2 = x[i2], x3 = x[i3], x4 = x[i4];
        const double t1 = x3 * cc + x4 * ss;
        const double t2 = x3 * ss - x4 * cc;
        x[i4] = x2 - t2;
        x[i3] = -x2 - t2;
        x[i2] = x1 - t1;
        x[i1] = x1 + t1;
      }
    }
  }
}

// fe_remove_noise (fe_noise.c:265-327) recurrence state.
struct NoiseState {
  std::vector<double> power, noise, floorv, peak;
  bool undef = true;
  explicit NoiseState(int nfilt)
      : power(nfilt), noise(nfilt), floorv(nfilt), peak(nfilt) {}
};

void remove_noise_frame(const FeState& st, double* mfs, NoiseState& ns) {
  const double lambda_power = 0.7, lambda_a = 0.995, lambda_b = 0.5;
  const double lambda_t = 0.85, mu_t = 0.2, max_gain = 20.0;
  const int smooth_window = 4, nf = st.nfilt;
  std::vector<double> signal(nf), gain(nf);
  for (int i = 0; i < nf; i++) {
    double power = ns.undef ? mfs[i] : ns.power[i];
    double noise = ns.undef ? mfs[i] / max_gain : ns.noise[i];
    double fl = ns.undef ? mfs[i] / max_gain : ns.floorv[i];
    double peak = ns.undef ? 0.0 : ns.peak[i];
    power = lambda_power * power + (1 - lambda_power) * mfs[i];
    noise = (power >= noise) ? lambda_a * noise + (1 - lambda_a) * power
                             : lambda_b * noise + (1 - lambda_b) * power;
    double sig = power - noise;
    if (!(sig > 1.0)) sig = 1.0;  // jnp.maximum(x, 1.0) semantics
    const double cur_in = sig;
    fl = (sig >= fl) ? lambda_a * fl + (1 - lambda_a) * sig
                     : lambda_b * fl + (1 - lambda_b) * sig;
    peak = peak * lambda_t;
    if (sig < lambda_t * peak) sig = peak * mu_t;
    if (cur_in > peak) peak = cur_in;
    if (!(sig > fl)) sig = fl;
    double g = (sig < max_gain * power) ? sig / power : max_gain;
    if (!(g > 1.0 / max_gain)) g = 1.0 / max_gain;
    signal[i] = sig;
    gain[i] = g;
    ns.power[i] = power;
    ns.noise[i] = noise;
    ns.floorv[i] = fl;
    ns.peak[i] = peak;
  }
  ns.undef = false;
  // fe_weight_smooth (fe_noise.c:160-186): average gain over +-window.
  for (int i = 0; i < nf; i++) {
    const int l1 = i - smooth_window < 0 ? 0 : i - smooth_window;
    const int l2 = i + smooth_window > nf - 1 ? nf - 1 : i + smooth_window;
    double coef = 0.0;
    for (int j = l1; j <= l2; j++) coef += gain[j];
    mfs[i] = mfs[i] * (coef / (double)(l2 - l1 + 1));
  }
}

// ---------------------------------------------------------------------------
// 8-lane (AVX-512 f64) variant: one vector lane per UTTERANCE, identical
// IEEE op sequence per lane as the scalar path above, so each lane's
// output is bit-identical to a scalar run of that utterance.  Only the
// pure-arithmetic stages (framing, window, FFT, magnitude, mel fold) are
// vectorized; the branchy noise recurrence and the transcendental
// log/DCT tail run as per-lane scalar loops over the [i][8] layout
// (they are ~15% of the frame cost).
// ---------------------------------------------------------------------------

typedef double vd __attribute__((vector_size(64), aligned(64)));
typedef float vf __attribute__((vector_size(32), aligned(32)));
typedef long long vl __attribute__((vector_size(64), aligned(64)));
constexpr int LANES = 8;

inline vd vsel(vl c, vd a, vd b) { return c ? a : b; }

// 8-lane noise recurrence: identical per-lane arithmetic to
// remove_noise_frame (branches become blends, which preserve the exact
// selected values).  mfs/state arrays are [nfilt] of vd.
struct NoiseStateX8 {
  std::vector<vd> power, noise, floorv, peak;
  bool undef = true;
  explicit NoiseStateX8(int nfilt)
      : power(nfilt), noise(nfilt), floorv(nfilt), peak(nfilt) {}
};

void remove_noise_frame_x8(const FeState& st, vd* mfs, NoiseStateX8& ns,
                           vd* gain /*[nfilt] scratch*/) {
  const double lambda_power = 0.7, lambda_a = 0.995, lambda_b = 0.5;
  const double lambda_t = 0.85, mu_t = 0.2, max_gain = 20.0;
  const int smooth_window = 4, nf = st.nfilt;
  for (int i = 0; i < nf; i++) {
    vd power = ns.undef ? mfs[i] : ns.power[i];
    vd noise = ns.undef ? mfs[i] / max_gain : ns.noise[i];
    vd fl = ns.undef ? mfs[i] / max_gain : ns.floorv[i];
    vd peak = ns.undef ? vd{} : ns.peak[i];
    power = lambda_power * power + (1 - lambda_power) * mfs[i];
    noise = vsel(power >= noise,
                 lambda_a * noise + (1 - lambda_a) * power,
                 lambda_b * noise + (1 - lambda_b) * power);
    vd sig = power - noise;
    sig = vsel(sig > 1.0, sig, vd{} + 1.0);
    const vd cur_in = sig;
    fl = vsel(sig >= fl, lambda_a * fl + (1 - lambda_a) * sig,
              lambda_b * fl + (1 - lambda_b) * sig);
    peak = peak * lambda_t;
    sig = vsel(sig < lambda_t * peak, peak * mu_t, sig);
    peak = vsel(cur_in > peak, cur_in, peak);
    sig = vsel(sig > fl, sig, fl);
    vd g = vsel(sig < max_gain * power, sig / power, vd{} + max_gain);
    g = vsel(g > 1.0 / max_gain, g, vd{} + 1.0 / max_gain);
    gain[i] = g;
    ns.power[i] = power;
    ns.noise[i] = noise;
    ns.floorv[i] = fl;
    ns.peak[i] = peak;
  }
  ns.undef = false;
  for (int i = 0; i < nf; i++) {
    const int l1 = i - smooth_window < 0 ? 0 : i - smooth_window;
    const int l2 = i + smooth_window > nf - 1 ? nf - 1 : i + smooth_window;
    vd coef = {};
    for (int j = l1; j <= l2; j++) coef += gain[j];
    mfs[i] = mfs[i] * (coef / (double)(l2 - l1 + 1));
  }
}

void fft_real_x8(const FeState& st, vd* x, vd* tmp) {
  const int n = st.nfft, m = st.m;
  for (int i = 0; i < n; i++) tmp[i] = x[st.perm[i]];
  std::memcpy(x, tmp, (size_t)n * sizeof(vd));
  for (int i = 0; i < n; i += 2) {
    vd e = x[i], o = x[i + 1];
    x[i] = e + o;
    x[i + 1] = e - o;
  }
  for (int k = 1; k < m; k++) {
    const int n4 = 1 << (k - 1), n2 = 1 << k, n1 = 1 << (k + 1);
    for (int blk = 0; blk < n; blk += n1) {
      vd xa = x[blk], xb = x[blk + n2];
      x[blk] = xa + xb;
      x[blk + n2] = xa - xb;
      x[blk + n2 + n4] = -x[blk + n2 + n4];
      for (int j = 1; j < n4; j++) {
        const int i1 = blk + j;
        const int i2 = blk + n2 - j;
        const int i3 = blk + n2 + j;
        const int i4 = blk + n2 + n2 - j;
        const int tw = j << (m - (k + 1));
        const double cc = st.ccc[tw], ss = st.sss[tw];
        const vd x1 = x[i1], x2 = x[i2], x3 = x[i3], x4 = x[i4];
        const vd t1 = x3 * cc + x4 * ss;
        const vd t2 = x3 * ss - x4 * cc;
        x[i4] = x2 - t2;
        x[i3] = -x2 - t2;
        x[i2] = x1 - t1;
        x[i1] = x1 + t1;
      }
    }
  }
}

// 8 utterances in lockstep.  audio[l] may be null (inactive lane).
void process_utt_x8(const FeState& st, const int16_t* audio[LANES],
                    const int32_t n_samps[LANES], int Tmax,
                    float* out[LANES]) {
  const int shift = st.frame_shift, size = st.frame_size;
  int nfr[LANES], nfr_max = 0;
  for (int l = 0; l < LANES; l++) {
    const int ns_l = audio[l] ? n_samps[l] : 0;
    int f;
    if (ns_l <= 0)
      f = 0;
    else if (ns_l < size)
      f = 1;
    else {
      const int nfull = 1 + (ns_l - size) / shift;
      f = nfull + (ns_l - nfull * shift > 0 ? 1 : 0);
    }
    if (f > Tmax) f = Tmax;
    nfr[l] = f;
    if (f > nfr_max) nfr_max = f;
    if (out[l])
      std::memset(out[l], 0, (size_t)Tmax * st.ncep * sizeof(float));
  }
  const int n = st.nfft, half = n / 2, nfilt = st.nfilt;
  std::vector<vd> frame(n), tmp(n), spec(half + 1);
  std::vector<vd> mfsv(nfilt), lsv(nfilt), gain(nfilt);
  std::vector<vf> cep(st.ncep);
  std::vector<double> pe(LANES * size);
  NoiseStateX8 ns(nfilt);
  const bool fuse_window = !st.remove_dc;
  for (int f = 0; f < nfr_max; f++) {
    const int64_t s0 = (int64_t)f * shift;
    // per-lane contiguous pre-emphasis (+window when no DC removal):
    // vectorizable along the sample axis; then transpose into the
    // [sample][lane] FFT layout.  Same op order as the scalar path:
    // (cur - prv*alpha) rounds once, then *window rounds once.
    for (int l = 0; l < LANES; l++) {
      double* p = pe.data() + (size_t)l * size;
      const int16_t* a = audio[l];
      long navail = a ? (long)n_samps[l] - s0 : 0;
      if (navail < 0) navail = 0;
      if (navail > size) navail = size;
      int j0 = 0;
      if (navail > 0 && s0 == 0) {
        const double v0 = (double)(float)a[0];
        p[0] = fuse_window ? v0 * st.window[0] : v0;
        j0 = 1;
      }
      if (fuse_window) {
        for (int j = j0; j < (int)navail; j++)
          p[j] = ((double)(float)a[s0 + j] -
                  (double)(float)a[s0 + j - 1] * st.alpha) * st.window[j];
      } else {
        for (int j = j0; j < (int)navail; j++)
          p[j] = (double)(float)a[s0 + j] -
                 (double)(float)a[s0 + j - 1] * st.alpha;
      }
      for (int j = (int)navail; j < size; j++) p[j] = 0.0;
    }
    for (int j = 0; j < size; j++) {
      vd v;
      for (int l = 0; l < LANES; l++) v[l] = pe[(size_t)l * size + j];
      frame[j] = v;
    }
    if (st.remove_dc) {
      vd sum = {};
      for (int j = 0; j < size; j++) sum += frame[j];
      const vd mean = sum / (double)size;
      for (int j = 0; j < size; j++) frame[j] -= mean;
      for (int j = 0; j < size; j++) frame[j] *= st.window[j];
    }
    for (int j = size; j < n; j++) frame[j] = vd{};
    fft_real_x8(st, frame.data(), tmp.data());
    spec[0] = frame[0] * frame[0];
    for (int j = 1; j <= half; j++)
      spec[j] = frame[j] * frame[j] + frame[n - j] * frame[n - j];
    for (int i = 0; i < nfilt; i++) {
      const int start = st.spec_start[i], w = st.widths[i];
      vd acc = {};
      for (int j = 0; j < w; j++)
        acc += spec[start + j] * (double)st.coeff[i * st.maxw + j];
      mfsv[i] = acc;
    }
    // vectorized noise recurrence; scalar per-lane libm log; DCT with
    // per-step f32 rounding via __builtin_convertvector (identical
    // per-lane rounding sequence to the scalar (float)((double)a + ...)
    // folds)
    if (st.remove_noise) remove_noise_frame_x8(st, mfsv.data(), ns,
                                               gain.data());
    for (int i = 0; i < nfilt; i++) {
      vd v = mfsv[i] + 1e-4;
      vd r;
      for (int l = 0; l < LANES; l++) r[l] = std::log(v[l]);
      lsv[i] = r;
    }
    const float* mc = st.mel_cosine.data();
    const vd* ls = lsv.data();
#define CVT(x, T) __builtin_convertvector(x, T)
    if (st.transform == 1 || st.transform == 2) {
      vf acc = CVT(ls[0], vf);
      for (int j = 1; j < nfilt; j++) acc = CVT(CVT(acc, vd) + ls[j], vf);
      const float scale = st.transform == 2 ? st.sqrt_inv_2n
                                            : st.sqrt_inv_n;
      cep[0] = acc * scale;
      for (int i = 1; i < st.ncep; i++) {
        vf a = {};
        for (int j = 0; j < nfilt; j++)
          a = CVT(CVT(a, vd) + ls[j] * (double)mc[i * nfilt + j], vf);
        cep[i] = a * st.sqrt_inv_2n;
      }
    } else {
      vf acc = CVT(ls[0] / 2, vf);
      for (int j = 1; j < nfilt; j++) acc = CVT(CVT(acc, vd) + ls[j], vf);
      cep[0] = CVT(CVT(acc, vd) / (double)nfilt, vf);
      for (int i = 1; i < st.ncep; i++) {
        vf a = {};
        for (int j = 0; j < nfilt; j++) {
          const double beta = j == 0 ? 1.0 : 2.0;
          a = CVT(CVT(a, vd) + ls[j] * (double)mc[i * nfilt + j] * beta,
                  vf);
        }
        cep[i] = CVT(CVT(a, vd) / ((double)nfilt * 2), vf);
      }
    }
#undef CVT
    if (!st.lifter.empty())
      for (int i = 0; i < st.ncep; i++) cep[i] = cep[i] * st.lifter[i];
    for (int l = 0; l < LANES; l++) {
      if (f >= nfr[l]) continue;
      float* o = out[l] + (size_t)f * st.ncep;
      for (int i = 0; i < st.ncep; i++) o[i] = cep[i][l];
    }
  }
}

// One frame: pre-emphasized samples -> ncep float32 cepstra.
void frame_to_cep(const FeState& st, double* frame /*[nfft]*/,
                  NoiseState& ns, float* out) {
  fft_real(st, frame);
  // fe_spec_magnitude (fe_sigproc.c:559-586)
  const int n = st.nfft, half = n / 2;
  std::vector<double> spec(half + 1);
  spec[0] = frame[0] * frame[0];
  for (int j = 1; j <= half; j++)
    spec[j] = frame[j] * frame[j] + frame[n - j] * frame[n - j];
  // fe_mel_spec (fe_sigproc.c:588-607): sequential f64 fold per filter
  std::vector<double> mfspec(st.nfilt);
  for (int i = 0; i < st.nfilt; i++) {
    const int start = st.spec_start[i], w = st.widths[i];
    double acc = 0.0;
    for (int j = 0; j < w; j++)
      acc += spec[start + j] * (double)st.coeff[i * st.maxw + j];
    mfspec[i] = acc;
  }
  if (st.remove_noise) remove_noise_frame(st, mfspec.data(), ns);
  // log + DCT; f32 accumulator folds (fe_spec2cep/fe_dct2,
  // fe_sigproc.c:647-699)
  std::vector<double> logspec(st.nfilt);
  for (int i = 0; i < st.nfilt; i++)
    logspec[i] = std::log(mfspec[i] + 1e-4);
  const float* mc = st.mel_cosine.data();
  const int nfilt = st.nfilt;
  if (st.transform == 1 || st.transform == 2) {  // dct / htk
    float acc = (float)logspec[0];
    for (int j = 1; j < nfilt; j++) acc = (float)((double)acc + logspec[j]);
    const float scale = st.transform == 2 ? st.sqrt_inv_2n : st.sqrt_inv_n;
    out[0] = acc * scale;
    for (int i = 1; i < st.ncep; i++) {
      float a = 0.0f;
      for (int j = 0; j < nfilt; j++)
        a = (float)((double)a + logspec[j] * (double)mc[i * nfilt + j]);
      out[i] = a * st.sqrt_inv_2n;
    }
  } else {  // legacy fe_spec2cep
    float acc = (float)(logspec[0] / 2);
    for (int j = 1; j < nfilt; j++) acc = (float)((double)acc + logspec[j]);
    out[0] = (float)((double)acc / (double)nfilt);
    for (int i = 1; i < st.ncep; i++) {
      float a = 0.0f;
      for (int j = 0; j < nfilt; j++) {
        const double beta = j == 0 ? 1.0 : 2.0;
        a = (float)((double)a + logspec[j] * (double)mc[i * nfilt + j] * beta);
      }
      out[i] = (float)((double)a / ((double)nfilt * 2));
    }
  }
  if (!st.lifter.empty())
    for (int i = 0; i < st.ncep; i++) out[i] = out[i] * st.lifter[i];
}

// Full utterance: int16 audio -> [Tmax, ncep] f32 (rows >= n_frames zero).
void process_utt(const FeState& st, const int16_t* audio, int n_samps,
                 int Tmax, float* out) {
  const int shift = st.frame_shift, size = st.frame_size;
  // n_frames (fe_interface.c:379-391 full-utterance semantics)
  int nfr;
  if (n_samps <= 0)
    nfr = 0;
  else if (n_samps < size)
    nfr = 1;
  else {
    const int nfull = 1 + (n_samps - size) / shift;
    nfr = nfull + (n_samps - nfull * shift > 0 ? 1 : 0);
  }
  if (nfr > Tmax) nfr = Tmax;
  std::memset(out, 0, (size_t)Tmax * st.ncep * sizeof(float));
  NoiseState ns(st.nfilt);
  std::vector<double> frame(st.nfft);
  for (int f = 0; f < nfr; f++) {
    const int64_t s0 = (int64_t)f * shift;
    // pre-emphasis with true previous sample (prior = 0 at start),
    // zero beyond n_samps (frontend.py mfcc_chunk framing semantics)
    for (int j = 0; j < size; j++) {
      const int64_t idx = s0 + j;
      double v = 0.0;
      if (idx < n_samps) {
        const double cur = (double)(float)audio[idx];
        const double prv = idx > 0 ? (double)(float)audio[idx - 1] : 0.0;
        v = cur - prv * st.alpha;
      }
      frame[j] = v;
    }
    if (st.remove_dc) {
      double sum = 0.0;
      for (int j = 0; j < size; j++) sum += frame[j];
      const double mean = sum / size;
      for (int j = 0; j < size; j++) frame[j] -= mean;
    }
    for (int j = 0; j < size; j++) frame[j] *= st.window[j];
    for (int j = size; j < st.nfft; j++) frame[j] = 0.0;
    frame_to_cep(st, frame.data(), ns, out + (size_t)f * st.ncep);
  }
}

}  // namespace

extern "C" {

void* sst_fe_create(int frame_shift, int frame_size, int nfft, int ncep,
                    int nfilt, double alpha, int transform, int remove_noise,
                    int remove_dc, const double* window, const double* ccc,
                    const double* sss, const int32_t* perm,
                    const int32_t* spec_start, const int32_t* widths,
                    const float* coeff, int maxw, const float* mel_cosine,
                    const float* lifter, float sqrt_inv_n,
                    float sqrt_inv_2n) {
  if (nfft > 4096) return nullptr;  // fft_real scratch limit
  auto* st = new FeState();
  st->frame_shift = frame_shift;
  st->frame_size = frame_size;
  st->nfft = nfft;
  st->ncep = ncep;
  st->nfilt = nfilt;
  st->maxw = maxw;
  st->alpha = alpha;
  st->transform = transform;
  st->remove_noise = remove_noise;
  st->remove_dc = remove_dc;
  st->window.assign(window, window + frame_size);
  st->ccc.assign(ccc, ccc + nfft / 4);
  st->sss.assign(sss, sss + nfft / 4);
  st->perm.assign(perm, perm + nfft);
  st->spec_start.assign(spec_start, spec_start + nfilt);
  st->widths.assign(widths, widths + nfilt);
  st->coeff.assign(coeff, coeff + (size_t)nfilt * maxw);
  st->mel_cosine.assign(mel_cosine, mel_cosine + (size_t)ncep * nfilt);
  if (lifter) st->lifter.assign(lifter, lifter + ncep);
  st->sqrt_inv_n = sqrt_inv_n;
  st->sqrt_inv_2n = sqrt_inv_2n;
  st->m = 0;
  while ((1 << st->m) < nfft) st->m++;
  return st;
}

void sst_fe_free(void* h) { delete (FeState*)h; }

// Batch MFCC: audio [B, N] int16 (row-major), n_samps [B] -> out
// [B, Tmax, ncep] f32, threaded over utterances.
void sst_fe_process_batch(void* h, const int16_t* audio, int B, int64_t N,
                          const int32_t* n_samps, int Tmax, float* out,
                          int nthreads) {
  const FeState& st = *(FeState*)h;
  if (nthreads <= 0) {
    nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
  }
  if (getenv("SST_FE_SCALAR")) {   // reference path for x8 parity tests
    if (nthreads > B) nthreads = B;
    auto work_s = [&](int tid) {
      for (int b = tid; b < B; b += nthreads)
        process_utt(st, audio + (size_t)b * N, n_samps[b], Tmax,
                    out + (size_t)b * Tmax * st.ncep);
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < nthreads; t++) ts.emplace_back(work_s, t);
    work_s(0);
    for (auto& t : ts) t.join();
    return;
  }
  const int ngroups = (B + LANES - 1) / LANES;
  if (nthreads > ngroups) nthreads = ngroups;
  auto work = [&](int tid) {
    for (int gi = tid; gi < ngroups; gi += nthreads) {
      const int16_t* aptr[LANES];
      int32_t nsl[LANES];
      float* optr[LANES];
      for (int l = 0; l < LANES; l++) {
        const int b = gi * LANES + l;
        if (b < B) {
          aptr[l] = audio + (size_t)b * N;
          nsl[l] = n_samps[b];
          optr[l] = out + (size_t)b * Tmax * st.ncep;
        } else {
          aptr[l] = nullptr;
          nsl[l] = 0;
          optr[l] = nullptr;
        }
      }
      process_utt_x8(st, aptr, nsl, Tmax, optr);
    }
  };
  if (nthreads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) ts.emplace_back(work, t);
  for (auto& t : ts) t.join();
}

// Pointer-array variant of the wire-quantized batch: rows come straight
// from the caller's per-utterance buffers (no [B, N] padded copy).
// i16p wire RANGE ASSUMPTION (both variants below): |cep| < 32768/scale
// (< 128 at the default x256 scale) or the int16 clamp saturates
// silently.  True for the legacy transform (C0 = mean log mel <= ~39)
// but NOT for dct/htk C0 = sum(logspec)*sqrt_inv_n, so the aligner
// defaults those transforms to the exact f32 wire (aligner.py).
void sst_fe_process_batch_i16p_ptrs(void* h, const int16_t** audios,
                                    const int32_t* n_samps, int B, int Tmax,
                                    uint8_t* out, float scale,
                                    int nthreads) {
  const FeState& st = *(FeState*)h;
  if (nthreads <= 0) {
    nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
  }
  const int ngroups = (B + LANES - 1) / LANES;
  if (nthreads > ngroups) nthreads = ngroups;
  const size_t plane = (size_t)B * Tmax * st.ncep;
  const size_t per_utt = (size_t)Tmax * st.ncep;
  auto work = [&](int tid) {
    std::vector<float> cep(per_utt * LANES);
    for (int gi = tid; gi < ngroups; gi += nthreads) {
      const int16_t* aptr[LANES];
      int32_t nsl[LANES];
      float* optr[LANES];
      for (int l = 0; l < LANES; l++) {
        const int b = gi * LANES + l;
        if (b < B) {
          aptr[l] = audios[b];
          nsl[l] = n_samps[b];
          optr[l] = cep.data() + per_utt * l;
        } else {
          aptr[l] = nullptr;
          nsl[l] = 0;
          optr[l] = nullptr;
        }
      }
      process_utt_x8(st, aptr, nsl, Tmax, optr);
      for (int l = 0; l < LANES; l++) {
        const int b = gi * LANES + l;
        if (b >= B) break;
        const float* c = cep.data() + per_utt * l;
        uint8_t* lo = out + (size_t)b * per_utt;
        uint8_t* hi = lo + plane;
        for (size_t i = 0; i < per_utt; i++) {
          long v = lrintf(c[i] * scale);
          if (v > 32767) v = 32767;
          if (v < -32768) v = -32768;
          lo[i] = (uint8_t)(v & 0xFF);
          hi[i] = (uint8_t)((v >> 8) & 0xFF);
        }
      }
    }
  };
  if (nthreads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) ts.emplace_back(work, t);
  for (auto& t : ts) t.join();
}

// Batch MFCC quantized for the wire: cepstra are rounded to
// round(c * scale) int16 and emitted as SEPARATE low/high byte planes
// (out [2, B, Tmax, ncep] uint8, plane 0 = low bytes): half the bytes
// of f32 cepstra.  The device reassembles (hi << 8 | lo) / scale, which
// is exact for power-of-two scales.  Quantization (default 1/256
// resolution) is the only loss.
void sst_fe_process_batch_i16p(void* h, const int16_t* audio, int B,
                               int64_t N, const int32_t* n_samps, int Tmax,
                               uint8_t* out, float scale, int nthreads) {
  const FeState& st = *(FeState*)h;
  if (nthreads <= 0) {
    nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
  }
  const int ngroups = (B + LANES - 1) / LANES;
  if (nthreads > ngroups) nthreads = ngroups;
  const size_t plane = (size_t)B * Tmax * st.ncep;
  const size_t per_utt = (size_t)Tmax * st.ncep;
  auto work = [&](int tid) {
    std::vector<float> cep(per_utt * LANES);
    for (int gi = tid; gi < ngroups; gi += nthreads) {
      const int16_t* aptr[LANES];
      int32_t nsl[LANES];
      float* optr[LANES];
      for (int l = 0; l < LANES; l++) {
        const int b = gi * LANES + l;
        if (b < B) {
          aptr[l] = audio + (size_t)b * N;
          nsl[l] = n_samps[b];
          optr[l] = cep.data() + per_utt * l;
        } else {
          aptr[l] = nullptr;
          nsl[l] = 0;
          optr[l] = nullptr;
        }
      }
      process_utt_x8(st, aptr, nsl, Tmax, optr);
      for (int l = 0; l < LANES; l++) {
        const int b = gi * LANES + l;
        if (b >= B) break;
        const float* c = cep.data() + per_utt * l;
        uint8_t* lo = out + (size_t)b * per_utt;
        uint8_t* hi = lo + plane;
        for (size_t i = 0; i < per_utt; i++) {
          long v = lrintf(c[i] * scale);
          if (v > 32767) v = 32767;
          if (v < -32768) v = -32768;
          lo[i] = (uint8_t)(v & 0xFF);
          hi[i] = (uint8_t)((v >> 8) & 0xFF);
        }
      }
    }
  };
  if (nthreads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) ts.emplace_back(work, t);
  for (auto& t : ts) t.join();
}

}  // extern "C"
