// Exact fixed-point YIN pitch estimator (host-native path).
//
// Semantics match the reference yin.c (src/yin.c): the cumulative mean
// normalized difference function is computed in block floating point
// (per-lag dynamic down-shifting of the running difference energy, a
// shared running-cumulative shift, Q15 output), and the frame state
// machine smooths period estimates over a circular window of
// 2*smooth_window+1 frames with a threshold-then-narrowed re-search.
//
// The inner accumulation is inherently sequential in its shift state, so
// the bit-exact path lives here in C++; soundswallower_tpu/yin.py binds
// it via ctypes and also provides a vectorized float JAX path for
// batched device pitch extraction (where bit-parity with the reference's
// Q15 arithmetic is not required).
//
// Build: make -C native  (produces libsst_yin.so)

#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Cumulative mean normalized difference, Q15 (yin.c:69-130).
void cmn_diff(const int16_t *signal, int32_t *out_diff, int ndiff) {
    out_diff[0] = 32768;
    uint32_t cum = 0, cshift = 0;

    int tscale;
    for (tscale = 0; tscale < 32; ++tscale)
        if (ndiff & (1 << (31 - tscale)))
            break;
    --tscale;

    for (int t = 1; t < ndiff; ++t) {
        uint32_t dd = 0, dshift = 0;
        for (int j = 0; j < ndiff; ++j) {
            int diff = (int)signal[j] - (int)signal[t + j];
            if (dd > (1UL << tscale)) {
                dd >>= 1;
                ++dshift;
            }
            dd += (uint32_t)((diff * diff) >> dshift);
        }
        if (dshift > cshift)
            cum += dd << (dshift - cshift);
        else
            cum += dd >> (cshift - dshift);
        while (cum > (1UL << tscale)) {
            cum >>= 1;
            ++cshift;
        }
        if (cum == 0)
            cum = 1;
        uint32_t norm = (uint32_t)(t << tscale) / cum;
        int shift = tscale - 15 + (int)cshift - (int)dshift;
        long long prod = (long long)dd * (long long)norm;
        out_diff[t] = (int32_t)(shift >= 0 ? (prod >> shift) : (prod << -shift));
    }
}

// First lag under threshold, else global argmin (yin.c:174-196).
int thresholded_search(const int32_t *dw, int32_t threshold, int start,
                       int end) {
    int min = INT_MAX, argmin = 0;
    for (int i = start; i < end; ++i) {
        int diff = dw[i];
        if (diff < threshold)
            return i;
        if (diff < min) {
            min = diff;
            argmin = i;
        }
    }
    return argmin;
}

struct Yin {
    uint16_t frame_size;
    uint16_t search_threshold;  // Q15
    uint16_t search_range;      // Q15
    uint16_t nfr;
    uint8_t wsize, wstart, wcur, endut;
    std::vector<std::vector<int32_t>> diff_window;
    std::vector<uint16_t> period_window;
};

}  // namespace

extern "C" {

void *sst_yin_init(int frame_size, float search_threshold, float search_range,
                   int smooth_window) {
    Yin *pe = new Yin();
    pe->frame_size = (uint16_t)frame_size;
    pe->search_threshold = (uint16_t)(search_threshold * 32768);
    pe->search_range = (uint16_t)(search_range * 32768);
    pe->wsize = (uint8_t)(smooth_window * 2 + 1);
    pe->nfr = pe->wstart = pe->wcur = pe->endut = 0;
    pe->diff_window.assign(pe->wsize,
                           std::vector<int32_t>(frame_size / 2, 0));
    pe->period_window.assign(pe->wsize, 0);
    return pe;
}

void sst_yin_free(void *h) { delete (Yin *)h; }

void sst_yin_start(void *h) {
    Yin *pe = (Yin *)h;
    pe->wstart = pe->endut = 0;
    pe->nfr = 0;
}

void sst_yin_end(void *h) { ((Yin *)h)->endut = 1; }

void sst_yin_cmn_diff(const int16_t *signal, int32_t *out, int ndiff) {
    cmn_diff(signal, out, ndiff);
}

// Feed one frame of frame_size samples (yin.c:198-221).
void sst_yin_write(void *h, const int16_t *frame) {
    Yin *pe = (Yin *)h;
    ++pe->wstart;
    int outptr = pe->wstart - 1;
    if (pe->wstart == pe->wsize)
        pe->wstart = 0;
    int difflen = pe->frame_size / 2;
    cmn_diff(frame, pe->diff_window[outptr].data(), difflen);
    pe->period_window[outptr] = (uint16_t)thresholded_search(
        pe->diff_window[outptr].data(), pe->search_threshold, 0, difflen);
    ++pe->nfr;
}

// Smoothed read (yin.c:223-326).  Returns 1 with outputs, 0 if no frame.
int sst_yin_read(void *h, uint16_t *out_period, uint16_t *out_bestdiff) {
    Yin *pe = (Yin *)h;
    int half_wsize = (pe->wsize - 1) / 2;
    if (half_wsize == 0) {
        if (pe->endut)
            return 0;
        *out_period = pe->period_window[0];
        *out_bestdiff = (uint16_t)pe->diff_window[0][pe->period_window[0]];
        return 1;
    }
    if (pe->endut == 0 && pe->nfr < half_wsize + 1)
        return 0;

    int wstart, wlen;
    if (pe->endut) {
        if (pe->wcur == pe->wstart)
            return 0;
        wstart = (pe->wcur + pe->wsize - half_wsize) % pe->wsize;
        wlen = pe->wstart - wstart;
        if (wlen < 0)
            wlen += pe->wsize;
    } else if (pe->nfr < pe->wsize) {
        wstart = 0;
        wlen = pe->nfr;
    } else {
        wstart = pe->wstart;
        wlen = pe->wsize;
    }

    int best = pe->period_window[pe->wcur];
    int best_diff = pe->diff_window[pe->wcur][best];
    for (int i = 0; i < wlen; ++i) {
        int j = (wstart + i) % pe->wsize;
        int diff = pe->diff_window[j][pe->period_window[j]];
        if (diff < best_diff) {
            best_diff = diff;
            best = pe->period_window[j];
        }
    }
    if (best == pe->period_window[pe->wcur]) {
        if (++pe->wcur == pe->wsize)
            pe->wcur = 0;
        *out_period = (uint16_t)best;
        *out_bestdiff = (uint16_t)best_diff;
        return 1;
    }
    int search_width = best * pe->search_range / 32768;
    if (search_width == 0)
        search_width = 1;
    int low_period = best - search_width;
    int high_period = best + search_width;
    if (low_period < 0)
        low_period = 0;
    if (high_period > pe->frame_size / 2)
        high_period = pe->frame_size / 2;
    best = thresholded_search(pe->diff_window[pe->wcur].data(),
                              pe->search_threshold, low_period, high_period);
    best_diff = pe->diff_window[pe->wcur][best];
    if (out_period)
        *out_period = (uint16_t)(best > 32768 ? 32768 : best);
    if (out_bestdiff)
        *out_bestdiff = (uint16_t)(best_diff > 32768 ? 32768 : best_diff);
    if (++pe->wcur == pe->wsize)
        pe->wcur = 0;
    return 1;
}

}  // extern "C"
