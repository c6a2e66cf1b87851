// Native audio I/O + batch assembly for soundswallower_tpu.
//
// The device decode path wants large, padded, contiguous float32 batches; the
// host side of that (WAV parsing, int16 -> float32 sample-value scaling,
// padding/packing, simple ring buffering for streaming) is implemented here
// in C++ and exposed through a C ABI consumed via ctypes
// (soundswallower_tpu/utils/native_io.py).  This replaces the reference's
// C-side audio plumbing (fe_interface.c int16/float32 ingest paths and the
// Python binding's WAV handling) with a batch-oriented native runtime
// component.
//
// Build: make -C native  (produces libsst_io.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV parsing (RIFF PCM16 mono), mirroring the tolerant behavior of
// py/soundswallower/__init__.py get_audio_data: non-WAV files are treated
// as raw int16.
// ---------------------------------------------------------------------------

struct SstAudio {
    int16_t *samples;
    int64_t n_samples;
    int32_t sample_rate;  // 0 for raw files (caller decides)
};

static bool read_file(const char *path, std::vector<uint8_t> &out) {
    FILE *fh = fopen(path, "rb");
    if (!fh)
        return false;
    fseek(fh, 0, SEEK_END);
    long len = ftell(fh);
    fseek(fh, 0, SEEK_SET);
    out.resize(len);
    size_t rv = fread(out.data(), 1, len, fh);
    fclose(fh);
    return rv == (size_t)len;
}

static uint32_t rd_u32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t *p) {
    return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Returns NULL on I/O error.  For valid RIFF/WAVE mono PCM16 the samples
// and rate come from the data/fmt chunks; anything else is raw int16 with
// sample_rate = 0.
SstAudio *sst_audio_read(const char *path) {
    std::vector<uint8_t> data;
    if (!read_file(path, data))
        return nullptr;
    SstAudio *a = new SstAudio{nullptr, 0, 0};
    const uint8_t *p = data.data();
    size_t n = data.size();
    bool is_wav = n >= 44 && !memcmp(p, "RIFF", 4) && !memcmp(p + 8, "WAVE", 4);
    if (is_wav) {
        size_t off = 12;
        int32_t rate = 0;
        uint16_t channels = 1, bits = 16, fmt = 1;
        const uint8_t *dptr = nullptr;
        size_t dlen = 0;
        while (off + 8 <= n) {
            uint32_t cklen = rd_u32(p + off + 4);
            if (!memcmp(p + off, "fmt ", 4) && off + 8 + 16 <= n) {
                fmt = rd_u16(p + off + 8);
                channels = rd_u16(p + off + 10);
                rate = (int32_t)rd_u32(p + off + 12);
                bits = rd_u16(p + off + 22);
            } else if (!memcmp(p + off, "data", 4)) {
                dptr = p + off + 8;
                dlen = cklen;
                if (dptr + dlen > p + n)
                    dlen = p + n - dptr;
            }
            off += 8 + cklen + (cklen & 1);
        }
        if (dptr && fmt == 1 && channels == 1 && bits == 16) {
            a->n_samples = dlen / 2;
            a->samples = new int16_t[a->n_samples];
            memcpy(a->samples, dptr, a->n_samples * 2);
            a->sample_rate = rate;
            return a;
        }
        // Fall through: treat as raw (matches the reference's permissive
        // loader only for actual wave.Error cases; mono PCM16 enforced).
    }
    a->n_samples = n / 2;
    a->samples = new int16_t[a->n_samples];
    memcpy(a->samples, p, a->n_samples * 2);
    a->sample_rate = 0;
    return a;
}

int64_t sst_audio_n_samples(SstAudio *a) { return a->n_samples; }
int32_t sst_audio_sample_rate(SstAudio *a) { return a->sample_rate; }
const int16_t *sst_audio_samples(SstAudio *a) { return a->samples; }

void sst_audio_free(SstAudio *a) {
    if (a) {
        delete[] a->samples;
        delete a;
    }
}

// ---------------------------------------------------------------------------
// Batch assembly: pack n utterances of int16 audio into one padded
// float32 [n, max_len] buffer with fe-compatible sample-value scaling
// (int16 value as float, fe_read_frame_int16 semantics).  Multi-threaded
// callers pass a preallocated output.
// ---------------------------------------------------------------------------

void sst_pack_batch_f32(const int16_t **utts, const int64_t *lens,
                        int32_t n, int64_t max_len, float *out) {
    for (int32_t i = 0; i < n; ++i) {
        const int16_t *src = utts[i];
        float *dst = out + (int64_t)i * max_len;
        int64_t len = lens[i] < max_len ? lens[i] : max_len;
        int64_t j = 0;
        for (; j < len; ++j)
            dst[j] = (float)src[j];
        for (; j < max_len; ++j)
            dst[j] = 0.0f;
    }
}

// ---------------------------------------------------------------------------
// Streaming ring buffer of int16 samples (endpointer/live-decode front
// door; ep_push/ep_pop-style semantics over raw samples).
// ---------------------------------------------------------------------------

struct SstRing {
    std::vector<int16_t> buf;
    int64_t head = 0, count = 0;
};

SstRing *sst_ring_new(int64_t capacity) {
    SstRing *r = new SstRing;
    r->buf.resize(capacity);
    return r;
}

int64_t sst_ring_write(SstRing *r, const int16_t *data, int64_t n) {
    int64_t cap = (int64_t)r->buf.size();
    int64_t space = cap - r->count;
    if (n > space)
        n = space;
    for (int64_t i = 0; i < n; ++i)
        r->buf[(r->head + r->count + i) % cap] = data[i];
    r->count += n;
    return n;
}

int64_t sst_ring_read(SstRing *r, int16_t *out, int64_t n) {
    int64_t cap = (int64_t)r->buf.size();
    if (n > r->count)
        n = r->count;
    for (int64_t i = 0; i < n; ++i)
        out[i] = r->buf[(r->head + i) % cap];
    r->head = (r->head + n) % cap;
    r->count -= n;
    return n;
}

int64_t sst_ring_count(SstRing *r) { return r->count; }

void sst_ring_free(SstRing *r) { delete r; }

}  // extern "C"
