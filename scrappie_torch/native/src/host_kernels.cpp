// Host loops of scrappie_torch, in C++.
//
// Counterpart of scrappie_tpu/native/src/host_kernels.cpp: the same four
// extern "C" functions, with the same arithmetic in the same order, so
// that each equals its Python twin bit for bit (signal/events.py:
// compute_sum_sumsq, compute_tstat, _peak_detector_python;
// post/homopolymer.py: dwell_corrected_overlapper_python,
// find_runs_python). The card runs the networks and decoders; these are
// the sequential per-read loops around them:
//   * stpu_detect_tstat: cumulative sums and both windowed t-statistics
//     of event detection (ref src/event_detection.c:35-115);
//   * stpu_peak_detector: its two-scale peak state machine
//     (ref src/event_detection.c:122-198);
//   * stpu_dwell_overlapper: the dwell-corrected homopolymer overlapper
//     (ref src/decode.c:516-643);
//   * stpu_find_runs: the ambiguous homopolymer runs of a transducer path
//     (ref src/homopolymer.c:67-157).
//
// Unlike the JAX package's copy, every function that writes an output of
// data-dependent length takes its capacity and returns STPU_OVERFLOW
// rather than write past it; the dwell overlapper reads its dwell as
// double (the port's event lengths are float64).
//
// Built as a plain shared library by native/build.py (g++, with
// -ffp-contract=off) and bound with ctypes by native/bindings.py.

#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

// Returned when an output would exceed the capacity the caller gave.
static const int64_t STPU_OVERFLOW = -2;

// ---------------------------------------------------------------- peaks

struct Detector {
    const float* signal;
    float threshold;
    int64_t window;
    int64_t masked_to;
    int64_t peak_pos;
    float peak_value;
    bool valid;
};

// Two-scale t-statistic peak detection. Writes the detected peak
// positions (in firing order) into out_peaks, which holds capacity
// entries, and returns their count.
int64_t stpu_peak_detector(const float* tstat1, const float* tstat2,
                           int64_t nsample, float threshold1, float threshold2,
                           int64_t window1, int64_t window2, float peak_height,
                           int64_t* out_peaks, int64_t capacity) {
    const float FLOATMAX = std::numeric_limits<float>::max();
    Detector dets[2] = {
        {tstat1, threshold1, window1, 0, -1, FLOATMAX, false},
        {tstat2, threshold2, window2, 0, -1, FLOATMAX, false},
    };
    int64_t count = 0;
    for (int64_t i = 0; i < nsample; ++i) {
        for (int k = 0; k < 2; ++k) {
            Detector& d = dets[k];
            if (d.masked_to >= i) continue;
            const float current = d.signal[i];
            if (d.peak_pos == -1) {
                if (current < d.peak_value) {
                    d.peak_value = current;
                } else if (current - d.peak_value > peak_height) {
                    d.peak_value = current;
                    d.peak_pos = i;
                }
            } else {
                if (current > d.peak_value) {
                    d.peak_value = current;
                    d.peak_pos = i;
                }
                if (k == 0 && d.peak_value > d.threshold) {
                    dets[1].masked_to = d.peak_pos + d.window;
                    dets[1].peak_pos = -1;
                    dets[1].peak_value = FLOATMAX;
                    dets[1].valid = false;
                }
                if (d.peak_value - current > peak_height &&
                    d.peak_value > d.threshold) {
                    d.valid = true;
                }
                if (d.valid && (i - d.peak_pos) > d.window / 2) {
                    if (count == capacity) return STPU_OVERFLOW;
                    out_peaks[count++] = d.peak_pos;
                    d.peak_pos = -1;
                    d.peak_value = current;
                    d.valid = false;
                }
            }
        }
    }
    return count;
}

// ----------------------------------------------------------- t-stat

// One-pass event-detection statistics: float64 cumulative sum and sum of
// squares (element i excludes i) and both windowed two-sample
// t-statistics. The numpy twin's accumulation order and float32 cast
// points are kept, so the results are bit for bit the twin's; this walks
// the arrays twice where numpy walks them about twelve times. sums and
// sumsqs hold n+1 doubles; tstat1 and tstat2 hold n floats.
static void tstat_one(const double* sums, const double* sumsqs, int64_t n,
                      int64_t w, float* tstat) {
    for (int64_t i = 0; i < n; ++i) tstat[i] = 0.0f;
    if (n < 2 * w || w < 2) return;
    const float wf = (float)w;
    const double wd = (double)wf;
    for (int64_t i = w; i <= n - w; ++i) {
        const double sum1 = sums[i] - (i > w ? sums[i - w] : 0.0);
        const double sumsq1 = sumsqs[i] - (i > w ? sumsqs[i - w] : 0.0);
        const float sum2 = (float)(sums[i + w] - sums[i]);
        const float sumsq2 = (float)(sumsqs[i + w] - sumsqs[i]);
        const float mean1 = (float)(sum1 / wd);
        const float mean2 = sum2 / wf;
        // float arithmetic, left to right, as the numpy expression
        // evaluates it
        float cv = (float)sumsq1 / wf;
        cv = cv - mean1 * mean1;
        cv = cv + sumsq2 / wf;
        cv = cv - mean2 * mean2;
        const float tiny = std::numeric_limits<float>::min();
        if (cv < tiny) cv = tiny;
        const float delta = mean2 - mean1;
        tstat[i] = std::fabs(delta) / std::sqrt(cv / wf);
    }
}

int64_t stpu_detect_tstat(const float* data, int64_t n, int64_t w1,
                          int64_t w2, double* sums, double* sumsqs,
                          float* tstat1, float* tstat2) {
    sums[0] = 0.0;
    sumsqs[0] = 0.0;
    double s = 0.0, ss = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const double d = (double)data[i];
        s += d;
        ss += d * d;
        sums[i + 1] = s;
        sumsqs[i + 1] = ss;
    }
    tstat_one(sums, sumsqs, n, w1, tstat1);
    tstat_one(sums, sumsqs, n, w2, tstat2);
    return 0;
}

// ----------------------------------------------------- dwell overlapper

static inline int overlap_len(int64_t k1, int64_t k2, int klen) {
    int64_t mask = (int64_t(1) << (2 * klen)) - 1;
    int o = 0;
    do {
        mask >>= 2;
        k1 &= mask;
        k2 >>= 2;
        ++o;
    } while (k1 != k2);
    return o;
}

static inline bool is_homopolymer(int64_t kmer, int klen) {
    const int64_t b = kmer & 3;
    for (int j = 1; j < klen; ++j) {
        kmer >>= 2;
        if ((kmer & 3) != b) return false;
    }
    return true;
}

// Appends n copies of base to out[len...], or returns false if that would
// pass capacity.
static inline bool emit_run(char* out, int64_t& len, int64_t capacity,
                            char base, int64_t n) {
    if (n <= 0) return true;
    if (n > capacity - len) return false;
    for (int64_t j = 0; j < n; ++j) out[len++] = base;
    return true;
}

// Dwell-corrected kmer-path stitching. path: n entries, negative = stay;
// dwell: each entry's event dwell. Writes the basecall into out, which
// holds capacity chars, and returns its length; -1 when the path is all
// stays, STPU_OVERFLOW when the basecall would not fit.
int64_t stpu_dwell_overlapper(const int32_t* path, const double* dwell,
                              int64_t n, int klen, double scale,
                              const double* base_adj, char* out,
                              int64_t capacity) {
    static const char BASES[4] = {'A', 'C', 'G', 'T'};
    int64_t st = 0;
    while (st < n && path[st] < 0) ++st;
    if (st == n) return -1;
    if (capacity < klen) return STPU_OVERFLOW;

    int64_t len = 0;
    int64_t first = path[st];
    for (int j = klen - 1; j >= 0; --j)
        out[len++] = BASES[(first >> (2 * j)) & 3];

    int64_t kprev = first;
    int64_t inhomo = -1;
    double hdwell = 0.0;
    for (int64_t k = st + 1; k < n; ++k) {
        const int64_t s = path[k];
        if (s < 0) {
            if (inhomo >= 0) hdwell += dwell[k];
            continue;
        }
        if (s == inhomo) {
            hdwell += dwell[k];
            continue;
        }
        if (inhomo >= 0) {
            const int64_t hlen =
                llround((hdwell - base_adj[inhomo & 3]) / scale);
            if (!emit_run(out, len, capacity, BASES[inhomo & 3], hlen))
                return STPU_OVERFLOW;
            inhomo = -1;
            hdwell = 0.0;
        }
        const int o = overlap_len(kprev, s, klen);
        if (o > capacity - len) return STPU_OVERFLOW;
        for (int j = o - 1; j >= 0; --j) out[len++] = BASES[(s >> (2 * j)) & 3];
        kprev = s;
        if (is_homopolymer(kprev, klen)) {
            inhomo = kprev;
            hdwell += dwell[k];
        }
    }
    if (inhomo >= 0) {
        const int64_t hlen = llround((hdwell - base_adj[inhomo & 3]) / scale);
        if (!emit_run(out, len, capacity, BASES[inhomo & 3], hlen))
            return STPU_OVERFLOW;
    }
    return len;
}

// --------------------------------------------------- homopolymer runs

// The ambiguous homopolymer run segments of a transducer Viterbi path.
// Each run is (start, length, base), written to the three arrays, which
// hold capacity entries each; returns the run count.
int64_t stpu_find_runs(const int32_t* path, int64_t n, int klen,
                       int64_t* starts, int64_t* lengths, int64_t* bases,
                       int64_t capacity) {
    const int64_t fkm1 = int64_t(1) << (2 * (klen - 1));
    const int64_t fkm2 = int64_t(1) << (2 * (klen - 2));
    int64_t count = 0;
    for (int base = 0; base < 4; ++base) {
        int64_t repk = 0, repkm1 = 0, repkm2 = 0;
        for (int j = 0; j < klen; ++j) repk = repk * 4 + base;
        for (int j = 0; j < klen - 1; ++j) repkm1 = repkm1 * 4 + base;
        for (int j = 0; j < klen - 2; ++j) repkm2 = repkm2 * 4 + base;
        for (int64_t i = 1; i < n - 2; ++i) {
            const int64_t p = path[i - 1];
            const int64_t q = path[i];
            if (p >= 0 && (p % fkm1) == repkm1 && p != repk &&
                (q == -1 || q == repk)) {
                int64_t e = i + 1;
                while (e < n && (path[e] == -1 || path[e] == repk)) ++e;
                if (count == capacity) return STPU_OVERFLOW;
                starts[count] = i;
                lengths[count] = e - i;
                bases[count] = base;
                ++count;
            }
            if (p >= 0 && (p % fkm2) == repkm2 && (p % fkm1) != repkm1 &&
                (q == -1 || q == repk)) {
                int64_t j = i;
                while (j < n && path[j] == -1) ++j;
                if (j < n - 1 && path[j] == repk) {
                    int64_t e = j + 1;
                    while (e < n && (path[e] == -1 || path[e] == repk)) ++e;
                    if (count == capacity) return STPU_OVERFLOW;
                    starts[count] = j;
                    lengths[count] = e - j;
                    bases[count] = base;
                    ++count;
                }
            }
        }
    }
    return count;
}

}  // extern "C"
