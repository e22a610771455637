// Native host-side kernels for the serving path: a copy of
// planer_tpu/native/nms.cpp, and the staging copy of a program's host
// inputs (planer_stage_copy, below).
//
// The card owns the dense compute; these are the *host* hot loops that sit
// between device outputs and the client: greedy NMS over decoded detection
// boxes (O(n^2) with early suppression, called per class per image in the
// YOLO pipeline) and the score/class argmax+threshold filter over the full
// (boxes, classes) score matrix.  Unlike the JAX package's copy, NMS orders
// equal scores by index (a stable sort), as the port's numpy version does.
//
// Built with: g++ -O3 -shared -fPIC nms.cpp -o libnms-<digest>.so
// Loaded via ctypes (planer_tpu_torch.native); no fallback.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <numeric>
#include <vector>
#include <cmath>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

extern "C" {

// boxes: (n, 4) [cx, cy, w, h]; scores: (n,)
// keep: out index buffer (capacity top_k); returns count kept
int64_t planer_nms(const float* boxes, const float* scores, int64_t n,
                   float iou_thresh, int64_t top_k, int64_t* keep) {
    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return scores[a] > scores[b]; });

    std::vector<float> x1(n), y1(n), x2(n), y2(n), area(n);
    for (int64_t i = 0; i < n; ++i) {
        const float* b = boxes + 4 * i;
        x1[i] = b[0] - b[2] * 0.5f;
        y1[i] = b[1] - b[3] * 0.5f;
        x2[i] = b[0] + b[2] * 0.5f;
        y2[i] = b[1] + b[3] * 0.5f;
        area[i] = (x2[i] - x1[i]) * (y2[i] - y1[i]);
    }

    std::vector<char> suppressed(n, 0);
    int64_t kept = 0;
    for (int64_t oi = 0; oi < n && kept < top_k; ++oi) {
        int64_t i = order[oi];
        if (suppressed[i]) continue;
        keep[kept++] = i;
        for (int64_t oj = oi + 1; oj < n; ++oj) {
            int64_t j = order[oj];
            if (suppressed[j]) continue;
            float xx1 = std::max(x1[i], x1[j]);
            float yy1 = std::max(y1[i], y1[j]);
            float xx2 = std::min(x2[i], x2[j]);
            float yy2 = std::min(y2[i], y2[j]);
            float w = std::max(0.0f, xx2 - xx1);
            float h = std::max(0.0f, yy2 - yy1);
            float inter = w * h;
            float iou = inter / (area[i] + area[j] - inter + 1e-9f);
            if (iou > iou_thresh) suppressed[j] = 1;
        }
    }
    return kept;
}

// dec: (n, 5 + c) decoded rows [cx, cy, w, h, obj, cls...]
// out_idx/out_cls/out_score: capacity n. Returns count passing threshold,
// where score = obj * max(cls) and cls id = argmax(cls).
int64_t planer_score_filter(const float* dec, int64_t n, int64_t c,
                            float conf_thresh, int64_t* out_idx,
                            int64_t* out_cls, float* out_score) {
    int64_t m = 0;
    const int64_t stride = 5 + c;
    for (int64_t i = 0; i < n; ++i) {
        const float* row = dec + i * stride;
        float obj = row[4];
        if (obj < conf_thresh) continue;  // score = obj*maxcls <= obj
        float best = -1.0f;
        int64_t bi = 0;
        for (int64_t k = 0; k < c; ++k) {
            if (row[5 + k] > best) { best = row[5 + k]; bi = k; }
        }
        float score = obj * best;
        if (score >= conf_thresh) {
            out_idx[m] = i;
            out_cls[m] = bi;
            out_score[m] = score;
            ++m;
        }
    }
    return m;
}


// n bytes from src into dst, the pinned buffer a program stages a host
// input through (runtime/program.py).  The card's copy engine is the only
// reader of dst, so its lines are written around the cache (non-temporal
// stores, fenced before the copy is enqueued): no line is read for
// ownership first.  The source is read 1 KB ahead.
void planer_stage_copy(void* dst, const void* src, int64_t n) {
    char* d = static_cast<char*>(dst);
    const char* s = static_cast<const char*>(src);
    int64_t i = 0;
#if defined(__SSE2__)
    i = std::min<int64_t>(n, -reinterpret_cast<intptr_t>(d) & 63);
    std::memcpy(d, s, i);
    for (; i + 64 <= n; i += 64) {
        if (i + 1024 < n) __builtin_prefetch(s + i + 1024);
        const __m128i* from = reinterpret_cast<const __m128i*>(s + i);
        __m128i* to = reinterpret_cast<__m128i*>(d + i);
        __m128i a = _mm_loadu_si128(from), b = _mm_loadu_si128(from + 1);
        __m128i c = _mm_loadu_si128(from + 2), e = _mm_loadu_si128(from + 3);
        _mm_stream_si128(to, a);
        _mm_stream_si128(to + 1, b);
        _mm_stream_si128(to + 2, c);
        _mm_stream_si128(to + 3, e);
    }
    _mm_sfence();
#endif
    std::memcpy(d + i, s + i, n - i);
}

}  // extern "C"
