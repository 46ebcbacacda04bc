// Host window framer of the port's channelizers (see native.py).
//
// One pass from the carried history and the block to the packed [2M, K]
// upload buffer: row m holds the window ext[m*D : m*D + K] of
// ext = [history(nh) | x], rows [0, M) the real parts and [M, 2M) the
// imaginary parts.  The integer forms multiply by `scale`, round half to
// even and saturate, as numpy's rint and clip do, with NaN giving 0 as
// numpy's cast does; the float32 form copies the bits.  With K == D the
// windows tile ext, so each plane is one contiguous run; otherwise each
// row copies its window.
//
// Plain C interface, bound with ctypes.  Build without -ffast-math or
// -Ofast: those link startup code that sets flush-to-zero for the whole
// process.

#include <cmath>
#include <cstdint>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

template <class T, int LO, int HI>
struct Quant {
    float scale;

    T one(float v) const {
        v *= scale;
        if (v != v) return 0;
        v = v < (float)LO ? (float)LO : v;
        v = v > (float)HI ? (float)HI : v;
        return (T)(int32_t)std::nearbyint(v);
    }

#if defined(__AVX2__)
    // 8 values scaled, NaN to 0, clamped, rounded half to even (the
    // default MXCSR mode) to int32
    __m256i eight(__m256 v) const {
        v = _mm256_mul_ps(v, _mm256_set1_ps(scale));
        v = _mm256_and_ps(v, _mm256_cmp_ps(v, v, _CMP_ORD_Q));
        v = _mm256_max_ps(v, _mm256_set1_ps((float)LO));
        v = _mm256_min_ps(v, _mm256_set1_ps((float)HI));
        return _mm256_cvtps_epi32(v);
    }
#endif
};

using QuantI16 = Quant<int16_t, -32768, 32767>;
using QuantI8 = Quant<int8_t, -128, 127>;

struct Copy {
    float one(float v) const { return v; }
};

#if defined(__AVX2__)
// 8 interleaved pairs (two loads) → 8 real parts, 8 imaginary parts
inline void split8(const float* s, __m256& re, __m256& im) {
    const __m256i idx = _mm256_setr_epi32(0, 2, 4, 6, 1, 3, 5, 7);
    __m256 a = _mm256_permutevar8x32_ps(_mm256_loadu_ps(s), idx);
    __m256 b = _mm256_permutevar8x32_ps(_mm256_loadu_ps(s + 8), idx);
    re = _mm256_permute2f128_ps(a, b, 0x20);
    im = _mm256_permute2f128_ps(a, b, 0x31);
}

// 16 int32 → 16 int16 in order (the values already in range)
inline __m256i pack16(__m256i lo, __m256i hi) {
    return _mm256_permute4x64_epi64(_mm256_packs_epi32(lo, hi), 0xD8);
}

inline int64_t vec_run(const float* s, int64_t n, int16_t* re, int16_t* im,
                       const QuantI16& q) {
    int64_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m256 r0, i0, r1, i1;
        split8(s + 2 * i, r0, i0);
        split8(s + 2 * i + 16, r1, i1);
        _mm256_storeu_si256((__m256i*)(re + i),
                            pack16(q.eight(r0), q.eight(r1)));
        _mm256_storeu_si256((__m256i*)(im + i),
                            pack16(q.eight(i0), q.eight(i1)));
    }
    return i;
}

inline int64_t vec_run(const float* s, int64_t n, int8_t* re, int8_t* im,
                       const QuantI8& q) {
    int64_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m256 r0, i0, r1, i1;
        split8(s + 2 * i, r0, i0);
        split8(s + 2 * i + 16, r1, i1);
        __m256i wr = pack16(q.eight(r0), q.eight(r1));
        __m256i wi = pack16(q.eight(i0), q.eight(i1));
        _mm_storeu_si128((__m128i*)(re + i),
                         _mm_packs_epi16(_mm256_castsi256_si128(wr),
                                         _mm256_extracti128_si256(wr, 1)));
        _mm_storeu_si128((__m128i*)(im + i),
                         _mm_packs_epi16(_mm256_castsi256_si128(wi),
                                         _mm256_extracti128_si256(wi, 1)));
    }
    return i;
}

inline int64_t vec_run(const float* s, int64_t n, float* re, float* im,
                       const Copy&) {
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        __m256 r, m;
        split8(s + 2 * i, r, m);
        _mm256_storeu_ps(re + i, r);
        _mm256_storeu_ps(im + i, m);
    }
    return i;
}
#else
template <class T, class Q>
inline int64_t vec_run(const float*, int64_t, T*, T*, const Q&) {
    return 0;
}
#endif

// n interleaved pairs from s → re[0, n), im[0, n)
template <class T, class Q>
void run(const float* s, int64_t n, T* re, T* im, const Q& q) {
    if (n <= 0) return;
    for (int64_t i = vec_run(s, n, re, im, q); i < n; ++i) {
        re[i] = q.one(s[2 * i]);
        im[i] = q.one(s[2 * i + 1]);
    }
}

template <class T, class Q>
void frame(const float* h, int64_t nh, const float* x, T* out, int64_t m,
           int64_t k, int64_t d, const Q& q) {
    T* re = out;
    T* im = out + m * k;
    if (k == d) {
        const int64_t n = m * k;
        const int64_t a = nh < n ? nh : n;
        run(h, a, re, im, q);
        run(x, n - a, re + a, im + a, q);
        return;
    }
    for (int64_t row = 0; row < m; ++row) {
        const int64_t s = row * d;
        int64_t a = nh - s;
        a = a < 0 ? 0 : (a > k ? k : a);
        const int64_t off = s > nh ? s - nh : 0;
        if (a > 0) run(h + 2 * s, a, re + row * k, im + row * k, q);
        run(x + 2 * off, k - a, re + row * k + a, im + row * k + a, q);
    }
}

}  // namespace

extern "C" {

// h: nh history pairs, x: the block's pairs; out: [2M, K]; the caller
// checks nh + len(x) >= (M-1)*D + K
void sd_frame_f32(const float* h, int64_t nh, const float* x, float* out,
                  int64_t m, int64_t k, int64_t d) {
    frame(h, nh, x, out, m, k, d, Copy{});
}

void sd_frame_i16(const float* h, int64_t nh, const float* x, int16_t* out,
                  int64_t m, int64_t k, int64_t d, float scale) {
    frame(h, nh, x, out, m, k, d, QuantI16{scale});
}

void sd_frame_i8(const float* h, int64_t nh, const float* x, int8_t* out,
                 int64_t m, int64_t k, int64_t d, float scale) {
    frame(h, nh, x, out, m, k, d, QuantI8{scale});
}

}  // extern "C"
