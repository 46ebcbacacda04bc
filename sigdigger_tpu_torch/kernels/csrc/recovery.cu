// Unified PSK/FSK/ASK recovery bank, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/recovery.py::
// _recovery_kernel.  Nothing couples the channel lanes, and each lane
// is sequential in time; the TPU kernel's time tiles only carry state
// from one grid step to the next, so here one launch walks the whole
// block.  Per lane, three stages run in time order:
//
//   front     carrier loop with the order-blended detector (Im u, u²,
//             u⁴, u⁸), FSK quadrature or phase detector, ASK coherent
//             or envelope with DC tracking -> the detector output ext
//   MF        per-channel matched filter over ext (after the carried
//             K-1 row tail), taps summed in the reference's order
//             t = 0..K-1 -> mf
//   Gardner   Gardner TED with per-lane gains and period bounds, the
//             fused symbol-rate CMA equalizer and the clock.running gate
//             -> symbols re/im and strobes [M, C]
//
// Bound: latency.  The carrier loop and the Gardner clock each feed
// back every sample, so a lane is two chains of M dependent steps
// through IEEE division and square root, cos/sin and rsqrt; the bytes
// (the y planes in, symbol and strobe planes out) are a small part.
//
// Design: one launch, blocks of LANES lanes and five warps, each warp
// with one role, handing chunks of T rows to each other through shared
// memory:
//   warp 0 (front)    walks the carrier loop of its lanes over chunk s
//                     and writes ext into a shared-memory buffer;
//   warps 2-3 (helpers) load chunk s+1 of the y planes from HBM and
//                     compute its input-only FSK detector fv (the
//                     quadrature and phase atan2s, the same operations
//                     the front end ran before), run the matched filter
//                     of chunk s-1 over its ext buffer and the K-1 row
//                     tail, and carry that tail to the next buffer;
//   warp 1 (clock)    walks the Gardner clock over chunk s-2, writes the
//                     strobe plane and queues each strobe's interpolant;
//   warp 4 (CMA)      runs the equalizer over chunk s-3's strobes and
//                     writes their symbols.  The CMA's taps and delay
//                     line change at strobes only (between them the
//                     plain version adds 0 and subtracts 0·x, and emits
//                     0), so it takes one step a strobe, not one a row.
// Each super-step ends in one block barrier, so the chains overlap: a
// block takes about its slowest chain over M rows plus three chunks of
// fill, and ext and mf never reach HBM.  The matched filter skips the
// trailing taps that are zero on every lane of the block (the psk
// receiver's 49 of 64): adding an exact zero product changes no finite
// sum.
//
// Shared memory (floats), L = LANES, ER = K - 1 + T rows of ext:
//   y     2 x T x L float2      double-buffered input chunks
//   mf    2 x T x L float2      double-buffered matched-filter output
//   ext   2 x ER x L float2     tail + chunk, double-buffered
//   sq    2 x T x L float2      strobe interpolants, with their rows
//                               (2 x T x L int) and counts (2 x L int)
//   fv    2 x T x L             input-only FSK detector
//   taps  K x L                 the block's matched-filter taps
// about 100 KiB at K = 64 (recovery.py::recovery_smem_bytes mirrors it).
//
// The state rows keep the reference's layout (recovery.py:98-102):
// 0 lo_re, 1 lo_im, 2 freq, 3-4 qprev, 5 dc, 6 t, 7 period, 8-9 gprev,
// 10-11 mid, 12-13 strobe, 14 want_mid, 15 power, 16.. the MF tails re
// then im (K-1 rows each), then the EQ taps re, taps im, delay line re,
// delay line im (Keq rows each).  The parameter rows are
// recovery.py::PARAM_ROWS.
//
// Precision: the loops feed back, so one-ulp differences can grow.  The
// arithmetic follows the plain PyTorch version operation by operation
// (same order, IEEE division and sqrt, cosf/sinf, rsqrtf), and this
// file is built with -fmad=false so that no multiply and add contract
// into an FMA the plain version's separate operations do not make: the
// kernel equals sigdigger_tpu_torch/kernels/recovery.py::
// recovery_kernel_reference bit for bit (an output the plain version
// forms as 0·x may differ in the sign of that zero).
//
// sd_recovery_chain times the carrier loop, the clock and the CMA alone
// with clock64() (inputs from shared memory, one warp at a time): the
// cycles a dependent step takes, and so the kernel's latency floor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ops.cuh"

namespace {

constexpr int LANES = 16;              // lanes per block
constexpr int T = 64;                  // rows per chunk
constexpr int HELPERS = 64;            // threads of warps 2-3
constexpr int THREADS = 96 + HELPERS;  // front, clock, helpers, CMA
constexpr int NG = HELPERS / LANES;    // helper row groups
constexpr int RT = 8;                  // MF rows per helper pass
constexpr int ROWS_PER_HELPER = T / NG;
constexpr int MAX_SMEM = 232448;       // a block's dynamic shared memory

// parameter rows (recovery.py::PARAM_ROWS)
enum {
    P_PSK, P_FSK, P_ASK, P_W1, P_W2, P_W4, P_W8, P_ALPHA, P_BETA, P_GP,
    P_GF, P_PMIN, P_PMAX, P_FSK_COS, P_FSK_SIN, P_QUAD, P_COH, P_RUN,
    P_EQ_EN, P_EQ_RATE, N_PARAMS
};

__host__ __device__ constexpr int smem_floats(int K) {
    return 2 * T * LANES * 2 + 2 * T * LANES * 2 +
           2 * (K - 1 + T) * LANES * 2 + 2 * T * LANES + K * LANES +
           2 * T * LANES * 3 + 2 * LANES;
}

__host__ __device__ constexpr size_t smem_bytes(int K) {
    return static_cast<size_t>(smem_floats(K)) * 4 + 16;
}

// the block barrier of the super-steps, and the helpers' own; named
// barriers count threads, so each role may reach them from its own code
__device__ __forceinline__ void block_sync() {
    asm volatile("bar.sync 0, %0;" ::"n"(THREADS) : "memory");
}
__device__ __forceinline__ void helper_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(HELPERS) : "memory");
}

struct Smem {
    float2* y;    // [2][T][LANES]
    float2* mf;   // [2][T][LANES]
    float2* ext;  // [2][ER][LANES]
    float2* sq;   // [2][T][LANES] a chunk's strobe interpolants, in order
    float* fv;    // [2][T][LANES]
    float* taps;  // [K][LANES]
    int* srow;    // [2][T][LANES] their rows in the chunk
    int* scount;  // [2][LANES] strobes of each lane in the chunk
    int* keff;
    int er;

    __device__ Smem(float* base, int K) : er(K - 1 + T) {
        y = reinterpret_cast<float2*>(base);
        mf = y + 2 * T * LANES;
        ext = mf + 2 * T * LANES;
        sq = ext + 2 * er * LANES;
        fv = reinterpret_cast<float*>(sq + 2 * T * LANES);
        taps = fv + 2 * T * LANES;
        srow = reinterpret_cast<int*>(taps + K * LANES);
        scount = srow + 2 * T * LANES;
        keff = reinterpret_cast<int*>(base + smem_floats(K));
    }
    __device__ float2& Y(int b, int i, int l) {
        return y[(b * T + i) * LANES + l];
    }
    __device__ float2& MF(int b, int i, int l) {
        return mf[(b * T + i) * LANES + l];
    }
    __device__ float2& EX(int b, int r, int l) {
        return ext[(b * er + r) * LANES + l];
    }
    __device__ float& FV(int b, int i, int l) {
        return fv[(b * T + i) * LANES + l];
    }
    __device__ float2& SQ(int b, int k, int l) {
        return sq[(b * T + k) * LANES + l];
    }
    __device__ int& SROW(int b, int k, int l) {
        return srow[(b * T + k) * LANES + l];
    }
};

struct FrontParams {
    float wp, wf, wa, o1, o2, o4, o8, al, be, wc;
};

struct FrontState {
    float lo_re, lo_im, freq, dc;
};

// One carrier-loop step: the plain version's pass 1 without the FSK
// detector (fv, computed from the input alone).  Returns ext re/im.
__device__ __forceinline__ float2 front_step(FrontState& st,
                                             const FrontParams& P, float xr,
                                             float xi, float fv, float adc,
                                             float one_m_adc) {
    // carrier derotation (identity for untracked lanes)
    const float rr = xr * st.lo_re + xi * st.lo_im;
    const float ri = xi * st.lo_re - xr * st.lo_im;
    const float mag = fmaxf(sqrtf(rr * rr + ri * ri), 1e-12f);
    const float ur = rr / mag;
    const float ui = ri / mag;
    const float u2r = ur * ur - ui * ui;
    const float u2i = 2.0f * ur * ui;
    const float u4r = u2r * u2r - u2i * u2i;
    const float u4i = 2.0f * u2r * u2i;
    const float u8i = 2.0f * u4r * u4i;
    const float err = P.o1 * ui + P.o2 * u2i * 0.5f + P.o4 * u4i * 0.25f +
                      P.o8 * u8i * 0.125f;
    st.freq = st.freq + P.be * err;
    const float w = st.freq + P.al * err;
    const float cw = cosf(w);
    const float sw = sinf(w);
    const float nr = st.lo_re * cw - st.lo_im * sw;
    const float ni = st.lo_re * sw + st.lo_im * cw;
    const float inv = rsqrtf(nr * nr + ni * ni);
    // ASK: coherent Re{} or envelope, DC-tracked
    const float avs = P.wc * rr + (1.0f - P.wc) * mag;
    st.dc = adc * st.dc + one_m_adc * avs;
    const float av = avs - st.dc;
    st.lo_re = nr * inv;
    st.lo_im = ni * inv;
    return make_float2(P.wp * rr + P.wf * fv + P.wa * av, P.wp * ri);
}

// The input-only FSK detector of one sample: quadrature discriminator
// against the previous sample, or the rotated instantaneous phase.
__device__ __forceinline__ float fsk_detector(float xr, float xi, float qpr,
                                              float qpi, float fc, float fs,
                                              float wq) {
    const float inv_pi = static_cast<float>(1.0 / 3.141592653589793);
    const float dr = xr * qpr + xi * qpi;
    const float di = xi * qpr - xr * qpi;
    const float fq = sd_atan2(di, dr);
    const float xr2 = xr * fc - xi * fs;
    const float xi2 = xr * fs + xi * fc;
    const float fp = sd_atan2(xi2, xr2);
    return (wq * fq + (1.0f - wq) * fp) * inv_pi;
}

struct GardnerParams {
    float gpv, gfv, pmn, pmx, run, eqe, eqr;
};

struct ClockState {
    float t, period, prev_re, prev_im, mid_re, mid_im, st_re, st_im,
        want_mid, power;
};

template <int KEQ>
struct CmaState {
    float etr[KEQ], eti[KEQ], ebr[KEQ], ebi[KEQ];
};

// One Gardner clock step: the plain version's pass 3 up to the CMA.
// Sets the interpolant and whether this sample is a strobe.
__device__ __forceinline__ void clock_step(ClockState& g,
                                           const GardnerParams& P, float xr,
                                           float xi, float& ir, float& ii,
                                           bool& is_strobe) {
    g.t = g.t - 1.0f;
    const bool event = g.t <= 0.0f;
    const float frac = fminf(fmaxf(g.t + 1.0f, 0.0f), 1.0f);
    ir = g.prev_re + frac * (xr - g.prev_re);
    ii = g.prev_im + frac * (xi - g.prev_im);
    const bool is_mid = event && g.want_mid > 0.5f;
    is_strobe = event && g.want_mid <= 0.5f;

    g.power = g.power + 0.01f * (xr * xr + xi * xi - g.power);
    const float nm_re = is_mid ? ir : g.mid_re;
    const float nm_im = is_mid ? ii : g.mid_im;
    float err = (ir - g.st_re) * nm_re + (ii - g.st_im) * nm_im;
    err = (is_strobe ? err : 0.0f) / fmaxf(g.power, 1e-9f);
    err = fminf(fmaxf(err, -2.0f), 2.0f);
    g.period = fminf(fmaxf(g.period - P.gfv * err, P.pmn), P.pmx);
    g.t = g.t + (event ? g.period * 0.5f - P.gpv * err : 0.0f);
    if (is_strobe) {
        g.st_re = ir;
        g.st_im = ii;
    }
    if (event) g.want_mid = 1.0f - g.want_mid;
    g.prev_re = xr;
    g.prev_im = xi;
    g.mid_re = nm_re;
    g.mid_im = nm_im;
}

// The fused symbol-rate CMA of one sample, gated on strobes (push 1 at a
// strobe, else 0), and the emitted symbol: the rest of pass 3.  Between
// strobes (push 0) it leaves its taps and delay line as they are (x + 0
// and x - 0·y are x for finite values) and emits 0, so the kernel calls
// it at strobes only.
template <int KEQ>
__device__ __forceinline__ void cma_step(CmaState<KEQ>& g,
                                         const GardnerParams& P, float ir,
                                         float ii, float push, float& out_r,
                                         float& out_i) {
    const float hold = 1.0f - push;
    float nbr[KEQ], nbi[KEQ];
    nbr[0] = push * ir + hold * g.ebr[0];
    nbi[0] = push * ii + hold * g.ebi[0];
#pragma unroll
    for (int j = 1; j < KEQ; ++j) {
        nbr[j] = push * g.ebr[j - 1] + hold * g.ebr[j];
        nbi[j] = push * g.ebi[j - 1] + hold * g.ebi[j];
    }
    float yr = g.etr[0] * nbr[0] - g.eti[0] * nbi[0];
    float yi = g.etr[0] * nbi[0] + g.eti[0] * nbr[0];
#pragma unroll
    for (int j = 1; j < KEQ; ++j) {
        yr = yr + g.etr[j] * nbr[j] - g.eti[j] * nbi[j];
        yi = yi + g.etr[j] * nbi[j] + g.eti[j] * nbr[j];
    }
    const float pp = yr * yr + yi * yi;
    float er = yr * (pp - 1.0f);
    float ei = yi * (pp - 1.0f);
    const float emag = sqrtf(er * er + ei * ei);
    const float s = 1.0f / fmaxf(emag, 1.0f);
    er = er * s;
    ei = ei * s;
    float pw = 1e-6f;
#pragma unroll
    for (int j = 0; j < KEQ; ++j) pw = pw + nbr[j] * nbr[j] + nbi[j] * nbi[j];
    const float gain = push * P.eqr / pw;
#pragma unroll
    for (int j = 0; j < KEQ; ++j) {
        g.etr[j] = g.etr[j] - gain * (er * nbr[j] + ei * nbi[j]);
        g.eti[j] = g.eti[j] - gain * (ei * nbr[j] - er * nbi[j]);
        g.ebr[j] = nbr[j];
        g.ebi[j] = nbi[j];
    }

    // emit: equalized symbol on eq lanes, the interpolant otherwise;
    // clock.running == 0 suppresses emission
    const float outr = P.eqe * yr + (1.0f - P.eqe) * ir;
    const float outi = P.eqe * yi + (1.0f - P.eqe) * ii;
    const float emit = push * P.run;
    out_r = emit * outr;
    out_i = emit * outi;
}

__device__ __forceinline__ FrontParams front_params(const float* prm, int C,
                                                    int c) {
    auto P = [&](int r) { return prm[(size_t)r * C + c]; };
    return FrontParams{P(P_PSK), P(P_FSK),   P(P_ASK),   P(P_W1),
                       P(P_W2),  P(P_W4),    P(P_W8),    P(P_ALPHA),
                       P(P_BETA), P(P_COH)};
}

__device__ __forceinline__ GardnerParams gardner_params(const float* prm,
                                                        int C, int c) {
    auto P = [&](int r) { return prm[(size_t)r * C + c]; };
    return GardnerParams{P(P_GP),  P(P_GF),    P(P_PMIN),   P(P_PMAX),
                         P(P_RUN), P(P_EQ_EN), P(P_EQ_RATE)};
}

__device__ __forceinline__ ClockState clock_state(const float* state, int C,
                                                  int c) {
    auto S = [&](int r) { return state[(size_t)r * C + c]; };
    return ClockState{S(6),  S(7),  S(8),  S(9),  S(10),
                      S(11), S(12), S(13), S(14), S(15)};
}

template <int KEQ>
__device__ __forceinline__ CmaState<KEQ> cma_state(const float* state, int C,
                                                   int c, int K) {
    auto S = [&](int r) { return state[(size_t)r * C + c]; };
    CmaState<KEQ> g;
    const int eq_base = 16 + 2 * (K - 1);
#pragma unroll
    for (int j = 0; j < KEQ; ++j) {
        g.etr[j] = S(eq_base + j);
        g.eti[j] = S(eq_base + KEQ + j);
        g.ebr[j] = S(eq_base + 2 * KEQ + j);
        g.ebi[j] = S(eq_base + 3 * KEQ + j);
    }
    return g;
}

// ---- helpers: input chunks, the FSK detector, the matched filter -------

// Issue the loads of chunk q's rows g, g+NG, ... of lane c into registers.
__device__ __forceinline__ void load_rows(const float* __restrict__ y_re,
                                          const float* __restrict__ y_im,
                                          int q, int g, int c, bool live,
                                          int M, int C, float (&re)[ROWS_PER_HELPER],
                                          float (&im)[ROWS_PER_HELPER]) {
#pragma unroll
    for (int k = 0; k < ROWS_PER_HELPER; ++k) {
        const int row = q * T + g + NG * k;
        const bool ok = live && row < M;
        re[k] = ok ? y_re[(size_t)row * C + c] : 0.0f;
        im[k] = ok ? y_im[(size_t)row * C + c] : 0.0f;
    }
}

// Store chunk q's rows into buffer q & 1, then (after the helpers'
// barrier) its FSK detector.  q0 is the sample before the chunk for q = 0.
__device__ __forceinline__ void stage_chunk(Smem& sm, int q, int g, int l,
                                            const float (&re)[ROWS_PER_HELPER],
                                            const float (&im)[ROWS_PER_HELPER],
                                            float2 q0, float fc, float fs,
                                            float wq) {
    const int b = q & 1;
#pragma unroll
    for (int k = 0; k < ROWS_PER_HELPER; ++k)
        sm.Y(b, g + NG * k, l) = make_float2(re[k], im[k]);
    helper_sync();
#pragma unroll
    for (int k = 0; k < ROWS_PER_HELPER; ++k) {
        const int i = g + NG * k;
        const float2 p = i > 0 ? sm.Y(b, i - 1, l)
                               : (q > 0 ? sm.Y(b ^ 1, T - 1, l) : q0);
        sm.FV(b, i, l) = fsk_detector(re[k], im[k], p.x, p.y, fc, fs, wq);
    }
}

// mf[i] = Σ_{tap} taps[tap] · ext[K-1+i-tap] for chunk q's n rows,
// accumulated tap 0 first (the plain version's order); RT rows a pass.
__device__ __forceinline__ void matched_filter(Smem& sm, int q, int n, int g,
                                               int l, int K, int keff) {
    const int b = q & 1;
    for (int r0 = g * RT; r0 < n; r0 += NG * RT) {
        float ar[RT], ai[RT];
        const float h0 = sm.taps[l];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            const float2 e = sm.EX(b, K - 1 + r0 + r, l);
            ar[r] = h0 * e.x;
            ai[r] = h0 * e.y;
        }
        for (int j = 1; j < keff; ++j) {
            const float h = sm.taps[j * LANES + l];
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const float2 e = sm.EX(b, K - 1 + r0 + r - j, l);
                ar[r] = ar[r] + h * e.x;
                ai[r] = ai[r] + h * e.y;
            }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
            if (r0 + r < n) sm.MF(b, r0 + r, l) = make_float2(ar[r], ai[r]);
    }
}

template <int KEQ>
__global__ void __launch_bounds__(THREADS, 1)
rec_fused(const float* __restrict__ y_re, const float* __restrict__ y_im,
          const float* __restrict__ state, const float* __restrict__ prm,
          const float* __restrict__ taps, float* __restrict__ sym_re,
          float* __restrict__ sym_im, float* __restrict__ strobe,
          float* __restrict__ state_out, int M, int C, int K, float adc,
          float one_m_adc) {
    extern __shared__ float4 smem_raw[];
    Smem sm(reinterpret_cast<float*>(smem_raw), K);
    const int warp = threadIdx.x >> 5;
    const int nch = (M + T - 1) / T;
    const int last_n = M - (nch - 1) * T;
    const int steps = nch + 3;

    if (warp == 0) {
        // front: the carrier loop over chunk s
        const int l = threadIdx.x;
        const int c = blockIdx.x * LANES + l;
        const bool live = l < LANES && c < C;
        FrontParams P{};
        FrontState st{};
        float qpr = 0.0f, qpi = 0.0f;
        if (live) {
            P = front_params(prm, C, c);
            auto S = [&](int r) { return state[(size_t)r * C + c]; };
            st = FrontState{S(0), S(1), S(2), S(5)};
            qpr = S(3);
            qpi = S(4);
        }
        block_sync();
        for (int s = 0; s < steps; ++s) {
            if (live && s < nch) {
                const int b = s & 1;
                const int n = s == nch - 1 ? last_n : T;
                float2 xn = sm.Y(b, 0, l);
                float fvn = sm.FV(b, 0, l);
                for (int i = 0; i < n; ++i) {
                    const float2 x = xn;
                    const float fv = fvn;
                    const int nxt = min(i + 1, T - 1);
                    xn = sm.Y(b, nxt, l);
                    fvn = sm.FV(b, nxt, l);
                    sm.EX(b, K - 1 + i, l) =
                        front_step(st, P, x.x, x.y, fv, adc, one_m_adc);
                    qpr = x.x;
                    qpi = x.y;
                }
            }
            block_sync();
        }
        if (live) {
            const float rows[6] = {st.lo_re, st.lo_im, st.freq, qpr, qpi,
                                   st.dc};
#pragma unroll
            for (int r = 0; r < 6; ++r) state_out[(size_t)r * C + c] = rows[r];
        }
    } else if (warp == 1) {
        // Gardner clock over chunk s - 2: the strobe plane, zero symbols
        // between strobes, and each strobe's interpolant for the CMA warp
        const int l = threadIdx.x - 32;
        const int c = blockIdx.x * LANES + l;
        const bool live = l < LANES && c < C;
        GardnerParams P{};
        ClockState g{};
        if (live) {
            P = gardner_params(prm, C, c);
            g = clock_state(state, C, c);
        }
        block_sync();
        for (int s = 0; s < steps; ++s) {
            const int q = s - 2;
            if (live && q >= 0 && q < nch) {
                const int b = q & 1;
                const int n = q == nch - 1 ? last_n : T;
                int count = 0;
                float2 xn = sm.MF(b, 0, l);
                for (int i = 0; i < n; ++i) {
                    const float2 x = xn;
                    xn = sm.MF(b, min(i + 1, T - 1), l);
                    float ir, ii;
                    bool is_strobe;
                    clock_step(g, P, x.x, x.y, ir, ii, is_strobe);
                    const size_t at = (size_t)(q * T + i) * C + c;
                    strobe[at] = (is_strobe ? 1.0f : 0.0f) * P.run;
                    if (is_strobe) {
                        sm.SQ(b, count, l) = make_float2(ir, ii);
                        sm.SROW(b, count, l) = i;
                        ++count;
                    } else {
                        sym_re[at] = 0.0f;
                        sym_im[at] = 0.0f;
                    }
                }
                sm.scount[b * LANES + l] = count;
            }
            block_sync();
        }
        if (live) {
            const float rows[10] = {g.t,     g.period, g.prev_re, g.prev_im,
                                    g.mid_re, g.mid_im, g.st_re,  g.st_im,
                                    g.want_mid, g.power};
#pragma unroll
            for (int r = 0; r < 10; ++r)
                state_out[(size_t)(6 + r) * C + c] = rows[r];
        }
    } else if (warp == 4) {
        // CMA over the strobes of chunk s - 3, in order
        const int l = threadIdx.x - 128;
        const int c = blockIdx.x * LANES + l;
        const bool live = l < LANES && c < C;
        GardnerParams P{};
        CmaState<KEQ> g{};
        if (live) {
            P = gardner_params(prm, C, c);
            g = cma_state<KEQ>(state, C, c, K);
        }
        block_sync();
        for (int s = 0; s < steps; ++s) {
            const int q = s - 3;
            if (live && q >= 0) {
                const int b = q & 1;
                const int count = sm.scount[b * LANES + l];
                for (int k = 0; k < count; ++k) {
                    const float2 v = sm.SQ(b, k, l);
                    float o_r, o_i;
                    cma_step<KEQ>(g, P, v.x, v.y, 1.0f, o_r, o_i);
                    const size_t at =
                        (size_t)(q * T + sm.SROW(b, k, l)) * C + c;
                    sym_re[at] = o_r;
                    sym_im[at] = o_i;
                }
            }
            block_sync();
        }
        if (live) {
            const int eq_base = 16 + 2 * (K - 1);
#pragma unroll
            for (int j = 0; j < KEQ; ++j) {
                state_out[(size_t)(eq_base + j) * C + c] = g.etr[j];
                state_out[(size_t)(eq_base + KEQ + j) * C + c] = g.eti[j];
                state_out[(size_t)(eq_base + 2 * KEQ + j) * C + c] = g.ebr[j];
                state_out[(size_t)(eq_base + 3 * KEQ + j) * C + c] = g.ebi[j];
            }
        }
    } else {
        // helpers (warps 2-3)
        const int h = threadIdx.x - 64;
        const int l = h % LANES;
        const int g = h / LANES;
        const int c = blockIdx.x * LANES + l;
        const bool live = c < C;
        float fc = 0.0f, fs = 0.0f, wq = 0.0f;
        float2 q0 = make_float2(0.0f, 0.0f);
        if (live) {
            fc = prm[(size_t)P_FSK_COS * C + c];
            fs = prm[(size_t)P_FSK_SIN * C + c];
            wq = prm[(size_t)P_QUAD * C + c];
            q0 = make_float2(state[(size_t)3 * C + c], state[(size_t)4 * C + c]);
        }
        float re[ROWS_PER_HELPER], im[ROWS_PER_HELPER];
        load_rows(y_re, y_im, 0, g, c, live, M, C, re, im);
        for (int j = g; j < K; j += NG)
            sm.taps[j * LANES + l] = live ? taps[(size_t)j * C + c] : 0.0f;
        // the carried tail ahead of chunk 0
        for (int r = g; r < K - 1; r += NG)
            sm.EX(0, r, l) =
                live ? make_float2(state[(size_t)(16 + r) * C + c],
                                   state[(size_t)(16 + K - 1 + r) * C + c])
                     : make_float2(0.0f, 0.0f);
        if (h == 0) *sm.keff = 0;
        stage_chunk(sm, 0, g, l, re, im, q0, fc, fs, wq);
        if (g == 0) {
            // taps past the last nonzero one of every lane are skipped
            int last = 0;
            for (int j = 0; j < K; ++j)
                if (sm.taps[j * LANES + l] != 0.0f) last = j + 1;
            atomicMax(sm.keff, last);
        }
        block_sync();
        const int keff = *sm.keff;
        for (int s = 0; s < steps; ++s) {
            const bool next = s + 1 < nch;
            if (next) load_rows(y_re, y_im, s + 1, g, c, live, M, C, re, im);
            if (s >= 1 && s <= nch)
                matched_filter(sm, s - 1, s - 1 == nch - 1 ? last_n : T, g, l,
                               K, keff);
            if (s >= 1 && s < nch)
                for (int r = g; r < K - 1; r += NG)
                    sm.EX(s & 1, r, l) = sm.EX((s - 1) & 1, T + r, l);
            if (next) stage_chunk(sm, s + 1, g, l, re, im, q0, fc, fs, wq);
            block_sync();
        }
        // the last K-1 rows of ext are the next block's MF tails
        if (live) {
            const int b = (nch - 1) & 1;
            for (int r = g; r < K - 1; r += NG) {
                const float2 e = sm.EX(b, last_n + r, l);
                state_out[(size_t)(16 + r) * C + c] = e.x;
                state_out[(size_t)(16 + K - 1 + r) * C + c] = e.y;
            }
        }
    }
}

// The chains alone, one warp at a time on lanes 0..LANES-1 of the bank,
// inputs cycled from T rows of y in shared memory and read one step
// ahead as rec_fused does: `steps` carrier-loop steps (warp 0), as many
// Gardner clock steps (warp 1), then as many CMA updates, each a strobe
// (warp 1).  out[0..2]: cycles a step of each; out[3]: the SM clock in
// GHz (clock64 over %globaltimer); out[4..]: a sink for the final states.
template <int KEQ>
__global__ void __launch_bounds__(64, 1)
rec_chain(const float* __restrict__ y_re, const float* __restrict__ y_im,
          const float* __restrict__ state, const float* __restrict__ prm,
          int C, int K, int steps, float adc, float one_m_adc,
          float* __restrict__ out) {
    __shared__ float2 xs[T][LANES];
    const int warp = threadIdx.x >> 5;
    const int l = threadIdx.x & 31;
    const bool live = l < LANES;
    if (warp == 0 && live)
        for (int i = 0; i < T; ++i)
            xs[i][l] = make_float2(y_re[(size_t)i * C + l],
                                   y_im[(size_t)i * C + l]);
    __syncthreads();
    if (warp == 0 && live) {
        const FrontParams P = front_params(prm, C, l);
        auto S = [&](int r) { return state[(size_t)r * C + l]; };
        FrontState st{S(0), S(1), S(2), S(5)};
        float sink = 0.0f;
        uint64_t ns0, ns1;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
        const long long t0 = clock64();
        float2 xn = xs[0][l];
        for (int i = 0; i < steps; ++i) {
            const float2 x = xn;
            xn = xs[(i + 1) & (T - 1)][l];
            const float2 e =
                front_step(st, P, x.x, x.y, 0.5f * x.x, adc, one_m_adc);
            sink = sink + e.x;
        }
        const long long t1 = clock64();
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
        if (l == 0) {
            out[0] = static_cast<float>(t1 - t0) / steps;
            out[3] = static_cast<float>(t1 - t0) /
                     static_cast<float>(ns1 - ns0);
        }
        out[4 + l] = sink + st.lo_re + st.freq + st.dc;
    }
    __syncthreads();
    if (warp == 1 && live) {
        const GardnerParams P = gardner_params(prm, C, l);
        ClockState g = clock_state(state, C, l);
        float sink = 0.0f;
        long long t0 = clock64();
        float2 xn = xs[0][l];
        for (int i = 0; i < steps; ++i) {
            const float2 x = xn;
            xn = xs[(i + 1) & (T - 1)][l];
            float ir, ii;
            bool is_strobe;
            clock_step(g, P, x.x, x.y, ir, ii, is_strobe);
            sink = sink + (is_strobe ? ir : ii);
        }
        long long t1 = clock64();
        if (l == 0) out[1] = static_cast<float>(t1 - t0) / steps;
        CmaState<KEQ> e = cma_state<KEQ>(state, C, l, K);
        t0 = clock64();
        xn = xs[0][l];
        for (int i = 0; i < steps; ++i) {
            const float2 x = xn;
            xn = xs[(i + 1) & (T - 1)][l];
            float o_r, o_i;
            cma_step<KEQ>(e, P, x.x, x.y, 1.0f, o_r, o_i);
            sink = sink + o_r;
        }
        t1 = clock64();
        if (l == 0) out[2] = static_cast<float>(t1 - t0) / steps;
        out[4 + LANES + l] = sink + g.t + e.etr[0];
    }
}

template <int KEQ>
int launch_fused(const float* y_re, const float* y_im, const float* state,
                 const float* prm, const float* taps, float* sym_re,
                 float* sym_im, float* strobe, float* state_out, int M, int C,
                 int K, float adc, float one_m_adc, cudaStream_t s) {
    const size_t smem = smem_bytes(K);
    cudaError_t e = cudaFuncSetAttribute(
        rec_fused<KEQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    rec_fused<KEQ><<<(C + LANES - 1) / LANES, THREADS, smem, s>>>(
        y_re, y_im, state, prm, taps, sym_re, sym_im, strobe, state_out, M, C,
        K, adc, one_m_adc);
    return static_cast<int>(cudaGetLastError());
}

template <int KEQ>
int launch_chain(const float* y_re, const float* y_im, const float* state,
                 const float* prm, int C, int K, int steps, float adc,
                 float one_m_adc, float* out, cudaStream_t s) {
    rec_chain<KEQ><<<1, 64, 0, s>>>(y_re, y_im, state, prm, C, K, steps, adc,
                                    one_m_adc, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One block of the recovery bank.  y_re, y_im [M, C]; state [R, C] with
// R = 16 + 2(K-1) + 4·keq; prm [20, C]; taps [K, C].  Outputs sym_re,
// sym_im, strobe [M, C] and state_out [R, C] (fresh, never the input
// state).  keq in 1..8; K at most what fits the shared memory
// (sd_recovery_smem_bytes <= 232448).  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int sd_recovery(const float* y_re, const float* y_im,
                           const float* state, const float* prm,
                           const float* taps, float* sym_re, float* sym_im,
                           float* strobe, float* state_out, int M, int C,
                           int K, int keq, float adc, float one_m_adc,
                           void* stream) {
    if (M < 1 || C < 1 || K < 1 || keq < 1 || keq > 8 ||
        smem_bytes(K) > static_cast<size_t>(MAX_SMEM))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    using Fn = int (*)(const float*, const float*, const float*, const float*,
                       const float*, float*, float*, float*, float*, int, int,
                       int, float, float, cudaStream_t);
    static const Fn fns[8] = {launch_fused<1>, launch_fused<2>,
                              launch_fused<3>, launch_fused<4>,
                              launch_fused<5>, launch_fused<6>,
                              launch_fused<7>, launch_fused<8>};
    return fns[keq - 1](y_re, y_im, state, prm, taps, sym_re, sym_im, strobe,
                        state_out, M, C, K, adc, one_m_adc, s);
}

// Shared memory one block of sd_recovery takes at K taps.
extern "C" int sd_recovery_smem_bytes(int K) {
    return static_cast<int>(smem_bytes(K));
}

// The chains' cycles a step (sd_recovery's carrier loop, Gardner clock
// and CMA update, one after the other) on lanes 0..15 of the bank: out
// [4 + 32] float32, out[0] front, out[1] clock, out[2] CMA, out[3] the SM
// clock in GHz.  Needs 64 rows of y_re, y_im and C >= 16.
extern "C" int sd_recovery_chain(const float* y_re, const float* y_im,
                                 const float* state, const float* prm, int C,
                                 int K, int keq, int steps, float adc,
                                 float one_m_adc, float* out, void* stream) {
    if (C < LANES || K < 1 || keq < 1 || keq > 8 || steps < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    using Fn = int (*)(const float*, const float*, const float*, const float*,
                       int, int, int, float, float, float*, cudaStream_t);
    static const Fn fns[8] = {launch_chain<1>, launch_chain<2>,
                              launch_chain<3>, launch_chain<4>,
                              launch_chain<5>, launch_chain<6>,
                              launch_chain<7>, launch_chain<8>};
    return fns[keq - 1](y_re, y_im, state, prm, C, K, steps, adc, one_m_adc,
                        out, s);
}
