// Unified PSK/FSK/ASK recovery bank, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/recovery.py::
// _recovery_kernel.  Nothing couples the channel lanes, and each lane
// is sequential in time; the TPU kernel's time tiles only carry state
// from one grid step to the next, so here one pass walks the whole
// block.  Three launches:
//
//   rec_front    one thread per lane, in time order: carrier loop with
//                the order-blended detector (Im u, u², u⁴, u⁸), FSK
//                quadrature or phase detector, ASK coherent or envelope
//                with DC tracking; writes the detector output after the
//                carried matched-filter tail into ext [M+K-1, C]
//   rec_mf       per-channel matched filter over ext, parallel over
//                (time, channel), taps summed in the reference's order
//                t = 0..K-1 -> mf [M, C]
//   rec_gardner  one thread per lane, in time order: Gardner TED with
//                per-lane gains and period bounds, the fused symbol-rate
//                CMA equalizer and the clock.running gate -> symbols
//                re/im and strobes [M, C]
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
// into an FMA the plain version's separate operations do not make.
//
// Bound: latency.  Each lane is a chain of several thousand dependent
// steps (M per pass) through cos/sin, division and sqrt; the bytes (the
// y planes in, symbol and strobe planes out, about 160 MiB at M = 8192,
// C = 1024) are a small part.  Design: blocks of 32 lanes, so 1024 lanes
// spread over 32 SMs instead of 8; each thread prefetches its inputs
// PF steps ahead into registers so the loads stay off the chain; the
// matched filter runs as its own parallel pass.  Parallelising over
// time is later work.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/recovery.py::recovery_kernel_reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ops.cuh"

namespace {

constexpr int LANES = 32;    // lanes (threads) per block of the loops
constexpr int PF = 8;        // prefetch distance of the loops, in steps
constexpr int MF_ROWS = 16;  // output rows per thread of the MF pass

// parameter rows (recovery.py::PARAM_ROWS)
enum {
    P_PSK, P_FSK, P_ASK, P_W1, P_W2, P_W4, P_W8, P_ALPHA, P_BETA, P_GP,
    P_GF, P_PMIN, P_PMAX, P_FSK_COS, P_FSK_SIN, P_QUAD, P_COH, P_RUN,
    P_EQ_EN, P_EQ_RATE, N_PARAMS
};

__global__ void __launch_bounds__(LANES)
rec_front(const float* __restrict__ y_re, const float* __restrict__ y_im,
          const float* __restrict__ state, const float* __restrict__ prm,
          float* __restrict__ ext_re, float* __restrict__ ext_im,
          float* __restrict__ state_out, int M, int C, int K, float adc,
          float one_m_adc) {
    const int c = blockIdx.x * LANES + threadIdx.x;
    if (c >= C) return;
    auto P = [&](int r) { return prm[(size_t)r * C + c]; };
    const float wp = P(P_PSK), wf = P(P_FSK), wa = P(P_ASK);
    const float o1 = P(P_W1), o2 = P(P_W2), o4 = P(P_W4), o8 = P(P_W8);
    const float al = P(P_ALPHA), be = P(P_BETA);
    const float fc = P(P_FSK_COS), fs = P(P_FSK_SIN);
    const float wq = P(P_QUAD), wc = P(P_COH);
    auto S = [&](int r) { return state[(size_t)r * C + c]; };
    float lo_re = S(0), lo_im = S(1), freq = S(2), qpr = S(3), qpi = S(4);
    float dc = S(5);
    for (int r = 0; r < K - 1; ++r) {
        ext_re[(size_t)r * C + c] = S(16 + r);
        ext_im[(size_t)r * C + c] = S(16 + K - 1 + r);
    }
    const float inv_pi = static_cast<float>(1.0 / 3.141592653589793);

    float bx_r[PF], bx_i[PF];
#pragma unroll
    for (int p = 0; p < PF; ++p) {
        bx_r[p] = p < M ? y_re[(size_t)p * C + c] : 0.0f;
        bx_i[p] = p < M ? y_im[(size_t)p * C + c] : 0.0f;
    }
    for (int t0 = 0; t0 < M; t0 += PF) {
#pragma unroll
        for (int p = 0; p < PF; ++p) {
            const int t = t0 + p;
            const float xr = bx_r[p], xi = bx_i[p];
            const int tn = t + PF;
            if (tn < M) {
                bx_r[p] = y_re[(size_t)tn * C + c];
                bx_i[p] = y_im[(size_t)tn * C + c];
            }
            if (t >= M) break;
            // carrier derotation (identity for untracked lanes)
            const float rr = xr * lo_re + xi * lo_im;
            const float ri = xi * lo_re - xr * lo_im;
            const float mag = fmaxf(sqrtf(rr * rr + ri * ri), 1e-12f);
            const float ur = rr / mag;
            const float ui = ri / mag;
            const float u2r = ur * ur - ui * ui;
            const float u2i = 2.0f * ur * ui;
            const float u4r = u2r * u2r - u2i * u2i;
            const float u4i = 2.0f * u2r * u2i;
            const float u8i = 2.0f * u4r * u4i;
            const float err = o1 * ui + o2 * u2i * 0.5f + o4 * u4i * 0.25f +
                              o8 * u8i * 0.125f;
            freq = freq + be * err;
            const float w = freq + al * err;
            const float cw = cosf(w);
            const float sw = sinf(w);
            const float nr = lo_re * cw - lo_im * sw;
            const float ni = lo_re * sw + lo_im * cw;
            const float inv = rsqrtf(nr * nr + ni * ni);
            // FSK: quadrature discriminator or rotated instantaneous phase
            const float dr = xr * qpr + xi * qpi;
            const float di = xi * qpr - xr * qpi;
            const float fq = sd_atan2(di, dr);
            const float xr2 = xr * fc - xi * fs;
            const float xi2 = xr * fs + xi * fc;
            const float fp = sd_atan2(xi2, xr2);
            const float fv = (wq * fq + (1.0f - wq) * fp) * inv_pi;
            // ASK: coherent Re{} or envelope, DC-tracked
            const float avs = wc * rr + (1.0f - wc) * mag;
            dc = adc * dc + one_m_adc * avs;
            const float av = avs - dc;
            const size_t at = (size_t)(t + K - 1) * C + c;
            ext_re[at] = wp * rr + wf * fv + wa * av;
            ext_im[at] = wp * ri;
            lo_re = nr * inv;
            lo_im = ni * inv;
            qpr = xr;
            qpi = xi;
        }
    }
    state_out[(size_t)0 * C + c] = lo_re;
    state_out[(size_t)1 * C + c] = lo_im;
    state_out[(size_t)2 * C + c] = freq;
    state_out[(size_t)3 * C + c] = qpr;
    state_out[(size_t)4 * C + c] = qpi;
    state_out[(size_t)5 * C + c] = dc;
    // the last K-1 rows of ext are the next block's MF tails
    for (int r = 0; r < K - 1; ++r) {
        state_out[(size_t)(16 + r) * C + c] = ext_re[(size_t)(M + r) * C + c];
        state_out[(size_t)(16 + K - 1 + r) * C + c] =
            ext_im[(size_t)(M + r) * C + c];
    }
}

// mf[t] = Σ_{tap} taps[tap] · ext[K-1+t-tap], accumulated tap 0 first.
__global__ void __launch_bounds__(64)
rec_mf(const float* __restrict__ ext_re, const float* __restrict__ ext_im,
       const float* __restrict__ taps, float* __restrict__ mf_re,
       float* __restrict__ mf_im, int M, int C, int K) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int t0 = blockIdx.y * MF_ROWS;
    if (c >= C) return;
    float ar[MF_ROWS], ai[MF_ROWS];
    {
        const float h = taps[c];
#pragma unroll
        for (int r = 0; r < MF_ROWS; ++r) {
            const int t = min(t0 + r, M - 1);
            ar[r] = h * ext_re[(size_t)(K - 1 + t) * C + c];
            ai[r] = h * ext_im[(size_t)(K - 1 + t) * C + c];
        }
    }
    for (int tap = 1; tap < K; ++tap) {
        const float h = taps[(size_t)tap * C + c];
#pragma unroll
        for (int r = 0; r < MF_ROWS; ++r) {
            const int t = min(t0 + r, M - 1);
            const size_t at = (size_t)(K - 1 + t - tap) * C + c;
            ar[r] = ar[r] + h * ext_re[at];
            ai[r] = ai[r] + h * ext_im[at];
        }
    }
#pragma unroll
    for (int r = 0; r < MF_ROWS; ++r) {
        const int t = t0 + r;
        if (t < M) {
            mf_re[(size_t)t * C + c] = ar[r];
            mf_im[(size_t)t * C + c] = ai[r];
        }
    }
}

template <int KEQ>
__global__ void __launch_bounds__(LANES)
rec_gardner(const float* __restrict__ mf_re, const float* __restrict__ mf_im,
            const float* __restrict__ state, const float* __restrict__ prm,
            float* __restrict__ sym_re, float* __restrict__ sym_im,
            float* __restrict__ strobe, float* __restrict__ state_out, int M,
            int C, int K) {
    const int c = blockIdx.x * LANES + threadIdx.x;
    if (c >= C) return;
    auto P = [&](int r) { return prm[(size_t)r * C + c]; };
    const float gpv = P(P_GP), gfv = P(P_GF), pmn = P(P_PMIN),
                pmx = P(P_PMAX), run = P(P_RUN), eqe = P(P_EQ_EN),
                eqr = P(P_EQ_RATE);
    auto S = [&](int r) { return state[(size_t)r * C + c]; };
    float t = S(6), period = S(7), prev_re = S(8), prev_im = S(9);
    float mid_re = S(10), mid_im = S(11), st_re = S(12), st_im = S(13);
    float want_mid = S(14), power = S(15);
    const int eq_base = 16 + 2 * (K - 1);
    float etr[KEQ], eti[KEQ], ebr[KEQ], ebi[KEQ];
#pragma unroll
    for (int j = 0; j < KEQ; ++j) {
        etr[j] = S(eq_base + j);
        eti[j] = S(eq_base + KEQ + j);
        ebr[j] = S(eq_base + 2 * KEQ + j);
        ebi[j] = S(eq_base + 3 * KEQ + j);
    }

    float bx_r[PF], bx_i[PF];
#pragma unroll
    for (int p = 0; p < PF; ++p) {
        bx_r[p] = p < M ? mf_re[(size_t)p * C + c] : 0.0f;
        bx_i[p] = p < M ? mf_im[(size_t)p * C + c] : 0.0f;
    }
    for (int t0 = 0; t0 < M; t0 += PF) {
#pragma unroll
        for (int p = 0; p < PF; ++p) {
            const int i = t0 + p;
            const float xr = bx_r[p], xi = bx_i[p];
            const int tn = i + PF;
            if (tn < M) {
                bx_r[p] = mf_re[(size_t)tn * C + c];
                bx_i[p] = mf_im[(size_t)tn * C + c];
            }
            if (i >= M) break;
            t = t - 1.0f;
            const bool event = t <= 0.0f;
            const float frac = fminf(fmaxf(t + 1.0f, 0.0f), 1.0f);
            const float ir = prev_re + frac * (xr - prev_re);
            const float ii = prev_im + frac * (xi - prev_im);
            const bool is_mid = event && want_mid > 0.5f;
            const bool is_strobe = event && want_mid <= 0.5f;

            power = power + 0.01f * (xr * xr + xi * xi - power);
            const float nm_re = is_mid ? ir : mid_re;
            const float nm_im = is_mid ? ii : mid_im;
            float err = (ir - st_re) * nm_re + (ii - st_im) * nm_im;
            err = (is_strobe ? err : 0.0f) / fmaxf(power, 1e-9f);
            err = fminf(fmaxf(err, -2.0f), 2.0f);
            period = fminf(fmaxf(period - gfv * err, pmn), pmx);
            t = t + (event ? period * 0.5f - gpv * err : 0.0f);
            if (is_strobe) {
                st_re = ir;
                st_im = ii;
            }
            if (event) want_mid = 1.0f - want_mid;

            // fused CMA at symbol rate, gated on strobes
            const float push = is_strobe ? 1.0f : 0.0f;
            const float hold = 1.0f - push;
            float nbr[KEQ], nbi[KEQ];
            nbr[0] = push * ir + hold * ebr[0];
            nbi[0] = push * ii + hold * ebi[0];
#pragma unroll
            for (int j = 1; j < KEQ; ++j) {
                nbr[j] = push * ebr[j - 1] + hold * ebr[j];
                nbi[j] = push * ebi[j - 1] + hold * ebi[j];
            }
            float yr = etr[0] * nbr[0] - eti[0] * nbi[0];
            float yi = etr[0] * nbi[0] + eti[0] * nbr[0];
#pragma unroll
            for (int j = 1; j < KEQ; ++j) {
                yr = yr + etr[j] * nbr[j] - eti[j] * nbi[j];
                yi = yi + etr[j] * nbi[j] + eti[j] * nbr[j];
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
            for (int j = 0; j < KEQ; ++j)
                pw = pw + nbr[j] * nbr[j] + nbi[j] * nbi[j];
            const float g = push * eqr / pw;
#pragma unroll
            for (int j = 0; j < KEQ; ++j) {
                etr[j] = etr[j] - g * (er * nbr[j] + ei * nbi[j]);
                eti[j] = eti[j] - g * (ei * nbr[j] - er * nbi[j]);
                ebr[j] = nbr[j];
                ebi[j] = nbi[j];
            }

            // emit: equalized symbol on eq lanes, the interpolant
            // otherwise; clock.running == 0 suppresses emission
            const float outr = eqe * yr + (1.0f - eqe) * ir;
            const float outi = eqe * yi + (1.0f - eqe) * ii;
            const float emit = push * run;
            const size_t at = (size_t)i * C + c;
            sym_re[at] = emit * outr;
            sym_im[at] = emit * outi;
            strobe[at] = emit;
            prev_re = xr;
            prev_im = xi;
            mid_re = nm_re;
            mid_im = nm_im;
        }
    }
    const float rows[10] = {t, period, prev_re, prev_im, mid_re, mid_im,
                            st_re, st_im, want_mid, power};
#pragma unroll
    for (int r = 0; r < 10; ++r) state_out[(size_t)(6 + r) * C + c] = rows[r];
#pragma unroll
    for (int j = 0; j < KEQ; ++j) {
        state_out[(size_t)(eq_base + j) * C + c] = etr[j];
        state_out[(size_t)(eq_base + KEQ + j) * C + c] = eti[j];
        state_out[(size_t)(eq_base + 2 * KEQ + j) * C + c] = ebr[j];
        state_out[(size_t)(eq_base + 3 * KEQ + j) * C + c] = ebi[j];
    }
}

template <int KEQ>
void launch_gardner(const float* mf_re, const float* mf_im,
                    const float* state, const float* prm, float* sym_re,
                    float* sym_im, float* strobe, float* state_out, int M,
                    int C, int K, cudaStream_t s) {
    rec_gardner<KEQ><<<(C + LANES - 1) / LANES, LANES, 0, s>>>(
        mf_re, mf_im, state, prm, sym_re, sym_im, strobe, state_out, M, C,
        K);
}

}  // namespace

// One block of the recovery bank.  y_re, y_im [M, C]; state [R, C] with
// R = 16 + 2(K-1) + 4·keq; prm [20, C]; taps [K, C].  Outputs sym_re,
// sym_im, strobe [M, C] and state_out [R, C] (fresh, never the input
// state); ext_re, ext_im [M+K-1, C] and mf_re, mf_im [M, C] are
// scratch.  keq in 1..8.  Launches on `stream` without synchronising
// and returns cudaGetLastError().
extern "C" int sd_recovery(const float* y_re, const float* y_im,
                           const float* state, const float* prm,
                           const float* taps, float* sym_re, float* sym_im,
                           float* strobe, float* state_out, float* ext_re,
                           float* ext_im, float* mf_re, float* mf_im, int M,
                           int C, int K, int keq, float adc, float one_m_adc,
                           void* stream) {
    if (M < 1 || C < 1 || K < 1 || keq < 1 || keq > 8)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int lane_blocks = (C + LANES - 1) / LANES;
    rec_front<<<lane_blocks, LANES, 0, s>>>(y_re, y_im, state, prm, ext_re,
                                            ext_im, state_out, M, C, K, adc,
                                            one_m_adc);
    const dim3 mf_grid((C + 63) / 64, (M + MF_ROWS - 1) / MF_ROWS);
    rec_mf<<<mf_grid, 64, 0, s>>>(ext_re, ext_im, taps, mf_re, mf_im, M, C,
                                  K);
    switch (keq) {
    case 1: launch_gardner<1>(mf_re, mf_im, state, prm, sym_re, sym_im,
                              strobe, state_out, M, C, K, s); break;
    case 2: launch_gardner<2>(mf_re, mf_im, state, prm, sym_re, sym_im,
                              strobe, state_out, M, C, K, s); break;
    case 3: launch_gardner<3>(mf_re, mf_im, state, prm, sym_re, sym_im,
                              strobe, state_out, M, C, K, s); break;
    case 4: launch_gardner<4>(mf_re, mf_im, state, prm, sym_re, sym_im,
                              strobe, state_out, M, C, K, s); break;
    case 5: launch_gardner<5>(mf_re, mf_im, state, prm, sym_re, sym_im,
                              strobe, state_out, M, C, K, s); break;
    case 6: launch_gardner<6>(mf_re, mf_im, state, prm, sym_re, sym_im,
                              strobe, state_out, M, C, K, s); break;
    case 7: launch_gardner<7>(mf_re, mf_im, state, prm, sym_re, sym_im,
                              strobe, state_out, M, C, K, s); break;
    default: launch_gardner<8>(mf_re, mf_im, state, prm, sym_re, sym_im,
                               strobe, state_out, M, C, K, s); break;
    }
    return static_cast<int>(cudaGetLastError());
}
