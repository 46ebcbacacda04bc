// Channelizer stages shared by the v2 FM kernel (channelizer2.cu) and the
// v1 FM kernel (channelizer.cu).
//
//   chan_rot_disc  channelize Y = Xw·H, rotate, discriminate against the
//                  previous rotated row (recomputed as a one-row halo, or
//                  the carried row at m = 0) -> f [M, C], last row and,
//                  optionally, the last Ka-1 rows of f (the FIR tail)
//   audio_fir      banded decimating FIR over [ftail_in | f], or over f
//                  with zeros before the block -> audio [M/Da, C]
//
// Two rotators, as the TPU kernel has them (channelizer2.py:153-183):
//   TABLE   e^{-jmθ} = Q[m/64]·R[m%64], both tables float64-built on the
//           host (snapped grid, m_tile % 64 == 0);
//   cos/sin ph = φ0[mi] + m_local·θ in float32 with one start phase per
//           time tile of mt rows, then cos and -sin of ph.  The phase
//           reaches mt·2π rad, where one float32 rounding step is ~1e-3
//           rad at mt = 2048, so it is an explicit __fmaf_rn (one
//           rounding, as the plain version's exact float64 value rounded
//           once), and sincosf (not __sinf/__cosf) reduces the argument
//           accurately.  No fast-math flag.
//
// Bound of chan_rot_disc: the complex product, 8·M·K·C flops (4.3 GFLOP
// per block at M = 8192, C = 1024) on the float32 CUDA cores; it reads
// 2 MiB (int16) of windows and writes the 32 MiB f scratch.  Design: a
// 64x64 output tile per block, 256 threads with a 4x4 complex register
// tile each, taps staged through shared memory in two chunks of 32 so the
// block stays under 48 KB and several blocks share an SM.  The one-row
// halo Y[m0-1] costs 1/64 extra work and removes any ordering between
// blocks.  The rotation and discriminator run from the shared Y tile with
// consecutive threads on consecutive channels, so the table or phase
// reads and the f writes are coalesced.  Rows past M (M not a multiple of
// 64) are read as zeros and never written.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "ops.cuh"

namespace chan {

constexpr int K = 64;        // taps per window
constexpr int TM = 64;       // rows per block
constexpr int TC = 64;       // channels per block
constexpr int KC = 32;       // taps per shared-memory chunk
constexpr int XS = KC + 1;   // padded row stride of the x chunk
constexpr int YS = TC + 1;   // padded row stride of the Y tile
constexpr int MAX_KA = 256;  // audio taps held in shared memory

// xr, xi: the [M, 64] window planes (the halves of one packed [2M, 64]
// upload for the v2 kernel).  TABLE reads q [M/64·2, C] and r [128, C];
// cos/sin reads theta [1, C] and phi0 [M/mt, C].  ftail_out may be null.
template <typename T, bool TABLE>
__global__ void __launch_bounds__(256)
chan_rot_disc(const T* __restrict__ xr, const T* __restrict__ xi,
              float in_gain, const float* __restrict__ h_re,
              const float* __restrict__ h_im, const float* __restrict__ q,
              const float* __restrict__ r, const float* __restrict__ theta,
              const float* __restrict__ phi0,
              const float* __restrict__ prev_re,
              const float* __restrict__ prev_im, float* __restrict__ f,
              float* __restrict__ last_re, float* __restrict__ last_im,
              float* __restrict__ ftail_out, int M, int C, int mt, int ka,
              float quad_gain) {
    __shared__ float smem[2 * (TM + 1) * YS];
    float* xs_re = smem;
    float* xs_im = xs_re + (TM + 1) * XS;
    float* hs_re = xs_im + (TM + 1) * XS;
    float* hs_im = hs_re + KC * TC;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int c0 = blockIdx.x * TC;
    const int m0 = blockIdx.y * TM;

    float acc_re[4][4], acc_im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_re[i][j] = acc_im[i][j] = 0.0f;
    float hal_re = 0.0f, hal_im = 0.0f;   // Y[m0-1] of channel c0+tid

    for (int k0 = 0; k0 < K; k0 += KC) {
        // rows m0-1 .. m0+TM-1 of both planes (row 0 is the halo)
        for (int i = tid; i < (TM + 1) * KC; i += 256) {
            const int lr = i / KC, kk = i % KC;
            const int m = m0 - 1 + lr;
            float vr = 0.0f, vi = 0.0f;
            if (m >= 0 && m < M) {
                vr = deq(xr[(size_t)m * K + k0 + kk], in_gain);
                vi = deq(xi[(size_t)m * K + k0 + kk], in_gain);
            }
            xs_re[lr * XS + kk] = vr;
            xs_im[lr * XS + kk] = vi;
        }
        for (int i = tid; i < KC * TC; i += 256) {
            const int kk = i / TC, c = c0 + i % TC;
            const bool in = c < C;
            hs_re[i] = in ? h_re[(size_t)(k0 + kk) * C + c] : 0.0f;
            hs_im[i] = in ? h_im[(size_t)(k0 + kk) * C + c] : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
            float ar[4], ai[4], br[4], bi[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                ar[i] = xs_re[(1 + ty * 4 + i) * XS + kk];
                ai[i] = xs_im[(1 + ty * 4 + i) * XS + kk];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                br[j] = hs_re[kk * TC + tx + 16 * j];
                bi[j] = hs_im[kk * TC + tx + 16 * j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc_re[i][j] += ar[i] * br[j] - ai[i] * bi[j];
                    acc_im[i][j] += ar[i] * bi[j] + ai[i] * br[j];
                }
        }
        if (tid < TC) {
            for (int kk = 0; kk < KC; ++kk) {
                const float xv_re = xs_re[kk], xv_im = xs_im[kk];
                const float hr = hs_re[kk * TC + tid];
                const float hi = hs_im[kk * TC + tid];
                hal_re += xv_re * hr - xv_im * hi;
                hal_im += xv_re * hi + xv_im * hr;
            }
        }
        __syncthreads();
    }

    // raw Y tile (row 0 = halo) into shared memory, over the x/H chunks
    float* ys_re = smem;
    float* ys_im = smem + (TM + 1) * YS;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            ys_re[(1 + ty * 4 + i) * YS + tx + 16 * j] = acc_re[i][j];
            ys_im[(1 + ty * 4 + i) * YS + tx + 16 * j] = acc_im[i][j];
        }
    if (tid < TC) {
        ys_re[tid] = hal_re;
        ys_im[tid] = hal_im;
    }
    __syncthreads();

    // rotate row m; the halo of the first tile is the carried, already
    // rotated, row
    const int qs = mt >> 6;
    for (int i = tid; i < (TM + 1) * TC; i += 256) {
        const int lr = i / TC, cc = i % TC;
        const int c = c0 + cc, m = m0 - 1 + lr;
        if (c >= C || m >= M) continue;
        float rr, ri;
        if (m < 0) {
            rr = prev_re[c];
            ri = prev_im[c];
        } else {
            float cr, ci;
            if (TABLE) {
                const int mi = m / mt, g = (m % mt) >> 6, rw = m & 63;
                const float qre = q[(size_t)(mi * 2 * qs + g) * C + c];
                const float qim = q[(size_t)(mi * 2 * qs + qs + g) * C + c];
                const float rre = r[(size_t)rw * C + c];
                const float rim = r[(size_t)(64 + rw) * C + c];
                cr = qre * rre - qim * rim;
                ci = qre * rim + qim * rre;
            } else {
                const int mi = m / mt;
                const float ml = static_cast<float>(m - mi * mt);
                const float ph =
                    __fmaf_rn(ml, theta[c], phi0[(size_t)mi * C + c]);
                float sn, cs;
                sincosf(ph, &sn, &cs);
                cr = cs;
                ci = -sn;
            }
            const float yr = ys_re[lr * YS + cc], yi = ys_im[lr * YS + cc];
            rr = yr * cr - yi * ci;
            ri = yr * ci + yi * cr;
        }
        ys_re[lr * YS + cc] = rr;
        ys_im[lr * YS + cc] = ri;
    }
    __syncthreads();

    // discriminator: atan2(Y[m]·conj(Y[m-1]))·quad_gain
    const int tail0 = M - (ka - 1);
    for (int i = tid; i < TM * TC; i += 256) {
        const int lr = 1 + i / TC, cc = i % TC;
        const int c = c0 + cc, m = m0 - 1 + lr;
        if (c >= C || m >= M) continue;
        const float rr = ys_re[lr * YS + cc], ri = ys_im[lr * YS + cc];
        const float pr = ys_re[(lr - 1) * YS + cc];
        const float pi = ys_im[(lr - 1) * YS + cc];
        const float dr = rr * pr + ri * pi;
        const float di = ri * pr - rr * pi;
        const float fv = sd_atan2(di, dr) * quad_gain;
        f[(size_t)m * C + c] = fv;
        if (m == M - 1) {
            last_re[c] = rr;
            last_im[c] = ri;
        }
        if (ftail_out != nullptr && m >= tail0)
            ftail_out[(size_t)(m - tail0) * C + c] = fv;
    }
}

// Banded decimating audio FIR:
//   audio[j, c] = Σ_t a[t] · f_ext[j·Da − t + Ka − 1, c],
//   f_ext = [ftail_in (Ka−1 rows) | f (M rows)], or zeros before f
//   when TAIL is false (the v1 kernel's global banded matrix)
// the indexing of the reference's banded matrices.
//
// Bound: bytes.  2·Ka·(M/Da)·C flops (34 MFLOP at the bench) against the
// 32 MiB f scratch read once (each f row feeds Ka/Da audio rows; the
// repeats hit L2).  Design: one thread per output, consecutive threads
// on consecutive channels so every tap's row read is one coalesced line.
template <bool BF16, bool TAIL>
__global__ void __launch_bounds__(256)
audio_fir(const float* __restrict__ f, const float* __restrict__ ftail_in,
          const float* __restrict__ ataps, void* __restrict__ audio,
          int M, int C, int ka, int da) {
    __shared__ float taps[MAX_KA];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int i = tid; i < ka; i += blockDim.x * blockDim.y) taps[i] = ataps[i];
    __syncthreads();
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (c >= C || j >= M / da) return;
    float acc = 0.0f;
    for (int t = 0; t < ka; ++t) {
        const int row = j * da - t + ka - 1;
        float v;
        if (row >= ka - 1)
            v = f[(size_t)(row - (ka - 1)) * C + c];
        else
            v = TAIL ? ftail_in[(size_t)row * C + c] : 0.0f;
        acc += taps[t] * v;
    }
    if (BF16) {
        // round to nearest even, as astype(bfloat16) does
        static_cast<__nv_bfloat16*>(audio)[(size_t)j * C + c] =
            __float2bfloat16_rn(acc);
    } else {
        static_cast<float*>(audio)[(size_t)j * C + c] = acc;
    }
}

// Launch chan_rot_disc over the whole block on stream s.
template <typename T, bool TABLE>
void launch_chan(const T* xr, const T* xi, float in_gain, const float* h_re,
                 const float* h_im, const float* q, const float* r,
                 const float* theta, const float* phi0,
                 const float* prev_re, const float* prev_im, float* f,
                 float* last_re, float* last_im, float* ftail_out, int M,
                 int C, int mt, int ka, float quad_gain, cudaStream_t s) {
    const dim3 grid((C + TC - 1) / TC, (M + TM - 1) / TM);
    chan_rot_disc<T, TABLE><<<grid, 256, 0, s>>>(
        xr, xi, in_gain, h_re, h_im, q, r, theta, phi0, prev_re, prev_im, f,
        last_re, last_im, ftail_out, M, C, mt, ka, quad_gain);
}

// Launch audio_fir on stream s (ftail_in null: zeros before the block).
inline void launch_audio(const float* f, const float* ftail_in,
                         const float* ataps, void* audio, bool bf16, int M,
                         int C, int ka, int da, cudaStream_t s) {
    const dim3 block(64, 4);
    const dim3 grid((C + 63) / 64, (M / da + 3) / 4);
    if (ftail_in == nullptr)
        audio_fir<false, false><<<grid, block, 0, s>>>(f, ftail_in, ataps,
                                                       audio, M, C, ka, da);
    else if (bf16)
        audio_fir<true, true><<<grid, block, 0, s>>>(f, ftail_in, ataps,
                                                     audio, M, C, ka, da);
    else
        audio_fir<false, true><<<grid, block, 0, s>>>(f, ftail_in, ataps,
                                                      audio, M, C, ka, da);
}

}  // namespace chan
