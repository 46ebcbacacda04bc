// Channelizer stages shared by the v2 FM kernel (channelizer2.cu), the v1
// FM kernel (channelizer.cu), the raw bank (rawbank.cu) and the audio bank
// (audio.cu).
//
//   chan_rot_disc  channelize Y = Xw·H, rotate, discriminate against the
//                  previous rotated row (recomputed as a one-row halo, or
//                  the carried row at m = 0) -> f [M, C] and its last row
//   audio_fir      banded decimating FIR over [ftail_in | f], or over f
//                  with zeros before the block -> audio [M/Da, C]
//   tail_copy      the last T rows of [tail | x]: the carried FIR tail of
//                  a block, however many rows the block has
//   raw_rot        channelize and rotate (cos/sin) with no demodulation,
//                  plus power partials of up to 64 rows inside one time
//                  tile: the raw bank (rawbank.cu) and the audio bank
//                  (audio.cu)
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
// cos/sin reads theta [1, C] and phi0 [M/mt, C].
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
              int M, int C, int mt, float quad_gain) {
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
    for (int i = tid; i < TM * TC; i += 256) {
        const int lr = 1 + i / TC, cc = i % TC;
        const int c = c0 + cc, m = m0 - 1 + lr;
        if (c >= C || m >= M) continue;
        const float rr = ys_re[lr * YS + cc], ri = ys_im[lr * YS + cc];
        const float pr = ys_re[(lr - 1) * YS + cc];
        const float pi = ys_im[(lr - 1) * YS + cc];
        const float dr = rr * pr + ri * pi;
        const float di = ri * pr - rr * pi;
        f[(size_t)m * C + c] = sd_atan2(di, dr) * quad_gain;
        if (m == M - 1) {
            last_re[c] = rr;
            last_im[c] = ri;
        }
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

// The carried tail of a block: out[r] = ext[n + r] over
// ext = [tail (T rows) | x (n rows)], r < T.  With n >= T it is the last
// T rows of x; with n < T it starts inside the old tail.
__global__ void tail_copy(const float* __restrict__ tail,
                          const float* __restrict__ x,
                          float* __restrict__ out, int T, int n, int C) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= T * C) return;
    const int r = k / C, c = k % C;
    const int e = n + r;
    out[k] = e < T ? tail[(size_t)e * C + c] : x[(size_t)(e - T) * C + c];
}

// Row blocks of raw_rot per m-tile (host and device: the power passes
// sum that many partials per tile).
__host__ __device__ inline int raw_groups(int mt) {
    return (mt + TM - 1) / TM;
}

// Channelize and rotate with no demodulation, the raw bank's stage and the
// audio bank's first one: Y = Xw·H (K taps, any K, in chunks of KC), row m
// of m-tile mi times e^{-j(φ0[mi] + m_local·θ_c)} (the phase an explicit
// __fmaf_rn, rounded once) -> y_re, y_im [M, C].  Each m-tile is covered
// by gpt = ceil(mt/64) row blocks, the last one ragged when 64 does not
// divide mt, so no block straddles two tiles: block (mi, g) holds rows
// mi·mt + 64g .. min(+64, (mi+1)·mt) and writes Σ |y|² of its rows per
// channel to pow_part [M/mt·gpt, C], row mi·gpt + g.  mt | M.
template <typename T>
__global__ void __launch_bounds__(256)
raw_rot(const T* __restrict__ xr, const T* __restrict__ xi, float in_gain,
        const float* __restrict__ h_re, const float* __restrict__ h_im,
        const float* __restrict__ theta, const float* __restrict__ phi0,
        float* __restrict__ y_re, float* __restrict__ y_im,
        float* __restrict__ pow_part, int M, int C, int K, int mt) {
    __shared__ float xs_re[TM * XS];
    __shared__ float xs_im[TM * XS];
    __shared__ float hs_re[KC * TC];
    __shared__ float hs_im[KC * TC];
    __shared__ float red[16 * TC];

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int c0 = blockIdx.x * TC;
    const int gpt = raw_groups(mt);
    const int mi = blockIdx.y / gpt;
    const int m0 = mi * mt + (blockIdx.y % gpt) * TM;
    const int m_end = (mi + 1) * mt;      // rows from here are the next tile's

    float acc_re[4][4], acc_im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_re[i][j] = acc_im[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += KC) {
        for (int i = tid; i < TM * KC; i += 256) {
            const int lr = i / KC, kk = i % KC;
            const int k = k0 + kk;
            const bool in = k < K && m0 + lr < m_end;
            const size_t at = (size_t)(m0 + lr) * K + k;
            xs_re[lr * XS + kk] = in ? deq(xr[at], in_gain) : 0.0f;
            xs_im[lr * XS + kk] = in ? deq(xi[at], in_gain) : 0.0f;
        }
        for (int i = tid; i < KC * TC; i += 256) {
            const int kk = i / TC, c = c0 + i % TC;
            const bool in = c < C && k0 + kk < K;
            hs_re[i] = in ? h_re[(size_t)(k0 + kk) * C + c] : 0.0f;
            hs_im[i] = in ? h_im[(size_t)(k0 + kk) * C + c] : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
            float ar[4], ai[4], br[4], bi[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                ar[i] = xs_re[(ty * 4 + i) * XS + kk];
                ai[i] = xs_im[(ty * 4 + i) * XS + kk];
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
        __syncthreads();
    }

    // rotate: ph = φ0[mi] + m_local·θ, rounded once
    float psum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c >= C) continue;
        const float th = theta[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = m0 + ty * 4 + i;
            if (m >= m_end) continue;
            const float ml = static_cast<float>(m - mi * mt);
            const float ph = __fmaf_rn(ml, th, phi0[(size_t)mi * C + c]);
            float sn, cs;
            sincosf(ph, &sn, &cs);
            const float ci = -sn;
            const float yr = acc_re[i][j], yi = acc_im[i][j];
            const float rr = yr * cs - yi * ci;
            const float ri = yr * ci + yi * cs;
            y_re[(size_t)m * C + c] = rr;
            y_im[(size_t)m * C + c] = ri;
            psum[j] += rr * rr + ri * ri;
        }
    }
    // the block's rows per channel, summed in row-group order
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty * TC + tx + 16 * j] = psum[j];
    __syncthreads();
    if (tid < TC && c0 + tid < C) {
        float s = 0.0f;
        for (int g = 0; g < 16; ++g) s += red[g * TC + tid];
        pow_part[(size_t)blockIdx.y * C + c0 + tid] = s;
    }
}

// Launch chan_rot_disc over the whole block on stream s.
template <typename T, bool TABLE>
void launch_chan(const T* xr, const T* xi, float in_gain, const float* h_re,
                 const float* h_im, const float* q, const float* r,
                 const float* theta, const float* phi0,
                 const float* prev_re, const float* prev_im, float* f,
                 float* last_re, float* last_im, int M, int C, int mt,
                 float quad_gain, cudaStream_t s) {
    const dim3 grid((C + TC - 1) / TC, (M + TM - 1) / TM);
    chan_rot_disc<T, TABLE><<<grid, 256, 0, s>>>(
        xr, xi, in_gain, h_re, h_im, q, r, theta, phi0, prev_re, prev_im, f,
        last_re, last_im, M, C, mt, quad_gain);
}

// Launch tail_copy on stream s: out [T, C] = the last T rows of
// [tail (T rows) | x (n rows)].
inline void launch_tail(const float* tail, const float* x, float* out, int T,
                        int n, int C, cudaStream_t s) {
    const int total = T * C;
    tail_copy<<<(total + 255) / 256, 256, 0, s>>>(tail, x, out, T, n, C);
}

// The grid of raw_rot over M rows.
inline dim3 raw_grid(int M, int C, int mt) {
    return dim3((C + TC - 1) / TC, (M / mt) * raw_groups(mt));
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
