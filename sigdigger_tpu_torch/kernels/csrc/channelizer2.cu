// Fused FM channelizer with the fused four-step PSD, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/channelizer2.py::_kernel2
// with fuse_psd=True and the table rotator.  The TPU kernel walks a
// sequential time grid and carries the previous row and the FIR tail in
// VMEM scratch from one grid step to the next.  None of the work inside
// a block is recurrent, so here every stage runs over the whole block in
// parallel and only the block boundary carries state:
//
//   (a) chan_rot_disc  channelize Y = Xw·H, rotate by Q[m/64]·R[m%64],
//                      discriminate against the previous rotated row
//                      (recomputed as a one-row halo, or the carried
//                      row at m = 0) -> f [M, C], last row, f tail
//   (b) audio_fir      banded decimating FIR over [ftail_in | f]
//                      -> audio [M/Da, C] (f32 or bf16)
//   (c) psd_frames     one 4096-point four-step DFT per frame of 64
//                      packed rows -> |X|^2 partial per frame
//   (d) psd_sum        sum of the partials in frame order, times the
//                      scale -> PSD [64, 64] in (k1, k2) order
//   (c) and (d) are the shared stages of psd.cuh at A = B = 64, with the
//   window applied in the kernel.
//
// Carries are written to fresh output buffers, never over an input
// another block still reads.  Everything is float32 on the CUDA cores
// (no TF32).  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/channelizer2.py::kernel2_reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ops.cuh"
#include "psd.cuh"

namespace {

constexpr int K = 64;        // taps per window == decimation == PSD B
constexpr int TM = 64;       // (a): rows per block
constexpr int TC = 64;       // (a): channels per block
constexpr int KC = 32;       // (a): taps per shared-memory chunk
constexpr int XS = KC + 1;   // (a): padded row stride of the x chunk
constexpr int YS = TC + 1;   // (a): padded row stride of the Y tile
constexpr int MAX_KA = 256;  // (b): audio taps held in shared memory

// (a) Channelize, rotate, discriminate.
//
// Bound: the complex product, 8·M·K·C flops (4.3 GFLOP per block at
// M = 8192, C = 1024) on the float32 CUDA cores; it reads 2 MiB (int16)
// of windows and writes the 32 MiB f scratch.  Design: a 64x64 output
// tile per block, 256 threads with a 4x4 complex register tile each,
// taps staged through shared memory in two chunks of 32 so the block
// stays under 48 KB and several blocks share an SM.  The one-row halo
// Y[m0-1] costs 1/64 extra work and removes any ordering between
// blocks.  The rotation and discriminator run from the shared Y tile
// with consecutive threads on consecutive channels, so the Q/R reads
// and the f writes are coalesced.
template <typename T>
__global__ void __launch_bounds__(256)
chan_rot_disc(const T* __restrict__ xw, float in_gain,
              const float* __restrict__ h_re, const float* __restrict__ h_im,
              const float* __restrict__ q, const float* __restrict__ r,
              const float* __restrict__ prev_re,
              const float* __restrict__ prev_im,
              float* __restrict__ f, float* __restrict__ last_re,
              float* __restrict__ last_im, float* __restrict__ ftail_out,
              int M, int C, int mt, int ka, float quad_gain) {
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
            if (m >= 0) {
                vr = deq(xw[(size_t)m * K + k0 + kk], in_gain);
                vi = deq(xw[(size_t)(M + m) * K + k0 + kk], in_gain);
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
                const float xr = xs_re[kk], xi = xs_im[kk];
                const float hr = hs_re[kk * TC + tid];
                const float hi = hs_im[kk * TC + tid];
                hal_re += xr * hr - xi * hi;
                hal_im += xr * hi + xi * hr;
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

    // rotate row m by Q[m/64]·R[m%64] (channelizer2.py:164-176); the
    // halo of the first tile is the carried, already rotated, row
    const int qs = mt >> 6;
    for (int i = tid; i < (TM + 1) * TC; i += 256) {
        const int lr = i / TC, cc = i % TC;
        const int c = c0 + cc, m = m0 - 1 + lr;
        if (c >= C) continue;
        float rr, ri;
        if (m < 0) {
            rr = prev_re[c];
            ri = prev_im[c];
        } else {
            const int mi = m / mt, g = (m % mt) >> 6, rw = m & 63;
            const float qre = q[(size_t)(mi * 2 * qs + g) * C + c];
            const float qim = q[(size_t)(mi * 2 * qs + qs + g) * C + c];
            const float rre = r[(size_t)rw * C + c];
            const float rim = r[(size_t)(64 + rw) * C + c];
            const float cr = qre * rre - qim * rim;
            const float ci = qre * rim + qim * rre;
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
        if (c >= C) continue;
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
        if (m >= tail0) ftail_out[(size_t)(m - tail0) * C + c] = fv;
    }
}

// (b) Banded decimating audio FIR:
//   audio[j, c] = Σ_t a[t] · f_ext[j·Da − t + Ka − 1, c],
//   f_ext = [ftail_in (Ka−1 rows) | f (M rows)]
// the indexing of the reference's banded matrix (_local_band).
//
// Bound: bytes.  2·Ka·(M/Da)·C flops (34 MFLOP) against the 32 MiB f
// scratch read once (each f row feeds Ka/Da = 2 audio rows, the second
// read hits L2).  Design: one thread per output, consecutive threads on
// consecutive channels so every tap's row read is one coalesced line.
template <bool BF16>
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
        const float v = row < ka - 1
            ? ftail_in[(size_t)row * C + c]
            : f[(size_t)(row - (ka - 1)) * C + c];
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

template <typename T>
cudaError_t launch_input_stages(
    const void* xw, float in_gain, const float* h_re, const float* h_im,
    const float* q, const float* r, const float* prev_re,
    const float* prev_im, const float* w2d, const float* w64_re,
    const float* w64_im, const float* tw_re, const float* tw_im,
    float* last_re, float* last_im, float* ftail_out, float* f_scr,
    float* psd_part, float* psd, int M, int C, int mt, int ka,
    float quad_gain, float psd_scale, cudaStream_t s) {
    const T* x = static_cast<const T*>(xw);
    const dim3 grid_a((C + TC - 1) / TC, M / TM);
    chan_rot_disc<T><<<grid_a, 256, 0, s>>>(
        x, in_gain, h_re, h_im, q, r, prev_re, prev_im, f_scr, last_re,
        last_im, ftail_out, M, C, mt, ka, quad_gain);
    // (c) + (d): frame f is rows [64f, 64f+64) of both planes
    return four_step::launch_psd<T, 64, 64>(
        x, in_gain, w2d, (size_t)64 * K, K, (size_t)M * K, w64_re, w64_im,
        w64_re, w64_im, tw_re, tw_im, psd_part, psd, M / 64, psd_scale, s);
}

}  // namespace

// One block of the fused FM receiver.  xw is the packed [2M, 64] upload
// (in_kind 0 float32, 1 int16, 2 int8, dequantized by in_gain); the
// carries are prev_re/prev_im [1, C] and ftail_in [Ka−1, C]; outputs go
// to fresh buffers.  f_scr [M, C] and psd_part [M/64, 64, 64] are
// scratch.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int sd_kernel2(
    const void* xw, int in_kind, float in_gain,
    const float* h_re, const float* h_im, const float* q, const float* r,
    const float* prev_re, const float* prev_im, const float* ftail_in,
    const float* ataps, const float* w2d, const float* w64_re,
    const float* w64_im, const float* tw_re, const float* tw_im,
    void* audio, int audio_bf16, float* last_re, float* last_im,
    float* ftail_out, float* psd, float* f_scr, float* psd_part,
    int M, int C, int mt, int ka, int da, float quad_gain, float psd_scale,
    void* stream) {
    if (M % 256 || mt % 64 || M % mt || ka < 2 || ka > MAX_KA ||
        M < ka || da < 1 || M % da || C < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    switch (in_kind) {
    case 0:
        e = launch_input_stages<float>(
            xw, in_gain, h_re, h_im, q, r, prev_re, prev_im, w2d, w64_re,
            w64_im, tw_re, tw_im, last_re, last_im, ftail_out, f_scr,
            psd_part, psd, M, C, mt, ka, quad_gain, psd_scale, s);
        break;
    case 1:
        e = launch_input_stages<int16_t>(
            xw, in_gain, h_re, h_im, q, r, prev_re, prev_im, w2d, w64_re,
            w64_im, tw_re, tw_im, last_re, last_im, ftail_out, f_scr,
            psd_part, psd, M, C, mt, ka, quad_gain, psd_scale, s);
        break;
    case 2:
        e = launch_input_stages<int8_t>(
            xw, in_gain, h_re, h_im, q, r, prev_re, prev_im, w2d, w64_re,
            w64_im, tw_re, tw_im, last_re, last_im, ftail_out, f_scr,
            psd_part, psd, M, C, mt, ka, quad_gain, psd_scale, s);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 block_b(64, 4);
    const dim3 grid_b((C + 63) / 64, (M / da + 3) / 4);
    if (audio_bf16)
        audio_fir<true><<<grid_b, block_b, 0, s>>>(f_scr, ftail_in, ataps,
                                                   audio, M, C, ka, da);
    else
        audio_fir<false><<<grid_b, block_b, 0, s>>>(f_scr, ftail_in, ataps,
                                                    audio, M, C, ka, da);
    return static_cast<int>(cudaGetLastError());
}
