// Raw channelizer bank: channelize and derotate every channel, with the
// block's mean power per channel, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/rawbank.py::_raw_kernel.
// The TPU kernel walks (channel tile, m tile) programs with the m tiles
// sequential, carrying the power sum in VMEM scratch.  Here the product
// runs over the whole block in parallel and the power is a second,
// ordered pass over per-block partials:
//
//   raw_rot    Y = Xw·H (mix-baked taps, one complex product), then row
//              m of m-tile mi times e^{-j(φ0[mi] + m_local·θ_c)}
//              -> y_re, y_im [M, C]; Σ |y|² of the block's 64 rows per
//              channel -> pow_part [M/64, C]
//   raw_power  per channel: Σ_mi (Σ of the tile's partials)/mt, in
//              tile order, times 1/m_tiles -> power [1, C]
//
// Precision: the phase φ0 + m_local·θ reaches m_tile·2π (about 12,868
// rad at m_tile 2048) in float32, where one rounding step is ~1e-3 rad.
// The reference's expression (rawbank.py:75) compiles, on XLA's CPU
// backend, to one fused multiply-add that rounds once; an unfused
// multiply and add round twice and land up to one step away.  So the
// phase is an explicit __fmaf_rn (never left to nvcc's contraction
// choice), the plain version rounds the exact float64 value once, and
// sincosf (not __sinf/__cosf) reduces the argument accurately.
//
// Bound: operations, the complex product's 8·M·K·C flops (4.3 GFLOP at
// M = 8192, K = 64, C = 1024) on the float32 CUDA cores, next to 4 MiB
// of windows read and 64 MiB of planes written.  Design: the tiling of
// channelizer2.cu stage (a): a 64x64 output tile per block, 256
// threads with a 4x4 complex register tile each, taps staged through
// shared memory in chunks of 32.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/rawbank.py::raw_kernel_reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ops.cuh"

namespace {

constexpr int TM = 64;       // rows per block (one power partial)
constexpr int TC = 64;       // channels per block
constexpr int KC = 32;       // taps per shared-memory chunk
constexpr int XS = KC + 1;   // padded row stride of the x chunk

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
    const int m0 = blockIdx.y * TM;

    float acc_re[4][4], acc_im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_re[i][j] = acc_im[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += KC) {
        for (int i = tid; i < TM * KC; i += 256) {
            const int lr = i / KC, kk = i % KC;
            const int k = k0 + kk;
            const size_t at = (size_t)(m0 + lr) * K + k;
            xs_re[lr * XS + kk] = k < K ? deq(xr[at], in_gain) : 0.0f;
            xs_im[lr * XS + kk] = k < K ? deq(xi[at], in_gain) : 0.0f;
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
            const int mi = m / mt;
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
    // the block's 64 rows per channel, summed in row-group order
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty * TC + tx + 16 * j] = psum[j];
    __syncthreads();
    if (tid < TC && c0 + tid < C) {
        float s = 0.0f;
        for (int g = 0; g < 16; ++g) s += red[g * TC + tid];
        pow_part[(size_t)blockIdx.y * C + c0 + tid] = s;
    }
}

__global__ void __launch_bounds__(256)
raw_power(const float* __restrict__ pow_part, float* __restrict__ power,
          int C, int mt, int m_tiles) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    const int per_tile = mt / TM;
    float acc = 0.0f;
    for (int mi = 0; mi < m_tiles; ++mi) {
        float s = 0.0f;
        for (int g = 0; g < per_tile; ++g)
            s += pow_part[(size_t)(mi * per_tile + g) * C + c];
        acc += s / static_cast<float>(mt);
    }
    power[c] = acc * (1.0f / static_cast<float>(m_tiles));
}

}  // namespace

// One block of the raw bank.  xr, xi are the [M, K] window planes (two
// planes, or the halves of one packed [2M, K] buffer), in_kind 0
// float32, 1 int16, 2 int8, dequantized by in_gain; h [K, C], theta
// [1, C] and phi0 [M/mt, C] float32.  Outputs y_re, y_im [M, C] and
// power [1, C]; pow_part [M/64, C] is scratch.  M and mt must be
// multiples of 64.  Launches on `stream` without synchronising and
// returns cudaGetLastError().
extern "C" int sd_rawbank(const void* xr, const void* xi, int in_kind,
                          float in_gain, const float* h_re,
                          const float* h_im, const float* theta,
                          const float* phi0, float* y_re, float* y_im,
                          float* power, float* pow_part, int M, int C,
                          int K, int mt, void* stream) {
    if (M < TM || M % TM || mt % TM || M % mt || C < 1 || K < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((C + TC - 1) / TC, M / TM);
    switch (in_kind) {
    case 0:
        raw_rot<float><<<grid, 256, 0, s>>>(
            static_cast<const float*>(xr), static_cast<const float*>(xi),
            in_gain, h_re, h_im, theta, phi0, y_re, y_im, pow_part, M, C, K,
            mt);
        break;
    case 1:
        raw_rot<int16_t><<<grid, 256, 0, s>>>(
            static_cast<const int16_t*>(xr), static_cast<const int16_t*>(xi),
            in_gain, h_re, h_im, theta, phi0, y_re, y_im, pow_part, M, C, K,
            mt);
        break;
    case 2:
        raw_rot<int8_t><<<grid, 256, 0, s>>>(
            static_cast<const int8_t*>(xr), static_cast<const int8_t*>(xi),
            in_gain, h_re, h_im, theta, phi0, y_re, y_im, pow_part, M, C, K,
            mt);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    raw_power<<<(C + 255) / 256, 256, 0, s>>>(pow_part, power, C, mt,
                                              M / mt);
    return static_cast<int>(cudaGetLastError());
}
