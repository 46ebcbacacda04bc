// Raw channelizer bank: channelize and derotate every channel, with the
// block's mean power per channel, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/rawbank.py::_raw_kernel.
// The TPU kernel walks (channel tile, m tile) programs with the m tiles
// sequential, carrying the power sum in VMEM scratch.  Here the product
// runs over the whole block in parallel and the power is a second,
// ordered pass over per-block partials:
//
//   raw_rot_tc  Y = Xw·H (mix-baked taps) as one real GEMM on the
//               tensor cores, then row m of m-tile mi times
//               e^{-j(φ0[mi] + m_local·θ_c)} -> y_re, y_im [M, C];
//               Σ |y|² of the tile's rows per channel -> pow_part
//               [M/mt·ceil(mt/64), C], each 64-row tile inside one
//               m-tile (the last of a tile ragged when 64 does not
//               divide mt)
//   raw_power   per channel: Σ_mi (Σ of the tile's partials)/mt, in
//               tile order, times 1/m_tiles -> power [1, C]
//
// Precision: the product is 3xTF32 (chan.cuh, namespace tc), within
// 1e-5 of the largest value of the float32 plain version.  The phase
// φ0 + m_local·θ reaches m_tile·2π (about 12,868 rad at m_tile 2048) in
// float32, where one rounding step is ~1e-3 rad.  The reference's
// expression (rawbank.py:75) compiles, on XLA's CPU backend, to one
// fused multiply-add that rounds once; an unfused multiply and add round
// twice and land up to one step away.  So the phase is an explicit
// __fmaf_rn (never left to nvcc's contraction choice), the plain version
// rounds the exact float64 value once, and sincosf (not __sinf/__cosf)
// reduces the argument accurately.
//
// Bound: operations, the product's 3 passes × 8·M·K·C flops (12.9 GFLOP
// at M = 8192, K = 64, C = 1024) on the TF32 tensor cores, 0.026 ms,
// next to 4 MiB of windows read and 64 MiB of planes written (0.020
// ms).  Design: chan.cuh's tensor-core core (a block per 32 channels
// with its B slice resident in shared memory, three warpgroups walking
// 64-row tiles, 3 wgmma a k-step), with the rotation and the power
// partial in the epilogue.  B = [[h_re, h_im], [−h_im, h_re]] comes
// transposed and interleaved from the wrapper (bmat [2C, 2Kp],
// kernels/tcsplit.py::tc_bmat).  K up to 88 (the B slice and the
// staging fit a block's shared memory).  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/rawbank.py::raw_kernel_reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chan.cuh"

namespace {

__global__ void __launch_bounds__(256)
raw_power(const float* __restrict__ pow_part, float* __restrict__ power,
          int C, int mt, int m_tiles) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    const int per_tile = chan::raw_groups(mt);
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
// float32, 1 int16, 2 int8, dequantized by in_gain; bmat [2C, 2·Kp]
// (Kp = K rounded up to 8), theta [1, C] and phi0 [M/mt, C] float32.
// Outputs y_re, y_im [M, C] and power [1, C]; pow_part
// [M/mt·ceil(mt/64), C] is scratch.  mt must divide M.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int sd_rawbank(const void* xr, const void* xi, int in_kind,
                          float in_gain, const float* bmat,
                          const float* theta, const float* phi0,
                          float* y_re, float* y_im, float* power,
                          float* pow_part, int M, int C, int K, int mt,
                          void* stream) {
    if (M < 1 || mt < 1 || M % mt || C < 1 || K < 1 ||
        chan::tc::smem_bytes(chan::tc::kpad(K)) > chan::tc::SMEM_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    switch (in_kind) {
    case 0:
        e = chan::tc::launch_raw(static_cast<const float*>(xr),
                                 static_cast<const float*>(xi), in_gain,
                                 bmat, theta, phi0, y_re, y_im, pow_part, M,
                                 C, K, mt, s);
        break;
    case 1:
        e = chan::tc::launch_raw(static_cast<const int16_t*>(xr),
                                 static_cast<const int16_t*>(xi), in_gain,
                                 bmat, theta, phi0, y_re, y_im, pow_part, M,
                                 C, K, mt, s);
        break;
    case 2:
        e = chan::tc::launch_raw(static_cast<const int8_t*>(xr),
                                 static_cast<const int8_t*>(xi), in_gain,
                                 bmat, theta, phi0, y_re, y_im, pow_part, M,
                                 C, K, mt, s);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    raw_power<<<(C + 255) / 256, 256, 0, s>>>(pow_part, power, C, mt,
                                              M / mt);
    return static_cast<int>(cudaGetLastError());
}
