// Four-step mean PSD of host-windowed frames, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/fft.py::_psd_kernel.
// The TPU kernel batches Fb frames per grid step into MXU shapes: one
// [A, A]x[A, Fb·B] product for DFT_A, a block-diagonal [Fb·B, Fb·B]
// DFT_B and a 0/1 frame-sum matrix, accumulated across the sequential
// grid.  None of those shapes is math: here each frame is one block of
// the shared stages in psd.cuh (DFT_A and DFT_B as radix-8/4 Stockham
// FFTs in registers, the twiddle, |X|²), the blocks of a thread-block
// cluster sum their frames through distributed shared memory, and the
// last block to finish each slice of the bins sums the clusters'
// partials in order, all in one launch.
//
// Input: the packed [2A, F·B] upload of native.frame_psd_packed, float32
// or int16 (dequantized by in_gain), element (a, f·B+b) = x[f·N + a·B +
// b]·w[a·B + b], rows [0, A) real and [A, 2A) imaginary.  Output: the
// block's mean PSD [A, B] in (k1, k2) order, times scale.
//
// Bound: bytes.  A block reads 8 bytes per sample (4 MiB at N = 4096,
// F = 128) and does 5·N·log2 N flops per frame (31.5 MFLOP), so the
// card could finish in ~1.3 µs; launch latency and the DRAM latency of
// a block's first rows set the pace.  Design: one 512-thread block per
// frame (16 warps an SM at F = 128) so all frames run at once; a frame's
// row is B consecutive elements of a row of F·B, copied with 16-byte
// cp.async.  No float atomics: the frame sum is deterministic.
// The plain PyTorch version is
// sigdigger_tpu_torch/kernels/fft.py::psd_kernel_reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "psd.cuh"

// One block's PSD.  x is [2A, F·B] (in_kind 0 float32, 1 int16);
// consts the packed constants of fft.py::psd_pack (W_A^n, W_B^n, the
// twiddles tw [A, B]); psd [A, B] the output.  part is scratch:
// [psd_parts(F), A·B] floats on the template path (A, B powers of two in
// [16, 128]), with count [CLUSTER], zero before and after a launch;
// [F, A·B] on the general form (psd.cuh), which also reads scratch [F,
// 2, A·B] when four_step::psd_two_pass(A, B) (else it may be null).
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int sd_psd(const void* x, int in_kind, float in_gain,
                      const float* consts, float* psd, float* part,
                      float* scratch, unsigned* count, int A, int B, int F,
                      float scale, void* stream) {
    if (A < 1 || B < 1 || F < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const four_step::Consts c = four_step::unpack(consts, A, B);
    const size_t row = (size_t)F * B;
    const size_t im_off = (size_t)A * row;
    cudaError_t e;
    switch (in_kind) {
    case 0:
        e = four_step::launch_psd_any<float>(
            static_cast<const float*>(x), in_gain, nullptr, B, row, im_off,
            c.wa_re, c.wa_im, c.wb_re, c.wb_im, c.tw_re, c.tw_im, part,
            scratch, count, psd, A, B, F, scale, s);
        break;
    case 1:
        e = four_step::launch_psd_any<int16_t>(
            static_cast<const int16_t*>(x), in_gain, nullptr, B, row,
            im_off, c.wa_re, c.wa_im, c.wb_re, c.wb_im, c.tw_re, c.tw_im,
            part, scratch, count, psd, A, B, F, scale, s);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
