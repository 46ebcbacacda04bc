// Four-step mean PSD of host-windowed frames, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/fft.py::_psd_kernel.
// The TPU kernel batches Fb frames per grid step into MXU shapes: one
// [A, A]x[A, Fb·B] product for DFT_A, a block-diagonal [Fb·B, Fb·B]
// DFT_B and a 0/1 frame-sum matrix, accumulated across the sequential
// grid.  None of those shapes is math: here each frame is one block of
// the shared stages in psd.cuh (DFT_A, twiddle, DFT_B and |X|² into a
// per-frame partial), and a second pass sums the partials in frame
// order.
//
// Input: the packed [2A, F·B] upload of native.frame_psd_packed, float32
// or int16 (dequantized by in_gain), element (a, f·B+b) = x[f·N + a·B +
// b]·w[a·B + b], rows [0, A) real and [A, 2A) imaginary.  Output: the
// block's mean PSD [A, B] in (k1, k2) order, times scale.
//
// Bound: bytes.  The FFT-cost work of a block (5·N·log2 N per frame)
// is small next to the 8 bytes per sample read (4 MiB at N = 4096,
// F = 128).  The dense DFTs here do 2·8·N·(A+B) flops per frame (1.07
// GFLOP per block at N = 4096, F = 128), so the kernel's own
// arithmetic, not the bytes, sets its pace; an FFT-shaped DFT_A/DFT_B
// is later work.  Design: one block per frame so all F frames run at
// once; a frame's row is B consecutive elements of a row of F·B.  No
// float atomics: the frame sum is deterministic.
// The plain PyTorch version is
// sigdigger_tpu_torch/kernels/fft.py::psd_kernel_reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "psd.cuh"

// One block's PSD.  x is [2A, F·B] (in_kind 0 float32, 1 int16); wa/wb
// are W_A^n and W_B^n (n < A, n < B); tw [A, B] the twiddles; part
// [F, A, B] is scratch, and so is scratch [F, 2, A·B] (read only when
// four_step::psd_two_pass(A, B), else it may be null); psd [A, B] the
// output.  Any A, B >= 1: the template stages at powers of two in
// [16, 128], the general form (psd.cuh) at the others.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int sd_psd(const void* x, int in_kind, float in_gain,
                      const float* wa_re, const float* wa_im,
                      const float* wb_re, const float* wb_im,
                      const float* tw_re, const float* tw_im, float* psd,
                      float* part, float* scratch, int A, int B, int F,
                      float scale, void* stream) {
    if (A < 1 || B < 1 || F < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t row = (size_t)F * B;
    const size_t im_off = (size_t)A * row;
    cudaError_t e;
    switch (in_kind) {
    case 0:
        e = four_step::launch_psd_any<float>(
            static_cast<const float*>(x), in_gain, nullptr, B, row, im_off,
            wa_re, wa_im, wb_re, wb_im, tw_re, tw_im, part, scratch, psd, A,
            B, F, scale, s);
        break;
    case 1:
        e = four_step::launch_psd_any<int16_t>(
            static_cast<const int16_t*>(x), in_gain, nullptr, B, row,
            im_off, wa_re, wa_im, wb_re, wb_im, tw_re, tw_im, part, scratch,
            psd, A, B, F, scale, s);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
