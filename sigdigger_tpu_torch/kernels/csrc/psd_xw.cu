// Four-step mean PSD read from the channelizer's packed window upload,
// with an optional running-PSD blend, for Hopper (sm_90a).
//
// Replaces the TPU kernels sigdigger_tpu/kernels/fft.py::_psd_kernel_xw
// and ::_psd_kernel_xw_ema.  With the channelizer's window width equal
// to its decimation and to B, frame f of the PSD, x[a·B + b], is rows
// [f·A, (f+1)·A) of each plane of the [2M, B] upload verbatim, so the
// PSD needs no framing or upload of its own.  The TPU kernels stack Fb
// frames into MXU shapes: a block-diagonal [Fb·A, Fb·A] DFT_A, one
// [Fb·A, B] x DFT_B product and a 0/1 frame-sum matmul, accumulated
// across the sequential grid, the EMA in the last program.  None of
// those shapes is math: here each frame read is one block of the shared
// stages in psd.cuh (window x dequantization gain, DFT_A, twiddle, DFT_B,
// |X|² into a per-frame partial), and psd_sum adds the partials in frame
// order and, for the EMA form, blends prev + α·(new − prev).
//
// frame_stride s (the reference engine's per-interval spectrum) reads
// groups of fb frames: group i is frames [i·s·fb, i·s·fb + fb).  The
// window constant carries the dequantization (w2d = taps·in_scale in
// float32), so each raw int16/int8/float32 value is taken as float32
// and multiplied by it, as the TPU kernel does.
//
// Bound: bytes at FFT cost (5·N·log2 N per frame): 2 MiB of int16 rows
// for a whole bench block against 35 MFLOP.  The dense DFTs do
// 2·8·N·(A+B) flops per frame, so the kernel's own arithmetic sets its
// pace, as for psd.cu.  No float atomics: the frame sum is
// deterministic.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/fft.py::psd_xw_kernel_reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "psd.cuh"

namespace {

template <typename T>
cudaError_t launch_xw(const void* xw, const float* w2d, const float* wa_re,
                      const float* wa_im, const float* wb_re,
                      const float* wb_im, const float* tw_re,
                      const float* tw_im, const float* prev, float alpha,
                      float* psd, float* part, float* scratch, int M, int A,
                      int fb, int stride, float scale, cudaStream_t s) {
    constexpr int B = 64;
    const T* x = static_cast<const T*>(xw);
    const size_t frame = (size_t)A * B;
    const size_t group = frame * fb * stride;
    const size_t im_off = (size_t)M * B;
    const int kept = M / A / stride;
    return four_step::launch_psd_any<T>(
        x, 1.0f, w2d, frame, B, im_off, wa_re, wa_im, wb_re, wb_im, tw_re,
        tw_im, part, scratch, psd, A, B, kept, scale, s, fb, group, prev,
        alpha);
}

}  // namespace

// One block's PSD from the packed [2M, 64] upload xw (in_kind 0 float32,
// 1 int16, 2 int8).  w2d [A, 64] is the window with the dequantization
// gain folded in; wa/wb are W_A^n and W_B^n, tw [A, 64] the twiddles.
// Reads the M/A frames in groups of fb, every stride-th group; part
// [M/A/stride, A, 64] is scratch; psd [A, 64] the output, in (k1, k2)
// order, scaled by scale and, with ema, blended into prev [A, 64] by
// alpha.  Any A >= 1 (the general form of psd.cuh outside A in 16..128
// powers of two; scratch [M/A/stride, 2, A·64] read only when
// four_step::psd_two_pass(A, 64), else it may be null).  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int sd_psd_xw(const void* xw, int in_kind, const float* w2d,
                         const float* wa_re, const float* wa_im,
                         const float* wb_re, const float* wb_im,
                         const float* tw_re, const float* tw_im, int ema,
                         const float* prev, float alpha, float* psd,
                         float* part, float* scratch, int M, int A, int B,
                         int fb, int stride, float scale, void* stream) {
    if (B != 64 || A < 1 || M < A || M % A ||
        fb < 1 || stride < 1 || (M / A) % (fb * stride) ||
        (ema && prev == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* pv = ema ? prev : nullptr;
    cudaError_t e;
    switch (in_kind) {
    case 0:
        e = launch_xw<float>(xw, w2d, wa_re, wa_im, wb_re, wb_im, tw_re,
                             tw_im, pv, alpha, psd, part, scratch, M, A, fb,
                             stride, scale, s);
        break;
    case 1:
        e = launch_xw<int16_t>(xw, w2d, wa_re, wa_im, wb_re, wb_im, tw_re,
                               tw_im, pv, alpha, psd, part, scratch, M, A,
                               fb, stride, scale, s);
        break;
    case 2:
        e = launch_xw<int8_t>(xw, w2d, wa_re, wa_im, wb_re, wb_im, tw_re,
                              tw_im, pv, alpha, psd, part, scratch, M, A, fb,
                              stride, scale, s);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
