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
// stages in psd.cuh (window x dequantization gain at the load, DFT_A and
// DFT_B as Stockham FFTs in registers, twiddle, |X|²), the blocks of a
// thread-block cluster sum their frames through distributed shared
// memory, and the last block to finish each slice of the bins adds the
// clusters' partials in order and, for the EMA form, blends prev +
// α·(new − prev), all in one launch.
//
// frame_stride s (the reference engine's per-interval spectrum) reads
// groups of fb frames: group i is frames [i·s·fb, i·s·fb + fb).  The
// window constant carries the dequantization (w2d = taps·in_scale in
// float32), so each raw int16/int8/float32 value is taken as float32
// and multiplied by it, as the TPU kernel does.
//
// Bound: bytes at FFT cost (5·N·log2 N per frame): 2 MiB of int16 rows
// for a whole bench block against 35 MFLOP, ~0.65 µs at the card's
// memory rate; launch and latency set the pace.  A frame's row is 64
// consecutive values, copied into shared memory with 16-byte cp.async.
// At frame_stride 4 (32 frames) 32 blocks of 16 warps run.  No float
// atomics: the frame sum is deterministic.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/fft.py::psd_xw_kernel_reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "psd.cuh"

namespace {

template <typename T>
cudaError_t launch_xw(const void* xw, const four_step::Consts& c,
                      const float* prev, float alpha, float* psd,
                      float* part, float* scratch, unsigned* count, int M,
                      int A, int fb, int stride, float scale,
                      cudaStream_t s) {
    constexpr int B = 64;
    const T* x = static_cast<const T*>(xw);
    const size_t frame = (size_t)A * B;
    const size_t group = frame * fb * stride;
    const size_t im_off = (size_t)M * B;
    const int kept = M / A / stride;
    return four_step::launch_psd_any<T>(
        x, 1.0f, c.w2d, frame, B, im_off, c.wa_re, c.wa_im, c.wb_re,
        c.wb_im, c.tw_re, c.tw_im, part, scratch, count, psd, A, B, kept,
        scale, s, fb, group, prev, alpha);
}

}  // namespace

// One block's PSD from the packed [2M, 64] upload xw (in_kind 0 float32,
// 1 int16, 2 int8).  consts holds the packed constants of
// fft.py::psd_pack with the window: W_A^n, W_B^n, the twiddles tw [A,
// 64] and w2d [A, 64], the window with the dequantization gain folded
// in.  Reads the M/A frames in groups of fb, every stride-th group; psd
// [A, 64] the output, in (k1, k2) order, scaled by scale and, with ema,
// blended into prev [A, 64] by alpha.  part is scratch:
// [psd_parts(M/A/stride), A·64] floats on the template path (A a power
// of two in [16, 128]), with count [CLUSTER], zero before and after a
// launch; [M/A/stride, A·64] on the general form of
// psd.cuh (any other A >= 1), which also reads scratch [M/A/stride, 2,
// A·64] when four_step::psd_two_pass(A, 64) (else it may be null).
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int sd_psd_xw(const void* xw, int in_kind, const float* consts,
                         int ema, const float* prev, float alpha,
                         float* psd, float* part, float* scratch,
                         unsigned* count, int M, int A, int B, int fb,
                         int stride, float scale, void* stream) {
    if (B != 64 || A < 1 || M < A || M % A ||
        fb < 1 || stride < 1 || (M / A) % (fb * stride) ||
        (ema && prev == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const four_step::Consts c = four_step::unpack(consts, A, B);
    const float* pv = ema ? prev : nullptr;
    cudaError_t e;
    switch (in_kind) {
    case 0:
        e = launch_xw<float>(xw, c, pv, alpha, psd, part, scratch, count, M,
                             A, fb, stride, scale, s);
        break;
    case 1:
        e = launch_xw<int16_t>(xw, c, pv, alpha, psd, part, scratch, count,
                               M, A, fb, stride, scale, s);
        break;
    case 2:
        e = launch_xw<int8_t>(xw, c, pv, alpha, psd, part, scratch, count,
                              M, A, fb, stride, scale, s);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
