// FM channelizer v2 with the optional fused four-step PSD, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/channelizer2.py::_kernel2
// in all its forms: the table or the cos/sin rotator, with or without
// the fused PSD.  The TPU kernel walks a sequential time grid and carries
// the previous row and the FIR tail in VMEM scratch from one grid step to
// the next.  None of the work inside a block is recurrent, so here every
// stage runs over the whole block in parallel and only the block
// boundary carries state:
//
//   (a) chan_rot_disc_tc  channelize Y = Xw·H on the tensor cores
//                      (3xTF32, chan.cuh namespace tc), rotate
//                      (Q[m/64]·R[m%64] or cos/sin of φ0[mi] +
//                      m_local·θ), discriminate against the previous
//                      rotated row -> f [M, C], last row
//   (b) audio_fir      banded decimating FIR over [ftail_in | f]
//                      -> audio [M/Da, C] (f32 or bf16) (chan.cuh)
//       tail_copy      the last Ka-1 rows of [ftail_in | f], the next
//                      block's FIR tail, also when M < Ka-1 (chan.cuh)
//   (c) psd_frames     with the fused PSD: one 4096-point four-step FFT
//                      per frame of 64 packed rows (radix-8 Stockham
//                      passes in registers), the |X|^2 of each cluster
//                      of 8 frames summed through distributed shared
//                      memory, the clusters' partials by the last block
//                      of each bin slice, times the scale -> PSD [64, 64]
//                      in (k1, k2) order
//   (c) is the shared stage of psd.cuh at A = B = 64, with the window
//   applied in the kernel; without the fused PSD it is skipped.
//
// Carries are written to fresh output buffers, never over an input
// another block still reads.  The channelize product runs on the TF32
// tensor cores as three passes of hi/lo parts (3xTF32: within float32
// rounding of the plain version, see chan.cuh); everything else is
// float32 on the CUDA cores.  Bound (stage (a) alone): 3 × 8·M·K·C
// flops at the TF32 peak, 0.026 ms at M 8192, C 1024, beside the 2 MiB
// of int16 windows and the 32 MiB f scratch.  The plain PyTorch version
// is sigdigger_tpu_torch/kernels/channelizer2.py::kernel2_reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chan.cuh"
#include "psd.cuh"

namespace {

template <typename T, bool TABLE>
cudaError_t launch_input_stages(
    const void* xw, float in_gain, const float* bmat, const float* q,
    const float* r, const float* theta, const float* phi0,
    const float* prev_re, const float* prev_im, const float* w2d,
    const float* w64_re, const float* w64_im, const float* tw_re,
    const float* tw_im, float* last_re, float* last_im, float* f_scr,
    float* psd_part, unsigned* psd_count, float* psd, int M, int C,
    int mt, float quad_gain, float psd_scale, cudaStream_t s) {
    const T* x = static_cast<const T*>(xw);
    const cudaError_t e = chan::tc::launch_chan<T, TABLE>(
        x, x + (size_t)M * chan::K, in_gain, bmat, q, r, theta, phi0,
        prev_re, prev_im, f_scr, last_re, last_im, M, C, mt, quad_gain, s);
    if (e != cudaSuccess || psd == nullptr) return e;
    // (c): frame f is rows [64f, 64f+64) of both planes
    return four_step::launch_psd<T, 64, 64>(
        x, in_gain, w2d, (size_t)64 * chan::K, chan::K,
        (size_t)M * chan::K, w64_re, w64_im, w64_re, w64_im, tw_re, tw_im,
        psd_part, psd_count, psd, M / 64, psd_scale, s);
}

template <typename T>
cudaError_t launch_rotator(
    bool table, const void* xw, float in_gain, const float* bmat,
    const float* q, const float* r, const float* theta, const float* phi0,
    const float* prev_re, const float* prev_im, const float* w2d,
    const float* w64_re, const float* w64_im, const float* tw_re,
    const float* tw_im, float* last_re, float* last_im, float* f_scr,
    float* psd_part, unsigned* psd_count, float* psd, int M, int C,
    int mt, float quad_gain, float psd_scale, cudaStream_t s) {
    if (table)
        return launch_input_stages<T, true>(
            xw, in_gain, bmat, q, r, theta, phi0, prev_re, prev_im, w2d,
            w64_re, w64_im, tw_re, tw_im, last_re, last_im, f_scr,
            psd_part, psd_count, psd, M, C, mt, quad_gain, psd_scale, s);
    return launch_input_stages<T, false>(
        xw, in_gain, bmat, q, r, theta, phi0, prev_re, prev_im, w2d,
        w64_re, w64_im, tw_re, tw_im, last_re, last_im, f_scr, psd_part,
        psd_count, psd, M, C, mt, quad_gain, psd_scale, s);
}

}  // namespace

// One block of the FM receiver.  xw is the packed [2M, 64] upload
// (in_kind 0 float32, 1 int16, 2 int8, dequantized by in_gain); bmat
// [2C, 128] the taps as the tensor-core product reads them.  The
// rotator is the table one (table_rot: q [M/64·2, C], r [128, C]) or the
// cos/sin one (theta [1, C], phi0 [M/mt, C]); the carries are prev_re /
// prev_im [1, C] and ftail_in [Ka−1, C]; outputs go to fresh buffers.
// With fuse_psd the block's PSD [64, 64] goes to psd (w2d, w64, tw its
// constants, psd_part [four_step::psd_parts(M/64), 64, 64] and
// psd_count [four_step::CLUSTER] scratch, the count zero before and
// after a launch); otherwise those pointers are unused.  f_scr [M, C]
// is scratch.  Needs M % mt == 0 and mt % da == 0, plus mt % 64 == 0 for
// the tables and M % 64 == 0 for the fused PSD.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int sd_kernel2(
    const void* xw, int in_kind, float in_gain, const float* bmat,
    int table_rot, const float* q, const float* r,
    const float* theta, const float* phi0, const float* prev_re,
    const float* prev_im, const float* ftail_in, const float* ataps,
    int fuse_psd, const float* w2d, const float* w64_re,
    const float* w64_im, const float* tw_re, const float* tw_im,
    void* audio, int audio_bf16, float* last_re, float* last_im,
    float* ftail_out, float* psd, float* f_scr, float* psd_part,
    unsigned* psd_count, int M, int C, int mt, int ka, int da,
    float quad_gain, float psd_scale, void* stream) {
    if (M < 1 || C < 1 || mt < 1 || da < 1 || M % mt || mt % da ||
        ka < 2 || ka > chan::MAX_KA || (table_rot && mt % 64) ||
        (fuse_psd && M % 64))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* psd_out = fuse_psd ? psd : nullptr;
    const bool table = table_rot != 0;
    cudaError_t e;
    switch (in_kind) {
    case 0:
        e = launch_rotator<float>(
            table, xw, in_gain, bmat, q, r, theta, phi0, prev_re,
            prev_im, w2d, w64_re, w64_im, tw_re, tw_im, last_re, last_im,
            f_scr, psd_part, psd_count, psd_out, M, C, mt, quad_gain,
            psd_scale, s);
        break;
    case 1:
        e = launch_rotator<int16_t>(
            table, xw, in_gain, bmat, q, r, theta, phi0, prev_re,
            prev_im, w2d, w64_re, w64_im, tw_re, tw_im, last_re, last_im,
            f_scr, psd_part, psd_count, psd_out, M, C, mt, quad_gain,
            psd_scale, s);
        break;
    case 2:
        e = launch_rotator<int8_t>(
            table, xw, in_gain, bmat, q, r, theta, phi0, prev_re,
            prev_im, w2d, w64_re, w64_im, tw_re, tw_im, last_re, last_im,
            f_scr, psd_part, psd_count, psd_out, M, C, mt, quad_gain,
            psd_scale, s);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    chan::launch_tail(ftail_in, f_scr, ftail_out, ka - 1, M, C, s);
    chan::launch_audio(f_scr, ftail_in, ataps, audio, audio_bf16 != 0, M, C,
                       ka, da, s);
    return static_cast<int>(cudaGetLastError());
}
