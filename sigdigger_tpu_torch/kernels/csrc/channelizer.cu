// The v1 FM channelizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/channelizer.py::_kernel:
// channelize Y = Xw·H, rotate by e^{-j(φ0 + m·θ)} over the whole block
// (one time tile: the cos/sin rotator with mt = M), discriminate against
// the carried previous row, and decimate to audio with the global banded
// matrix Bᵀ [M/Da, M], audio[i] = Σ_t a[t]·f[i·Da − t] over f[m] = 0 for
// m < 0: no FIR tail is carried, the filter restarts every block
// (channelizer.py:91-98).  The TPU kernel is one grid program per channel
// tile with the whole block in VMEM and a dense [Ma, M] matmul for the
// FIR.  Here the block runs on kernel2's stages: chan.cuh's tensor-core
// core tc::chan_rot_disc_tc (3xTF32 wgmma on B = bmat [2C, 128], tiles of
// 63 new rows with a one-row overlap, the rotation and discriminator in
// its epilogue), then the banded FIR of audio_fir with zeros in place of
// the tail.  At the entry's C 256, M 1024 the core's grid is 8 channel
// tiles × 6 row groups of three warpgroups: 144 warpgroups for the 136
// row tiles, so every tile runs at once and a launch takes about one
// tile's time (its B slice staged, one product, one epilogue).
//
// Bound: operations, the complex product's 8·M·K·C flops (0.13 GFLOP at
// the entry's M = 1024, C = 256) in three TF32 passes on the tensor cores
// and the rotation, discriminator and FIR on the CUDA cores, next to 0.5
// MiB of windows read.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/channelizer.py::kernel1_reference (its
// passes=3 emulates the tensor-core product).

#include <cuda_runtime.h>

#include "chan.cuh"

// One v1 block.  xr, xi [M, 64] float32 window planes; bmat [2C, 128]
// (tcsplit.py tc_bmat of the taps h [64, C]); theta, phi0, prev_re,
// prev_im [1, C], ataps [ka] float32.  Outputs audio [M/da, C] float32 and
// last_re, last_im [1, C]; f_scr [M, C] is scratch.  Launches on `stream`
// without synchronising and returns the first CUDA error.
extern "C" int sd_kernel1(const float* xr, const float* xi,
                          const float* bmat, const float* theta,
                          const float* phi0, const float* prev_re,
                          const float* prev_im, const float* ataps,
                          float* audio, float* last_re, float* last_im,
                          float* f_scr, int M, int C, int ka, int da,
                          float quad_gain, void* stream) {
    if (M < 1 || C < 1 || da < 1 || M < da || ka < 1 || ka > chan::MAX_KA)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t e = chan::tc::launch_chan<float, false>(
        xr, xi, 1.0f, bmat, nullptr, nullptr, theta, phi0, prev_re, prev_im,
        f_scr, last_re, last_im, M, C, M, quad_gain, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    chan::launch_audio(f_scr, nullptr, ataps, audio, false, M, C, ka, da, s);
    return static_cast<int>(cudaGetLastError());
}
