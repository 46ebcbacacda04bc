// Symbol-rate squeeze of the recovery drain, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/symsqueeze.py::
// _squeeze_kernel.  The TPU kernel sums each group of R rows with a
// block-diagonal 0/1 matmul in chunks, because its toolchain has no
// segmented sum.  Here each thread owns one output position (i, c) and
// writes its element of all three output planes:
//
//   out_r[i, c] = Σ_{r<R} sr[i·R + r, c] · st[i·R + r, c]
//   out_i[i, c] = Σ_{r<R} si[i·R + r, c] · st[i·R + r, c]
//   out_s[i, c] = Σ_{r<R} st[i·R + r, c]
//
// summed in row order.  Each product is rounded before it is added
// (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version's
// (plane * st).sum() rounds it, so the two agree bit for bit whenever a
// group holds at most two strobes, which the engine's sps >= R + 1 rule
// guarantees.  No atomics: the result is the same on every run.
//
// Bound: bytes.  3 planes [M, C] read once and 3 planes [M/R, C] written
// once, 2 operations per input element.  Design: consecutive threads on
// consecutive columns (blockIdx.x over column blocks of 128, rows over
// the grid's y with a stride), so every load and store is coalesced; a
// thread reads the strobe once for the three planes.  The plain PyTorch
// version is sigdigger_tpu_torch/kernels/symsqueeze.py::
// squeeze_kernel_reference.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(128)
squeeze(const float* __restrict__ sr, const float* __restrict__ si,
        const float* __restrict__ st, float* __restrict__ out_r,
        float* __restrict__ out_i, float* __restrict__ out_s, int M, int C,
        int R) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    const int rows = M / R;
    for (int i = blockIdx.y; i < rows; i += gridDim.y) {
        size_t at = (size_t)i * R * C + c;
        float s = st[at];
        float ar = __fmul_rn(sr[at], s);
        float ai = __fmul_rn(si[at], s);
        float as = s;
        for (int r = 1; r < R; ++r) {
            at += C;
            s = st[at];
            ar = __fadd_rn(ar, __fmul_rn(sr[at], s));
            ai = __fadd_rn(ai, __fmul_rn(si[at], s));
            as = __fadd_rn(as, s);
        }
        const size_t o = (size_t)i * C + c;
        out_r[o] = ar;
        out_i[o] = ai;
        out_s[o] = as;
    }
}

}  // namespace

// One squeeze of the float32 planes sr, si, st [M, C] into out_r, out_i,
// out_s [M/R, C].  Needs R >= 2 dividing M.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int sd_symsqueeze(const float* sr, const float* si, const float* st,
                             float* out_r, float* out_i, float* out_s, int M,
                             int C, int R, void* stream) {
    if (M < 1 || C < 1 || R < 2 || M % R) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int rows = M / R;
    const dim3 block(128);
    const dim3 grid((C + 127) / 128, rows < 65535 ? rows : 65535);
    squeeze<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        sr, si, st, out_r, out_i, out_s, M, C, R);
    return static_cast<int>(cudaGetLastError());
}
