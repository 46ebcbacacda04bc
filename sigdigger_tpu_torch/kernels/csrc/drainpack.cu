// Single-fetch drain packer of the analyzer, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/drainpack.py::_pack_kernel.
// The TPU kernel selects each section's live columns with per-group
// one-hot matmuls Σ_g X_g·S_g, because its toolchain has no gather.  Here
// each thread writes one int16 element of the [total_tiles·mt, W] buffer
// from one gathered load:
//
//   data section s (tiles t0..t0+cnt, G lane groups of ws = W/G lanes),
//   output tile t, row r, lane l:
//     g = l / ws,  col = idx_s[l % ws],
//     out = col < 0 ? 0
//         : trunc(clip(x_s[((t − t0)·G + g)·mt + r, col]·scale_s,
//                      −32768, 32767))
//   status tile: rows 0-2 the 3-lane residual of sq[status[l]], rows 3-5
//   that of pw[status[l]], rows 6.. zero, where residual3(v) is
//     u = clip(v·256, −32768, 32766), h = floor(u),
//     r1 = (u − h)·32768, m = floor(r1), lo = floor((r1 − m)·32768).
//
// Each step is one IEEE float32 operation, written with the _rn
// intrinsics so that no multiply and add contract into an FMA, and the
// int16 conversion truncates toward zero (__float2int_rz) as astype does:
// the kernel, the plain version and the reference's one-hot matmul agree
// bit for bit on finite input.
//
// Bound: bytes.  The live source columns read once and the int16 buffer
// written once (a few operations per element).  Design: one thread per
// output element, consecutive threads on consecutive lanes, so stores
// coalesce and loads do too where a section's map is monotonic (the
// engine's active slots are sorted).  The section table is a kernel
// parameter read with constant indices (an unrolled search), so it stays
// in the constant bank.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/drainpack.py::pack_kernel_reference.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_SECTIONS = 8;

// Layout shared with drainpack.py::_Plan: per data section, ints
// (t0, cnt, G, ws, unused), the plane, its index list and its scale.
// Outside the unnamed namespace: the extern "C" entry point takes it,
// and a parameter type with internal linkage would give the entry
// point internal linkage too.
struct Plan {
    int ints[5 * MAX_SECTIONS];
    const float* x[MAX_SECTIONS];
    const int* idx[MAX_SECTIONS];
    float scale[MAX_SECTIONS];
};

namespace {

__device__ __forceinline__ int16_t quant(float v, float scale) {
    const float q = fminf(fmaxf(__fmul_rn(v, scale), -32768.0f), 32767.0f);
    return static_cast<int16_t>(__float2int_rz(q));
}

__device__ __forceinline__ int16_t residual3(float v, int lane) {
    const float u = fminf(fmaxf(__fmul_rn(v, 256.0f), -32768.0f), 32766.0f);
    const float h = floorf(u);
    const float r1 = __fmul_rn(__fsub_rn(u, h), 32768.0f);
    const float m = floorf(r1);
    const float lo = floorf(__fmul_rn(__fsub_rn(r1, m), 32768.0f));
    const float pick = lane == 0 ? h : lane == 1 ? m : lo;
    return static_cast<int16_t>(__float2int_rz(pick));
}

__global__ void __launch_bounds__(128)
pack(const Plan plan, int n_sec, const float* __restrict__ sq,
     const float* __restrict__ pw, const int* __restrict__ status,
     int status_t0, int16_t* __restrict__ out, int C, int W, int mt,
     int rows) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= W) return;
    for (int row = blockIdx.y; row < rows; row += gridDim.y) {
        const int t = row / mt;
        const int r = row - t * mt;
        int16_t v = 0;
        if (t == status_t0) {
            if (r < 6) {
                const int col = status[l];
                const float* __restrict__ src = r < 3 ? sq : pw;
                v = residual3(col >= 0 ? src[col] : 0.0f, r % 3);
            }
        } else {
#pragma unroll
            for (int s = 0; s < MAX_SECTIONS; ++s) {
                const int t0 = plan.ints[5 * s];
                const int cnt = plan.ints[5 * s + 1];
                if (s < n_sec && t >= t0 && t < t0 + cnt) {
                    const int G = plan.ints[5 * s + 2];
                    const int ws = plan.ints[5 * s + 3];
                    const int g = l / ws;
                    const int col = plan.idx[s][l - g * ws];
                    if (col >= 0) {
                        const size_t src =
                            (size_t)(((t - t0) * G + g) * mt + r) * C + col;
                        v = quant(plan.x[s][src], plan.scale[s]);
                    }
                }
            }
        }
        out[(size_t)row * W + l] = v;
    }
}

}  // namespace

// One pack into out int16 [total_tiles·mt, W]: n_sec data sections
// described by *plan (host memory, copied into the launch's parameters),
// the float32 status rows sq and pw [1, C] through the int32 map status
// [W] (-1: empty lane) into tile status_t0.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int sd_drainpack(const Plan* plan, int n_sec, const float* sq,
                            const float* pw, const int* status, int status_t0,
                            int16_t* out, int C, int W, int mt,
                            int total_tiles, void* stream) {
    if (plan == nullptr || n_sec < 0 || n_sec > MAX_SECTIONS || C < 1 ||
        W < 1 || mt < 6 || total_tiles < 1 || status_t0 < 0 ||
        status_t0 >= total_tiles)
        return static_cast<int>(cudaErrorInvalidValue);
    for (int s = 0; s < n_sec; ++s) {
        const int ws = plan->ints[5 * s + 3];
        if (plan->x[s] == nullptr || plan->idx[s] == nullptr || ws < 1 ||
            plan->ints[5 * s + 2] * ws != W)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    const int rows = total_tiles * mt;
    const dim3 block(128);
    const dim3 grid((W + 127) / 128, rows < 65535 ? rows : 65535);
    pack<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        *plan, n_sec, sq, pw, status, status_t0, out, C, W, mt, rows);
    return static_cast<int>(cudaGetLastError());
}
