// Device math shared by the port's kernels.
//
// sd_atan2 is the reference's polynomial atan2
// (sigdigger_tpu/kernels/ops.py::atan2): octant reduction, a minimax
// polynomial for atan on [0, 1], the same 1e-30 guard, and 0 at the
// origin.  The port keeps it instead of atan2f so that the kernel, its
// plain PyTorch version and the reference agree to float32 rounding.
//
// deq<T> reads one element of an upload that is float32 or an integer
// quantization of it (int16, int8), scaled back by gain = 1/scale.
#pragma once

template <typename T>
__device__ __forceinline__ float deq(T v, float gain) {
    return static_cast<float>(v) * gain;
}
template <>
__device__ __forceinline__ float deq<float>(float v, float) {
    return v;
}

__device__ __forceinline__ float sd_atan2(float y, float x) {
    const float ax = fabsf(x);
    const float ay = fabsf(y);
    const float mx = fmaxf(ax, ay);
    const float mn = fminf(ax, ay);
    const float a = mn / fmaxf(mx, 1e-30f);
    const float s = a * a;
    float r = ((((-0.0117212f * s + 0.05265332f) * s - 0.11643287f) * s
                + 0.19354346f) * s - 0.33262348f) * s * a + a;
    if (ay > ax) r = 1.57079632679490f - r;
    if (x < 0.0f) r = 3.14159265358979f - r;
    if (y < 0.0f) r = -r;
    return mx < 1e-30f ? 0.0f : r;
}
