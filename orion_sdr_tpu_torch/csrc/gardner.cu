// Gardner symbol-timing loop for Hopper (sm_90a): fractional-delay symbol
// sampling driven by the mid-symbol error, one row (a burst or a channel)
// a thread.
//
// No Pallas kernel of the JAX package computes this: it replaces the
// lax.scan of orion_sdr_tpu/demodulate/digital.py:127-161 (_gardner_kernel).
// Over unit-RMS samples z of a row (the wrapper normalises each row with a
// torch reduction before the launch, which the plain version shares), each
// output symbol k:
//     interp(p): i = clip(floor(p), 0, n-2), t = p - i,
//                z[i]·(1 - t) + z[i+1]·t      (extrapolates at the edges)
//     y  = interp(pos);  m = interp(pos - rate/2)
//     e  = clip(-Re[(y - prev)·conj(m)], -1, 1)
//     rate ← clip(rate + ki·e, lo, hi);  pos ← (pos + rate) + kp·e
//     out_k = y;  prev = y
// pos is float32, as in the reference. The plain torch version is
// ops/gardner.py::gardner_reference, which writes the same real operations
// in the same order: every product and sum rounds apart here (-fmad=false,
// __fmul_rn/__fadd_rn), so the two agree bit for bit.
//
// What bounds it on this card: the latency of the per-row chain, in which
// each step's position picks the samples the next step reads (four
// dependent loads a step, mostly L1 hits as the position walks forward
// sps samples a step), not bytes (a row's samples are read about once, its
// symbols written once) or operations. The design keeps the carry in
// registers, reads through the read-only cache, and puts every row of a
// batch in one launch, a warp of rows a block so rows spread over SMs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
    // NaN passes through, as jnp.clip and torch.clamp let it
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float2 interp(const float2* __restrict__ z,
                                         int64_t n, float p) {
    int64_t i = static_cast<int64_t>(floorf(p));
    i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
    const float t = __fsub_rn(p, static_cast<float>(i));
    const float w = __fsub_rn(1.f, t);
    const float2 a = __ldg(z + i);
    const float2 b = __ldg(z + i + 1);
    return make_float2(__fadd_rn(__fmul_rn(a.x, w), __fmul_rn(b.x, t)),
                       __fadd_rn(__fmul_rn(a.y, w), __fmul_rn(b.y, t)));
}

__global__ void __launch_bounds__(kThreads)
gardner_kernel(const float2* __restrict__ z, int rows, int64_t n,
               int64_t n_out, float pos0, float rate0, float kp, float ki,
               float lo, float hi, float2* __restrict__ out,
               float* __restrict__ pos_out) {
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= rows) return;
    const float2* zr = z + r * n;
    float2* orow = out + r * n_out;
    float pos = pos0, rate = rate0, pr = 0.f, pi = 0.f;
    for (int64_t k = 0; k < n_out; ++k) {
        const float2 y = interp(zr, n, pos);
        const float2 m = interp(zr, n, __fsub_rn(pos, __fmul_rn(rate, 0.5f)));
        const float dr = __fsub_rn(y.x, pr);
        const float di = __fsub_rn(y.y, pi);
        float e = -__fadd_rn(__fmul_rn(dr, m.x), __fmul_rn(di, m.y));
        e = clipf(e, -1.f, 1.f);
        rate = clipf(__fadd_rn(rate, __fmul_rn(ki, e)), lo, hi);
        pos = __fadd_rn(__fadd_rn(pos, rate), __fmul_rn(kp, e));
        orow[k] = y;
        pr = y.x;
        pi = y.y;
    }
    pos_out[r] = pos;
}

}  // namespace

// z: (rows, n) complex64 as float2, unit RMS a row, n >= 2; out: (rows,
// n_out) complex64; pos_out: (rows,) float32; all contiguous. Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int gardner(const void* z, int rows, int64_t n, int64_t n_out,
                       float pos0, float rate0, float kp, float ki, float lo,
                       float hi, void* out, float* pos_out, void* stream) {
    if (rows <= 0) return 0;
    if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((rows + kThreads - 1) / kThreads);
    gardner_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(z), rows, n, n_out, pos0, rate0, kp, ki, lo,
        hi, static_cast<float2*>(out), pos_out);
    return static_cast<int>(cudaGetLastError());
}
