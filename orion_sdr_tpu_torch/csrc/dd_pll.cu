// Decision-directed carrier PLL for Hopper (sm_90a): the per-symbol
// recurrence of the single-carrier burst receiver, one row (a burst or a
// channel) a thread.
//
// No Pallas kernel of the JAX package computes this: it replaces the
// lax.scan of orion_sdr_tpu/demodulate/digital.py:191-208 (_dd_pll_kernel),
// which the JAX bench vmaps over its channels. Each symbol k of a row:
//     y    = z_k·e^{-jφ}                       (cos, sin of the unwrapped φ)
//     ref  = map_bits(decide(y)): per axis the level of the count of
//            thresholds the value lies strictly above (QAM), or
//            levels[value < 0] (BPSK, QPSK); BPSK's imaginary part is 0
//     err  = atan2(Im, Re) of y·conj(ref)
//     f   ← f + ki·err;   φ ← (φ + f) + kp·err;   out_k = y
// The thresholds and levels come from constellation.py::decide_tables, the
// tables the port's decide and map_bits use. The plain torch version is
// ops/dd_pll.py::dd_pll_reference, which writes the same real operations in
// the same order: every product and sum rounds apart here (-fmad=false,
// __fmul_rn/__fadd_rn), and cosf/sinf/atan2f are the functions
// torch.cos/sin/atan2 call on the card. φ is never wrapped, as in the
// reference, so cosf/sinf take large arguments on a long burst with a
// carrier offset (their slow range reduction, not an approximation).
//
// What bounds it on this card: the latency of the per-row chain (cos and
// sin of φ, the decision, atan2, the loop filter: some 150 dependent
// instructions a symbol), not bytes (each symbol is read once and written
// once) or operations. The design keeps the carry and the tables in
// registers and shared memory and spreads the rows over SMs a warp at a
// time; the bench's 4 rows leave all but 4 threads of the card idle, which
// is why a batch of rows is the way to use it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;   // rows a block: one warp, rows spread over SMs
constexpr int kMaxLevels = 16; // qam256: 16 levels an axis, 15 thresholds

__device__ __forceinline__ float axis_level(float v, const float* thr,
                                            int n_thr, const float* lv,
                                            bool sign) {
    if (sign) return v < 0.f ? lv[1] : lv[0];
    int nat = 0;
    for (int i = 0; i < n_thr; ++i) nat += v > thr[i] ? 1 : 0;
    return lv[nat];
}

__global__ void __launch_bounds__(kThreads)
dd_pll_kernel(const float2* __restrict__ z, int rows, int64_t n,
              const float* __restrict__ thr_g, int n_thr,
              const float* __restrict__ lv_g, int sign, int imag_zero,
              float kp, float ki, float2* __restrict__ out) {
    __shared__ float thr[kMaxLevels];
    __shared__ float lv[kMaxLevels];
    for (int i = threadIdx.x; i < n_thr; i += kThreads) thr[i] = thr_g[i];
    for (int i = threadIdx.x; i <= n_thr; i += kThreads) lv[i] = lv_g[i];
    __syncthreads();
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= rows) return;
    const float2* zr = z + r * n;
    float2* orow = out + r * n;
    float ph = 0.f, f = 0.f;
    for (int64_t k = 0; k < n; ++k) {
        const float2 v = zr[k];
        const float c = cosf(ph);
        const float s = sinf(ph);
        const float yr = __fadd_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s));
        const float yi = __fsub_rn(__fmul_rn(v.y, c), __fmul_rn(v.x, s));
        const float rr = axis_level(yr, thr, n_thr, lv, sign);
        const float ri = imag_zero ? 0.f : axis_level(yi, thr, n_thr, lv, sign);
        const float pr = __fadd_rn(__fmul_rn(yr, rr), __fmul_rn(yi, ri));
        const float pi = __fsub_rn(__fmul_rn(yi, rr), __fmul_rn(yr, ri));
        const float err = atan2f(pi, pr);
        f = __fadd_rn(f, __fmul_rn(ki, err));
        ph = __fadd_rn(__fadd_rn(ph, f), __fmul_rn(kp, err));
        orow[k] = make_float2(yr, yi);
    }
}

}  // namespace

// z, out: (rows, n) complex64 as float2, contiguous; thr: (n_thr,) float32,
// levels: (n_thr + 1,) float32, both on the device (n_thr <= 15). Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int dd_pll(const void* z, int rows, int64_t n, const float* thr,
                      int n_thr, const float* levels, int sign, int imag_zero,
                      float kp, float ki, void* out, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (n_thr < 1 || n_thr >= kMaxLevels) return static_cast<int>(
        cudaErrorInvalidValue);
    const dim3 grid((rows + kThreads - 1) / kThreads);
    dd_pll_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(z), rows, n, thr, n_thr, levels, sign,
        imag_zero, kp, ki, static_cast<float2*>(out));
    return static_cast<int>(cudaGetLastError());
}
