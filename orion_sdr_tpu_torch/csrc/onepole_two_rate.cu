// Two-rate one-pole envelope for Hopper (sm_90a):
//     env[i] = a·env[i-1] + (1 - a)·x[i],  a = a_hi if x[i] > env[i-1]
//                                          (or >=), else a_lo,
// one row of (rows, n) float32 samples a thread.
//
// No Pallas kernel of the JAX package computes this: it replaces the
// lax.scan recurrences of orion_sdr_tpu/dsp/agc.py:59-69 (agc_rms when
// attack != release: x^2 > env picks the attack pole) and
// orion_sdr_tpu/modulate/analog.py:40-47 (cw_mod: target >= env picks the
// rise pole). The pole depends on the state, so the recurrence is not an
// affine map of fixed coefficients and has no parallel prefix: each row is
// a chain of n dependent steps. The plain torch version is
// ops/onepole_two_rate.py::onepole_two_rate_reference, one step a loop
// iteration; both round a·env and b·x apart and then add (built with
// -fmad=false, and written with __fmul_rn/__fadd_rn, which are never
// contracted), so kernel and plain version agree bit for bit.
//
// What bounds it on this card: the latency of the per-row chain (compare,
// select, multiply, add: about 4 dependent instructions a sample), not
// bytes (each sample is read once and its envelope written once) or
// operations. The design keeps the chain in registers and nothing else on
// it. One warp takes 32 rows; a row's samples are strided by n, so a
// thread that loaded and stored its own row would touch 32 cache lines a
// warp instruction. Instead the warp moves tiles of kTile samples of its
// 32 rows between device memory and shared memory with coalesced 128-byte
// accesses, and prefetches the next tile into registers while the chain
// runs over the current one from shared memory (a padded row stride, so
// the 32 rows' reads fall in 32 banks). b = 1 - a is precomputed for both
// poles, both poles' updates are formed and one is selected (the
// comparison leaves the chain), and the comparison is a template
// parameter.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;   // rows a block: one warp, so rows spread over SMs
constexpr int kTile = 64;   // samples of each row a tile
constexpr int kPer = kRows * kTile / 32;  // tile values a lane moves

template <bool kGe>
__global__ void __launch_bounds__(kRows)
onepole_two_rate_kernel(const float* __restrict__ x,
                        const float* __restrict__ env0, int rows, int64_t n,
                        float a_hi, float b_hi, float a_lo, float b_lo,
                        float* __restrict__ env, float* __restrict__ env_last) {
    __shared__ float tile[kRows][kTile + 1];
    const int lane = threadIdx.x;
    const int row0 = blockIdx.x * kRows;
    const bool mine = row0 + lane < rows;
    float e = mine ? env0[row0 + lane] : 0.f;
    float pre[kPer];
    // tile value k of a lane: row k / (kTile/32), sample lane + 32·(k % ..)
    auto fetch = [&](int64_t t0) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const int r = k / (kTile / 32);
            const int64_t t = t0 + lane + 32 * (k % (kTile / 32));
            pre[k] = (row0 + r < rows && t < n) ? x[(row0 + r) * n + t] : 0.f;
        }
    };
    fetch(0);
    for (int64_t t0 = 0; t0 < n; t0 += kTile) {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
            tile[k / (kTile / 32)][lane + 32 * (k % (kTile / 32))] = pre[k];
        __syncwarp();
        if (t0 + kTile < n) fetch(t0 + kTile);   // in flight during the chain
        auto step = [&](int j) {
            // both poles' updates, then the choice: the comparison runs
            // beside the multiplies instead of ahead of them on the chain
            const float xi = tile[lane][j];
            const float up = __fadd_rn(__fmul_rn(a_hi, e), __fmul_rn(b_hi, xi));
            const float dn = __fadd_rn(__fmul_rn(a_lo, e), __fmul_rn(b_lo, xi));
            e = (kGe ? (xi >= e) : (xi > e)) ? up : dn;
            tile[lane][j] = e;
        };
        if (mine) {
            if (n - t0 >= kTile) {
                // a whole tile: unrolled, so every shared-memory read is
                // issued ahead of the chain that consumes it
#pragma unroll
                for (int j = 0; j < kTile; ++j) step(j);
            } else {
                for (int j = 0; j < n - t0; ++j) step(j);
            }
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const int r = k / (kTile / 32);
            const int c = lane + 32 * (k % (kTile / 32));
            if (row0 + r < rows && t0 + c < n)
                env[(row0 + r) * n + t0 + c] = tile[r][c];
        }
        __syncwarp();
    }
    if (mine) env_last[row0 + lane] = e;
}

}  // namespace

// x, env: (rows, n) float32, contiguous; env0, env_last: (rows,) float32.
// ge != 0 compares x >= env (cw_mod), else x > env (agc_rms). b_hi and b_lo
// are 1 - a_hi and 1 - a_lo rounded to float32 by the caller. Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int onepole_two_rate(const float* x, const float* env0, int rows,
                                int64_t n, float a_hi, float b_hi, float a_lo,
                                float b_lo, int ge, float* env,
                                float* env_last, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    const dim3 grid((rows + kRows - 1) / kRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ge)
        onepole_two_rate_kernel<true><<<grid, kRows, 0, s>>>(
            x, env0, rows, n, a_hi, b_hi, a_lo, b_lo, env, env_last);
    else
        onepole_two_rate_kernel<false><<<grid, kRows, 0, s>>>(
            x, env0, rows, n, a_hi, b_hi, a_lo, b_lo, env, env_last);
    return static_cast<int>(cudaGetLastError());
}
