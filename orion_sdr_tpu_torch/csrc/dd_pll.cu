// Decision-directed carrier PLL for Hopper (sm_90a): the per-symbol
// recurrence of the single-carrier burst receiver, one row (a burst or a
// channel) a thread, one warp of 32 rows a block.
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
// sin of φ, the decision, atan2, the loop filter), not bytes (each symbol
// is read once and written once) or operations: each symbol waits for the
// last one's φ, so a launch takes n × the chain's latency whatever the
// number of rows (one warp a block, rows spread over SMs; the bench's 4
// rows leave all but 4 threads of the card idle). The design keeps every
// other instruction off that chain:
//   - the kernel is a template on the constellation: BPSK and QPSK decide
//     by sign, 16-, 64- and 256-QAM by 3, 7 or 15 thresholds held in
//     registers with their levels. The thresholds ascend, so the count of
//     thresholds below v is at least m exactly when v > thr[m - 1]: the
//     level is a tree of selects over independent compares, log2 deep;
//   - cos and sin of φ come from one sincosf (one range reduction), which
//     gives the bits of cosf and sinf on every float32:
//     dd_pll_sincos_mismatches below compares the two over all 2^32 inputs
//     on the card (tests/test_torch_gpu.py, chip_smoke [37]);
//   - the block's rows are staged through shared memory in tiles of 32
//     symbols: double-buffered cp.async loads (a warp reads 32 symbols of
//     one row, 256 contiguous bytes) and outputs written back a row segment
//     at a time, coalesced, so no thread reads or writes its own row a
//     symbol at a time, 32 rows from its neighbours'.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;          // rows a block: one warp
constexpr int kTile = 32;          // symbols a staged tile
constexpr int kPitch = kTile + 1;  // float2 a staged row: lane r starts at
                                   // bank 2r, so a symbol's reads don't clash

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The level of v among sorted thresholds thr[LO..HI-1]: lv[m] for the
// count m in [LO, HI] of thresholds below v, as a tree of selects.
template <int LO, int HI, int NT>
__device__ __forceinline__ float pick(float v, const float (&thr)[NT],
                                      const float (&lv)[NT + 1]) {
    if constexpr (LO == HI) {
        return lv[LO];
    } else {
        constexpr int MID = (LO + HI + 1) / 2;
        const float up = pick<MID, HI, NT>(v, thr, lv);
        const float down = pick<LO, MID - 1, NT>(v, thr, lv);
        return v > thr[MID - 1] ? up : down;
    }
}

template <int NT, bool SIGN>
__device__ __forceinline__ float axis_level(float v, const float (&thr)[NT],
                                            const float (&lv)[NT + 1]) {
    if constexpr (SIGN) return v < 0.f ? lv[1] : lv[0];
    else return pick<0, NT, NT>(v, thr, lv);
}

// Lane's share of staging tile `tile` of the block's rows into buf:
// 8-byte cp.async, 32 lanes on 32 consecutive symbols of one row.
__device__ __forceinline__ void stage(const float2* z, int64_t n, int nrows,
                                      int64_t tile, float2 (*buf)[kPitch]) {
    const int j = threadIdx.x;
    const int64_t k = tile * kTile + j;
    if (k < n) {
        for (int r = 0; r < nrows; ++r)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                         :: "r"(smem_u32(&buf[r][j])), "l"(z + r * n + k)
                         : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int NT, bool SIGN, bool IMAG_ZERO>
__global__ void __launch_bounds__(kRows)
dd_pll_kernel(const float2* __restrict__ z, int rows, int64_t n,
              const float* __restrict__ thr_g,
              const float* __restrict__ lv_g, float kp, float ki,
              float2* __restrict__ out) {
    __shared__ __align__(16) float2 in[2][kRows][kPitch];
    __shared__ __align__(16) float2 res[kRows][kPitch];
    float thr[NT], lv[NT + 1];
#pragma unroll
    for (int i = 0; i < NT; ++i) thr[i] = thr_g[i];
#pragma unroll
    for (int i = 0; i <= NT; ++i) lv[i] = lv_g[i];
    const int lane = threadIdx.x;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
    const int nrows = static_cast<int>(rows - row0 < kRows ? rows - row0
                                                           : kRows);
    const float2* zb = z + row0 * n;
    float2* ob = out + row0 * n;
    // rows past the batch run on zeros (err = atan2(0, 0) = 0, φ stays 0),
    // so their lanes never take sincosf's slow path
    for (int r = nrows; r < kRows; ++r)
        for (int b = 0; b < 2; ++b)
            in[b][r][lane] = make_float2(0.f, 0.f);
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    stage(zb, n, nrows, 0, in[0]);
    float ph = 0.f, f = 0.f;
    for (int64_t tile = 0; tile < n_tiles; ++tile) {
        if (tile + 1 < n_tiles)
            stage(zb, n, nrows, tile + 1, in[(tile + 1) & 1]);
        else
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncwarp();
        const int64_t k0 = tile * kTile;
        const int m = static_cast<int>(n - k0 < kTile ? n - k0 : kTile);
        const float2* src = in[tile & 1][lane];
        for (int j = 0; j < m; ++j) {
            const float2 v = src[j];
            float s, c;
            sincosf(ph, &s, &c);
            const float yr = __fadd_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s));
            const float yi = __fsub_rn(__fmul_rn(v.y, c), __fmul_rn(v.x, s));
            const float rr = axis_level<NT, SIGN>(yr, thr, lv);
            const float ri = IMAG_ZERO ? 0.f : axis_level<NT, SIGN>(yi, thr, lv);
            const float pr = __fadd_rn(__fmul_rn(yr, rr), __fmul_rn(yi, ri));
            const float pi = __fsub_rn(__fmul_rn(yi, rr), __fmul_rn(yr, ri));
            const float err = atan2f(pi, pr);
            f = __fadd_rn(f, __fmul_rn(ki, err));
            ph = __fadd_rn(__fadd_rn(ph, f), __fmul_rn(kp, err));
            res[lane][j] = make_float2(yr, yi);
        }
        __syncwarp();
        if (lane < m) {
            for (int r = 0; r < nrows; ++r) ob[r * n + k0 + lane] = res[r][lane];
        }
        __syncwarp();
    }
}

template <int NT, bool SIGN, bool IMAG_ZERO>
int launch(const float2* z, int rows, int64_t n, const float* thr,
           const float* lv, float kp, float ki, float2* out,
           cudaStream_t stream) {
    const dim3 grid((rows + kRows - 1) / kRows);
    dd_pll_kernel<NT, SIGN, IMAG_ZERO><<<grid, kRows, 0, stream>>>(
        z, rows, n, thr, lv, kp, ki, out);
    return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float opaque(float x) {
    // hides x's value from the compiler, so sinf/cosf below are computed
    // on their own and not merged with the sincosf beside them
    float y;
    asm volatile("mov.b32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
    return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
}

__global__ void sincos_check_kernel(uint32_t lo, int64_t count,
                                    unsigned long long* bad) {
    unsigned long long local = 0;
    const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x; i < count; i += step) {
        const float x = __uint_as_float(lo + static_cast<uint32_t>(i));
        float s, c;
        sincosf(x, &s, &c);
        const float s1 = sinf(opaque(x));
        const float c1 = cosf(opaque(x));
        local += (same_bits(s, s1) && same_bits(c, c1)) ? 0 : 1;
    }
    if (local) atomicAdd(bad, local);
}

}  // namespace

// z, out: (rows, n) complex64 as float2, contiguous; thr: (n_thr,) float32
// ascending, levels: (n_thr + 1,) float32, both on the device. Takes the
// tables of decide_tables: sign with n_thr 1 (BPSK with imag_zero, QPSK),
// or 3, 7 or 15 thresholds (16-, 64-, 256-QAM). Returns the CUDA error of
// the launch (0 when it was accepted).
extern "C" int dd_pll(const void* z, int rows, int64_t n, const float* thr,
                      int n_thr, const float* levels, int sign, int imag_zero,
                      float kp, float ki, void* out, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    const auto zz = static_cast<const float2*>(z);
    const auto oo = static_cast<float2*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    if (sign && n_thr == 1)
        return imag_zero
            ? launch<1, true, true>(zz, rows, n, thr, levels, kp, ki, oo, st)
            : launch<1, true, false>(zz, rows, n, thr, levels, kp, ki, oo, st);
    if (!sign && !imag_zero) {
        switch (n_thr) {
            case 3:
                return launch<3, false, false>(zz, rows, n, thr, levels, kp,
                                               ki, oo, st);
            case 7:
                return launch<7, false, false>(zz, rows, n, thr, levels, kp,
                                               ki, oo, st);
            case 15:
                return launch<15, false, false>(zz, rows, n, thr, levels, kp,
                                                ki, oo, st);
            default:
                break;
        }
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// Counts into *bad (a zeroed device counter) the float32 inputs with bit
// patterns lo .. lo + count - 1 (mod 2^32) where sincosf's sine or cosine
// differs in its bits from sinf's or cosf's (NaNs of any payload agree).
// Returns the CUDA error of the launch.
extern "C" int dd_pll_sincos_mismatches(unsigned int lo, int64_t count,
                                        unsigned long long* bad,
                                        void* stream) {
    if (count <= 0) return 0;
    sincos_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        lo, count, bad);
    return static_cast<int>(cudaGetLastError());
}
