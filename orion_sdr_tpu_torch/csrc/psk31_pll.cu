// PSK31 decision-feedback matched filter + first-order PLL for Hopper
// (sm_90a): the per-symbol recurrence over precomputed matched-filter dots,
// one row (a channel or carrier) a thread, one warp of 32 rows a block.
//
// No Pallas kernel of the JAX package computes this: it replaces the
// lax.scan of orion_sdr_tpu/demodulate/psk31.py:65-100 (_pll_scan). Each
// symbol k of a row:
//     sym   = (dot_k - prev·c_fb)·scale
//     sym_c = sym·e^{-j·acc}              (cos, sin of acc)
//     d     = sym_c·conj(prev)
//     BPSK: dec = sign(Re d), err_x = Im d·dec
//     QPSK: dec = nearest of ±1, ±j, err_x = Im d·Re dec - Re d·Im dec
//     err   = err_x·rsqrt(|d|²) if |d|² > 1e-6, else 0
//     acc   = ((acc + g·err + π) mod 2π) - π        (floor mod)
//     prev  = sym_c;  out = Re d (BPSK) or (Re d, Im d) (QPSK)
// The plain torch version is ops/psk31_pll.py::psk31_pll_reference, which
// writes the same real operations in the same order: every product and sum
// rounds apart here (-fmad=false, __fmul_rn/__fadd_rn), rsqrtf is the
// function torch.rsqrt calls on the card, and fmodf is the remainder
// torch.remainder takes.
//
// What bounds it on this card: the latency of the per-row chain (a
// complex multiply-add, cos and sin of the phase, rsqrt, the wrap), not
// bytes (each dot is read once, each soft value written once) or
// operations: each symbol waits for the last one's phase, so a launch
// takes n × the chain's latency whatever the number of rows. The design
// keeps every other instruction off that chain (the DD-PLL's,
// csrc/dd_pll.cu, since its redesign):
//   - cos and sin of acc come from one sincosf (one range reduction),
//     which gives the bits of cosf and sinf on every float32:
//     dd_pll.cu's dd_pll_sincos_mismatches compares the two over all 2^32
//     inputs on the card (tests/test_torch_gpu.py, chip_smoke [37]). After
//     the first symbol acc lies in [-π, π), where sincosf takes its fast
//     path; the caller's acc0 may lie anywhere;
//   - the wrap's fmodf runs only when u = acc + g·err + π leaves [0, 2π),
//     where fmodf(u, 2π) is u itself: the in-range case is a compare and a
//     select;
//   - the block's rows are staged through shared memory in tiles of 32
//     symbols: double-buffered cp.async loads (a warp reads 32 dots of one
//     row, 256 contiguous bytes; the pitch of 33 keeps a symbol's reads off
//     each other's banks), and the soft values go back a row segment at a
//     time, coalesced, so no thread reads or writes its own row a symbol at
//     a time, 32 rows from its neighbours'.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;          // rows a block: one warp
constexpr int kTile = 32;          // symbols a staged tile
constexpr int kPitch = kTile + 1;  // a staged row, in elements
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stores a symbol's soft value at a shared-memory address computed once a
// tile (a plain store's address is rebuilt from the shared window's base,
// S2R and all, every symbol, on the chain)
__device__ __forceinline__ void put(uint32_t a, float v) {
    asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(a), "f"(v));
}
__device__ __forceinline__ void put(uint32_t a, float2 v) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                 :: "r"(a), "f"(v.x), "f"(v.y));
}

// Lane's share of staging tile `tile` of the block's rows into buf:
// 8-byte cp.async, 32 lanes on 32 consecutive dots of one row.
__device__ __forceinline__ void stage(const float2* d, int64_t n, int nrows,
                                      int64_t tile, float2 (*buf)[kPitch]) {
    const int j = threadIdx.x;
    const int64_t k = tile * kTile + j;
    if (k < n) {
        for (int r = 0; r < nrows; ++r)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                         :: "r"(smem_u32(&buf[r][j])), "l"(d + r * n + k)
                         : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The soft value of one symbol: a float (BPSK) or a float2 (QPSK).
template <bool kQpsk>
using Soft = typename std::conditional<kQpsk, float2, float>::type;

template <bool kQpsk>
__global__ void __launch_bounds__(kRows)
psk31_pll_kernel(const float2* __restrict__ dots,
                 const float2* __restrict__ prev0,
                 const float* __restrict__ acc0, int rows, int64_t n,
                 float c_fb, float scale, float gain,
                 Soft<kQpsk>* __restrict__ soft, float2* __restrict__ prev_out,
                 float* __restrict__ acc_out) {
    __shared__ __align__(16) float2 in[2][kRows][kPitch];
    __shared__ __align__(16) Soft<kQpsk> res[kRows][kPitch];
    const int lane = threadIdx.x;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
    const int nrows = static_cast<int>(rows - row0 < kRows ? rows - row0
                                                           : kRows);
    const float2* db = dots + row0 * n;
    Soft<kQpsk>* sb = soft + row0 * n;
    const bool live = lane < nrows;
    // rows past the batch run on zeros from a zero carry (err = 0, acc
    // stays 0), so their lanes never take a slow path
    for (int r = nrows; r < kRows; ++r)
        for (int b = 0; b < 2; ++b)
            in[b][r][lane] = make_float2(0.f, 0.f);
    float pr = 0.f, pi = 0.f, acc = 0.f;
    if (live) {
        pr = prev0[row0 + lane].x;
        pi = prev0[row0 + lane].y;
        acc = acc0[row0 + lane];
    }
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    stage(db, n, nrows, 0, in[0]);
    for (int64_t tile = 0; tile < n_tiles; ++tile) {
        if (tile + 1 < n_tiles)
            stage(db, n, nrows, tile + 1, in[(tile + 1) & 1]);
        else
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncwarp();
        const int64_t k0 = tile * kTile;
        const int m = static_cast<int>(n - k0 < kTile ? n - k0 : kTile);
        const float2* src = in[tile & 1][lane];
        const uint32_t dst = smem_u32(&res[lane][0]);
        for (int j = 0; j < m; ++j) {
            const float2 dot = src[j];
            const float yr = __fmul_rn(__fsub_rn(dot.x, __fmul_rn(pr, c_fb)),
                                       scale);
            const float yi = __fmul_rn(__fsub_rn(dot.y, __fmul_rn(pi, c_fb)),
                                       scale);
            float s, c;
            sincosf(acc, &s, &c);
            const float cr = __fadd_rn(__fmul_rn(yr, c), __fmul_rn(yi, s));
            const float ci = __fsub_rn(__fmul_rn(yi, c), __fmul_rn(yr, s));
            const float d_re = __fadd_rn(__fmul_rn(cr, pr), __fmul_rn(ci, pi));
            const float d_im = __fsub_rn(__fmul_rn(ci, pr), __fmul_rn(cr, pi));
            float cross;
            if constexpr (kQpsk) {
                const bool re_wins = fabsf(d_re) >= fabsf(d_im);
                const float dec_re = re_wins ? (d_re >= 0.f ? 1.f : -1.f) : 0.f;
                const float dec_im = re_wins ? 0.f : (d_im >= 0.f ? 1.f : -1.f);
                cross = __fsub_rn(__fmul_rn(d_im, dec_re),
                                  __fmul_rn(d_re, dec_im));
                put(dst + 8 * j, make_float2(d_re, d_im));
            } else {
                cross = __fmul_rn(d_im, d_re >= 0.f ? 1.f : -1.f);
                put(dst + 4 * j, d_re);
            }
            const float mag = __fadd_rn(__fmul_rn(d_re, d_re),
                                        __fmul_rn(d_im, d_im));
            const float err = mag > 1e-6f ? __fmul_rn(cross, rsqrtf(mag)) : 0.f;
            const float u = __fadd_rn(__fadd_rn(acc, __fmul_rn(gain, err)), kPi);
            float w = u;
            if (!(u >= 0.f && u < kTwoPi)) {
                w = fmodf(u, kTwoPi);
                if (w != 0.f && w < 0.f) w = __fadd_rn(w, kTwoPi);
            }
            acc = __fsub_rn(w, kPi);
            pr = cr;
            pi = ci;
        }
        asm volatile("" ::: "memory");     // the puts before the reads below
        __syncwarp();
        if (lane < m) {
            for (int r = 0; r < nrows; ++r) sb[r * n + k0 + lane] = res[r][lane];
        }
        __syncwarp();
    }
    if (live) {
        prev_out[row0 + lane] = make_float2(pr, pi);
        acc_out[row0 + lane] = acc;
    }
}

template <bool kQpsk>
int launch(const float2* d, const float2* p0, const float* a0, int rows,
           int64_t n, float c_fb, float scale, float gain, float* soft,
           float2* po, float* ao, cudaStream_t s) {
    const dim3 grid((rows + kRows - 1) / kRows);
    psk31_pll_kernel<kQpsk><<<grid, kRows, 0, s>>>(
        d, p0, a0, rows, n, c_fb, scale, gain,
        reinterpret_cast<Soft<kQpsk>*>(soft), po, ao);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dots: (rows, n) complex64 as float2; prev0, prev_out: (rows,) complex64;
// acc0, acc_out: (rows,) float32; soft: (rows, n) float32 (BPSK) or
// (rows, n, 2) (QPSK); all contiguous. Returns the CUDA error of the launch
// (0 when it was accepted).
extern "C" int psk31_pll(const void* dots, const void* prev0, const float* acc0,
                         int rows, int64_t n, float c_fb, float scale,
                         float gain, int qpsk, float* soft, void* prev_out,
                         float* acc_out, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    const auto d = static_cast<const float2*>(dots);
    const auto p0 = static_cast<const float2*>(prev0);
    const auto po = static_cast<float2*>(prev_out);
    const auto s = static_cast<cudaStream_t>(stream);
    return qpsk ? launch<true>(d, p0, acc0, rows, n, c_fb, scale, gain, soft,
                               po, acc_out, s)
                : launch<false>(d, p0, acc0, rows, n, c_fb, scale, gain, soft,
                                po, acc_out, s);
}
