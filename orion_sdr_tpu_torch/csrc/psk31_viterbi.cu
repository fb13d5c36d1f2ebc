// QPSK31 Viterbi decoders for Hopper (sm_90a): the rate-1/2 K=5 code's
// 16-state trellis over a row of symbols, forward pass and traceback, one
// row a thread, one warp of 32 rows a block.
//
// No Pallas kernel of the JAX package computes this: it replaces the
// lax.scans of orion_sdr_tpu/codec/psk31.py, the forward ACS of
// viterbi_decode (:111-135) and of viterbi_decode_coherent (:139-164) and
// their shared traceback _viterbi_traceback (:98-107). Next state ns has the
// predecessors p = 2·(ns&7) + j, j in {0, 1}, and the step's input bit is
// (ns>>3)&1. Each symbol z of a row:
//   non-coherent: bm[e] = |z - DQPSK_EXP[e]|² (rounded), for e = 0..3;
//                 cand(ns, j) = pm[p] + bm[dibit(p -> ns)]
//   coherent:     each state carries a phase count q (its phasor (-j)^q,
//                 q = 0 at the start); a step multiplies by DQPSK_EXP[dibit]
//                 = (-j)^inc[dibit], exactly, so the candidate's count is
//                 q' = q[p] + inc (mod 4) and
//                 cand(ns, j) = fma(h, h, pm[p]), h = |z - (-j)^q'|
//                 (one rounding: XLA contracts the JAX scan's product and
//                 sum into a fused multiply-add there, and not in the
//                 non-coherent scan, where the four metrics are formed
//                 apart from the gather)
//   j = 1 only where cand(ns, 1) < cand(ns, 0) (ties and NaN take j = 0);
//   pm[ns] = cand(ns, j) - min over the 16 (NaN propagates, as torch.min);
//   survivor mask: bit ns = j.
// The traceback starts at the first minimum of the final metrics (the
// first NaN if any, as torch.argmin) and walks back: bit = (s>>3)&1, then
// s = 2·(s&7) + ((mask >> s)&1). The plain torch version is
// ops/psk31_viterbi.py::psk31_viterbi_reference, in the same operations:
// every sum and product rounds apart here (-fmad=false) but the coherent
// fma, which is explicit; |.| is hypotf, which the plain version's complex
// abs calls (psk31_viterbi_lengths lets the card check that premise).
//
// What bounds it on this card: the per-row chain, not bytes (a pair read
// once, a bit written once, a 2-byte mask written and read back) or
// operations: each step waits for the last one's metrics, so a launch
// takes n steps of a row whatever the number of rows, and a step is some
// 130 instructions (270 coherent) of one warp: adds, a compare and a select
// a state, the mask, a four-level NaN-propagating min and the
// renormalising subtracts. The design keeps everything else off it:
//   - the 16 metrics (and the coherent phase counts) live in registers;
//     the loops over states are unrolled, so every predecessor, dibit and
//     increment is a constant;
//   - a symbol's four branch terms depend only on the symbol: the warp
//     forms a tile's terms before the rows' chains run through it, lane j
//     on symbol j of every live row, so one row (a flush) shares the
//     hypotf work among 32 lanes; they wait in shared memory, a float4 a
//     symbol;
//   - the coherent decoder picks each predecessor's two lengths with four
//     selects on its phase count's two low bits (its successors' increments
//     differ by 2);
//   - the rows' pairs are staged through shared memory in tiles of 32
//     symbols: double-buffered cp.async loads, a warp reading 32 pairs of
//     one row (256 contiguous bytes), as csrc/psk31_pll.cu stages its dots;
//   - the survivor masks go to a step-major buffer, (n, rows) uint16, so a
//     step's stores from the warp's 32 rows are 64 contiguous bytes, and so
//     are the traceback's loads; their addresses do not depend on the
//     state, so a tile's 32 loads are issued before its walk;
//   - the traceback's bits go back through shared memory a tile at a time
//     and out a row segment at a time, coalesced.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStates = 16;
constexpr int kRows = 32;          // rows a block: one warp
constexpr int kTile = 32;          // symbols a staged tile
constexpr int kPitch = kTile + 1;  // a staged row of pairs, in float2
constexpr int kOutPitch = 36;      // a row of bits, in bytes (9 words: no
                                   // two lanes' rows share a bank)
constexpr float kInf = 1.5e38f;    // float32(3e38) / 2, the JAX package's

__host__ __device__ constexpr int parity(int x) {
    return x ? (x & 1) ^ parity(x >> 1) : 0;
}

// g0·2 + g1 of the step into next state ns from predecessor 2·(ns&7) + j
// (encoder window (bit << 4) | p, G0 = 0b10101, G1 = 0b10011)
__host__ __device__ constexpr int dibit(int ns, int j) {
    return parity(((((ns >> 3) & 1) << 4) | (2 * (ns & 7) + j)) & 0b10101)
               * 2
           + parity(((((ns >> 3) & 1) << 4) | (2 * (ns & 7) + j)) & 0b10011);
}

// DQPSK_EXP[e] = 1, -j, +j, -1
__device__ constexpr float exp_re(int e) {
    return e == 0 ? 1.f : (e == 3 ? -1.f : 0.f);
}
__device__ constexpr float exp_im(int e) {
    return e == 1 ? -1.f : (e == 2 ? 1.f : 0.f);
}
// (-j)^q = 1, -j, -1, +j, and the q that DQPSK_EXP[e] adds
__device__ constexpr float phase_re(int q) {
    return q == 0 ? 1.f : (q == 2 ? -1.f : 0.f);
}
__device__ constexpr float phase_im(int q) {
    return q == 1 ? -1.f : (q == 3 ? 1.f : 0.f);
}
__host__ __device__ constexpr int inc(int e) {
    return e == 0 ? 0 : (e == 1 ? 1 : (e == 2 ? 3 : 2));
}

// The coherent selection's premise: the two successors of a predecessor
// take increments that differ by 2 (both generators tap the input bit).
constexpr bool successors_differ_by_two() {
    for (int p = 0; p < kStates; ++p)
        if (((inc(dibit(p >> 1, p & 1)) + 2) & 3)
            != inc(dibit((p >> 1) + 8, p & 1)))
            return false;
    return true;
}
static_assert(successors_differ_by_two(), "coherent length selection");

__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Lane's share of staging tile `tile` of the block's rows into buf:
// 8-byte cp.async, 32 lanes on 32 consecutive pairs of one row.
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

// A symbol's four branch terms: the metrics |z - DQPSK_EXP[e]|² (non-
// coherent) or the lengths |z - (-j)^k| (coherent), k = 0..3.
template <bool kCoherent>
__device__ __forceinline__ float4 branch(float2 z) {
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float h = kCoherent
            ? hypotf(__fsub_rn(z.x, phase_re(k)), __fsub_rn(z.y, phase_im(k)))
            : hypotf(__fsub_rn(z.x, exp_re(k)), __fsub_rn(z.y, exp_im(k)));
        t[k] = kCoherent ? h : __fmul_rn(h, h);
    }
    return make_float4(t[0], t[1], t[2], t[3]);
}

__device__ __forceinline__ float term(float4 b, int k) {
    return k == 0 ? b.x : (k == 1 ? b.y : (k == 2 ? b.z : b.w));
}

// One add-compare-select step on a symbol's branch terms; returns the
// survivor mask.
template <bool kCoherent>
__device__ __forceinline__ uint32_t acs(float4 b, float (&pm)[kStates],
                                        uint32_t (&q)[kStates]) {
    float np[kStates];
    uint32_t nq[kStates];
    uint32_t mask = 0;
    if constexpr (!kCoherent) {
#pragma unroll
        for (int ns = 0; ns < kStates; ++ns) {
            const int p = 2 * (ns & 7);
            const float c0 = __fadd_rn(pm[p], term(b, dibit(ns, 0)));
            const float c1 = __fadd_rn(pm[p + 1], term(b, dibit(ns, 1)));
            const bool t = c1 < c0;
            np[ns] = t ? c1 : c0;
            mask |= static_cast<uint32_t>(t) << ns;
        }
    } else {
        // Predecessor p feeds next states p >> 1 (input 0) and (p >> 1) + 8
        // (input 1), whose dibits differ in both bits, so their phase
        // increments are c and c + 2: with lo = q & 1, A = |z - (-j)^(lo+c)|
        // and B = |z - (-j)^(lo+c+2)|, the two lengths are (q & 2 ? B : A)
        // and (q & 2 ? A : B). q counts mod 4 in its low two bits
        // (unsigned, so it wraps by a multiple of 4).
        float h[kStates][2];
#pragma unroll
        for (int p = 0; p < kStates; ++p) {
            const int c = inc(dibit(p >> 1, p & 1));
            const bool lo = q[p] & 1u, hi = q[p] & 2u;
            const float a = lo ? term(b, (c + 1) & 3) : term(b, c);
            const float bb = lo ? term(b, (c + 3) & 3) : term(b, (c + 2) & 3);
            h[p][0] = hi ? bb : a;
            h[p][1] = hi ? a : bb;
        }
#pragma unroll
        for (int ns = 0; ns < kStates; ++ns) {
            const int p = 2 * (ns & 7), up = ns >> 3;
            const float h0 = h[p][up], h1 = h[p + 1][up];
            const float c0 = __fmaf_rn(h0, h0, pm[p]);
            const float c1 = __fmaf_rn(h1, h1, pm[p + 1]);
            const bool t = c1 < c0;
            np[ns] = t ? c1 : c0;
            nq[ns] = t ? q[p + 1] + inc(dibit(ns, 1))
                       : q[p] + inc(dibit(ns, 0));
            mask |= static_cast<uint32_t>(t) << ns;
        }
#pragma unroll
        for (int ns = 0; ns < kStates; ++ns) q[ns] = nq[ns];
    }
    float m[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = min_nan(np[2 * i], np[2 * i + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = min_nan(m[2 * i], m[2 * i + 1]);
    m[0] = min_nan(min_nan(m[0], m[1]), min_nan(m[2], m[3]));
#pragma unroll
    for (int ns = 0; ns < kStates; ++ns) pm[ns] = __fsub_rn(np[ns], m[0]);
    return mask;
}

template <bool kCoherent>
__global__ void __launch_bounds__(kRows)
psk31_viterbi_kernel(const float2* __restrict__ pairs, int rows, int64_t n,
                     uint16_t* __restrict__ masks,
                     uint8_t* __restrict__ bits) {
    __shared__ __align__(16) float2 in[2][kRows][kPitch];
    __shared__ __align__(16) float4 terms[kRows][kPitch];
    __shared__ uint8_t out[kRows][kOutPitch];
    const int lane = threadIdx.x;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
    const int nrows = static_cast<int>(rows - row0 < kRows ? rows - row0
                                                           : kRows);
    const float2* zb = pairs + row0 * n;
    const bool live = lane < nrows;
    float pm[kStates];
    uint32_t q[kStates];
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
        pm[s] = s == 0 ? 0.f : kInf;
        q[s] = 0;
    }
    uint16_t* mrow = masks + row0 + lane;   // step k at mrow[k * rows]
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    stage(zb, n, nrows, 0, in[0]);
    for (int64_t tile = 0; tile < n_tiles; ++tile) {
        if (tile + 1 < n_tiles)
            stage(zb, n, nrows, tile + 1, in[(tile + 1) & 1]);
        else
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncwarp();
        const int64_t k0 = tile * kTile;
        const int m = static_cast<int>(n - k0 < kTile ? n - k0 : kTile);
        // the tile's branch terms, lane j on symbol j of each live row, off
        // the rows' chains (one row or 32, the warp shares the work)
        if (lane < m) {
            for (int r = 0; r < nrows; ++r)
                terms[r][lane] = branch<kCoherent>(in[tile & 1][r][lane]);
        }
        __syncwarp();
        if (live) {
#pragma unroll 4
            for (int j = 0; j < m; ++j)
                mrow[(k0 + j) * rows] = static_cast<uint16_t>(
                    acs<kCoherent>(terms[lane][j], pm, q));
        }
        __syncwarp();        // terms and the tile's slot are written again
    }
    // the first minimum, or the first NaN (torch.argmin's rule)
    int s = 0;
    float best = pm[0];
#pragma unroll
    for (int k = 1; k < kStates; ++k) {
        if (!(best != best) && (pm[k] != pm[k] || pm[k] < best)) {
            s = k;
            best = pm[k];
        }
    }
    for (int64_t tile = n_tiles - 1; tile >= 0; --tile) {
        const int64_t k0 = tile * kTile;
        const int m = static_cast<int>(n - k0 < kTile ? n - k0 : kTile);
        uint32_t mk[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i)
            mk[i] = (live && i < m) ? mrow[(k0 + i) * rows] : 0u;
#pragma unroll
        for (int i = kTile - 1; i >= 0; --i) {
            if (i < m) {
                out[lane][i] = static_cast<uint8_t>((s >> 3) & 1);
                s = 2 * (s & 7) + static_cast<int>((mk[i] >> s) & 1u);
            }
        }
        __syncwarp();
        if (lane < m) {
            for (int r = 0; r < nrows; ++r)
                bits[(row0 + r) * n + k0 + lane] = out[r][lane];
        }
        __syncwarp();
    }
}

template <bool kCoherent>
int launch(const float2* z, int rows, int64_t n, uint16_t* masks,
           uint8_t* bits, cudaStream_t s) {
    const dim3 grid((rows + kRows - 1) / kRows);
    psk31_viterbi_kernel<kCoherent><<<grid, kRows, 0, s>>>(z, rows, n, masks,
                                                           bits);
    return static_cast<int>(cudaGetLastError());
}

__global__ void lengths_kernel(const float2* __restrict__ z, int64_t n,
                               float* __restrict__ h) {
    for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                     + threadIdx.x;
         i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
        h[i] = hypotf(z[i].x, z[i].y);
}

}  // namespace

// pairs: (rows, n) [re, im] float32 pairs as float2, 8-byte aligned;
// masks: (n, rows) uint16 scratch; bits: (rows, n) uint8; all contiguous.
// coherent selects viterbi_decode_coherent's metric. Returns the CUDA error
// of the launch (0 when it was accepted).
extern "C" int psk31_viterbi(const void* pairs, int rows, int64_t n,
                             int coherent, void* masks, uint8_t* bits,
                             void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    const auto z = static_cast<const float2*>(pairs);
    const auto mk = static_cast<uint16_t*>(masks);
    const auto s = static_cast<cudaStream_t>(stream);
    return coherent ? launch<true>(z, rows, n, mk, bits, s)
                    : launch<false>(z, rows, n, mk, bits, s);
}

// h[i] = hypotf(re, im) of z[i] (complex64 as float2), as the kernel forms a
// branch length: for holding that form to torch's complex abs on the card.
extern "C" int psk31_viterbi_lengths(const void* z, int64_t n, float* h,
                                     void* stream) {
    if (n <= 0) return 0;
    const int64_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
    lengths_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(z), n, h);
    return static_cast<int>(cudaGetLastError());
}
