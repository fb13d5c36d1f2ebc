// Batched soft-decision Viterbi (ACS + traceback) for Hopper (sm_90a).
//
// Replaces orion_sdr_tpu/ops/viterbi.py:200 _make_kernel (the radix-2 Pallas
// TPU kernel behind viterbi_chunks_pallas and viterbi_decode_soft_pallas),
// with the semantics of the jnp references in orion_sdr_tpu/fec/conv.py:
//  * ACS: cand_z = pm[prev(ns, z)] + s0[ns,z]*l0 + s1[ns,z]*l1, added in that
//    order; z = 1 only where cand_1 > cand_0 strictly; the new metric is the
//    chosen candidate. prev(ns, z) = ((ns & (S/2-1)) << 1) | z.
//  * terminated mode (pm0 == nullptr): metrics start at 0 on state 0 and
//    -1e30 elsewhere, are never renormalised, and the traceback starts at
//    state 0 (zero-tail termination);
//  * chunked mode: metrics start from the lane's row of pm0, the per-step
//    maximum is subtracted after every step, and the traceback starts at the
//    argmax of the final metrics (lowest state index on ties).
//  The decoded bit of a step is the top bit of the state the traceback
//  stands on. Built with -fmad=false; every float operation rounds exactly
//  as the plain torch version's separate tensor operations do, so the two
//  agree bit for bit on any float input.
//
// What bounds it on this card: latency. Each lane (a codeword, or one chunk
// of a stream) is a chain of T dependent steps (gather predecessors, add,
// compare, select, and in chunked mode a 64-way max), so a lane's time is T
// times one step's latency, and the card is filled only by the number of
// lanes in flight. Device memory sees the LLRs once and the bits once.
//
// Design: one warp per lane. Thread j owns butterfly j: predecessor states
// 2j and 2j+1 feed next states j and j + S/2, so for S = 64 every thread
// updates two states per step, keeping their metrics in registers and
// fetching the predecessors' with __shfl_sync. The warp loads 32 steps of
// LLRs at a time, coalesced, and broadcasts one step's pair per step by
// shuffle. Each step's survivor bits are two __ballot_sync words (8 bytes a
// step), kept in shared memory (9.7 KB a lane at T = 1216), or in a global
// scratch buffer when a trellis is too long for shared memory. One thread
// walks the traceback and leaves each step's bit in the decision slot it
// has just read; the warp then writes the bits out coalesced. Lanes are
// independent, so short blocks of a few warps keep many lanes resident per
// SM to hide the step latency. For k5 (S = 16) only 8 threads of the warp
// are busy.
//
// The TPU kernel's one-hot MXU products, interleaved (8, B) LLR plane, bf16
// LLRs, VMEM budget and lane padding have no counterpart here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1.0e30f;
// target shared memory per block: a few warps' decision planes
constexpr size_t kSmemTarget = 24 * 1024;

struct Signs {
    float a[2][2];  // sign of coded bit 0, [half][z]
    float b[2][2];  // sign of coded bit 1
};

template <bool CHUNKED>
__device__ __forceinline__ void acs_step(float la, float lb, const Signs& sg,
                                         int src0, int src1, bool slot,
                                         unsigned hmask, bool active,
                                         float& pm_lo, float& pm_hi,
                                         uint2* dec_t, bool writer) {
    // predecessor metrics pm[2j] and pm[2j+1]
    const float x_lo = __shfl_sync(kFull, pm_lo, src0);
    const float x_hi = __shfl_sync(kFull, pm_hi, src0);
    const float y_lo = __shfl_sync(kFull, pm_lo, src1);
    const float y_hi = __shfl_sync(kFull, pm_hi, src1);
    const float p0 = slot ? x_hi : x_lo;
    const float p1 = slot ? y_hi : y_lo;
    const float c0 = (p0 + sg.a[0][0] * la) + sg.b[0][0] * lb;
    const float c1 = (p1 + sg.a[0][1] * la) + sg.b[0][1] * lb;
    const float e0 = (p0 + sg.a[1][0] * la) + sg.b[1][0] * lb;
    const float e1 = (p1 + sg.a[1][1] * la) + sg.b[1][1] * lb;
    const bool d_lo = c1 > c0;
    const bool d_hi = e1 > e0;
    float n_lo = d_lo ? c1 : c0;
    float n_hi = d_hi ? e1 : e0;
    const unsigned w_lo = __ballot_sync(kFull, d_lo) & hmask;
    const unsigned w_hi = __ballot_sync(kFull, d_hi) & hmask;
    if (writer) *dec_t = make_uint2(w_lo, w_hi);
    if (CHUNKED) {
        float m = active ? (n_hi > n_lo ? n_hi : n_lo) : -INFINITY;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float o = __shfl_xor_sync(kFull, m, off);
            m = o > m ? o : m;
        }
        n_lo = n_lo - m;
        n_hi = n_hi - m;
    }
    pm_lo = n_lo;
    pm_hi = n_hi;
}

template <bool CHUNKED>
__global__ void __launch_bounds__(256)
viterbi_kernel(const float* __restrict__ l0, const float* __restrict__ l1,
               long long ld, int es, const float* __restrict__ pm0, int L,
               int T, int K, int g0, int g1, uint8_t* __restrict__ bits,
               uint2* __restrict__ dec_global) {
    extern __shared__ uint2 s_dec[];
    const int warp = threadIdx.x >> 5;
    const int j = threadIdx.x & 31;
    const int lane = blockIdx.x * (blockDim.x >> 5) + warp;
    if (lane >= L) return;  // whole warps leave; no block-wide barrier below

    const int top = K - 2;
    const int H = 1 << top;  // butterflies = S/2
    const int S = 2 * H;
    const bool active = j < H;
    const unsigned hmask = H >= 32 ? kFull : ((1u << H) - 1u);
    uint2* dec = dec_global ? dec_global + static_cast<size_t>(lane) * T
                            : s_dec + static_cast<size_t>(warp) * T;

    // butterfly j: predecessors p = 2j + z; next states j (half 0) and j + H
    // (half 1); state s lives in thread s & (H-1), slot s >= H
    Signs sg;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int z = 0; z < 2; ++z) {
            const int p = (2 * j + z) & (S - 1);
            const int window = (half << (K - 1)) | p;
            sg.a[half][z] = 1.0f - 2.0f * static_cast<float>(__popc(window & g0) & 1);
            sg.b[half][z] = 1.0f - 2.0f * static_cast<float>(__popc(window & g1) & 1);
        }
    const int src0 = (2 * j) & (H - 1);
    const int src1 = (2 * j + 1) & (H - 1);
    const bool slot = ((2 * j) & (S - 1)) >= H;

    float pm_lo, pm_hi;
    if (CHUNKED) {
        const float* row = pm0 + static_cast<size_t>(lane) * S;
        pm_lo = active ? row[j] : 0.0f;
        pm_hi = active ? row[j + H] : 0.0f;
    } else {
        pm_lo = j == 0 ? 0.0f : kNeg;
        pm_hi = kNeg;
    }

    const float* r0 = l0 + static_cast<size_t>(lane) * ld;
    const float* r1 = l1 + static_cast<size_t>(lane) * ld;
    for (int t0 = 0; t0 < T; t0 += 32) {
        const int t = t0 + j;
        const float a = t < T ? r0[static_cast<size_t>(t) * es] : 0.0f;
        const float b = t < T ? r1[static_cast<size_t>(t) * es] : 0.0f;
        if (t0 + 32 <= T) {
#pragma unroll 8
            for (int i = 0; i < 32; ++i)
                acs_step<CHUNKED>(__shfl_sync(kFull, a, i),
                                  __shfl_sync(kFull, b, i), sg, src0, src1,
                                  slot, hmask, active, pm_lo, pm_hi,
                                  dec + t0 + i, j == 0);
        } else {
            for (int i = 0; i < T - t0; ++i)
                acs_step<CHUNKED>(__shfl_sync(kFull, a, i),
                                  __shfl_sync(kFull, b, i), sg, src0, src1,
                                  slot, hmask, active, pm_lo, pm_hi,
                                  dec + t0 + i, j == 0);
        }
    }

    int state = 0;
    if (CHUNKED) {
        // argmax of the final metrics, lowest state index on ties
        float v = active ? pm_lo : -INFINITY;
        int idx = active ? j : S;
        if (active && pm_hi > v) {
            v = pm_hi;
            idx = j + H;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(kFull, v, off);
            const int oi = __shfl_xor_sync(kFull, idx, off);
            if (ov > v || (ov == v && oi < idx)) {
                v = ov;
                idx = oi;
            }
        }
        state = idx;
    }

    // traceback by thread 0, which also wrote every decision word; the bit
    // of step t goes to the first byte of the slot it has just consumed
    if (j == 0) {
        for (int t = T - 1; t >= 0; --t) {
            const uint2 w = dec[t];
            const int low = state & (H - 1);
            const unsigned word = state >= H ? w.y : w.x;
            const int z = static_cast<int>((word >> low) & 1u);
            reinterpret_cast<uint8_t*>(dec + t)[0] =
                static_cast<uint8_t>(state >> top);
            state = (low << 1) | z;
        }
    }
    __syncwarp();
    uint8_t* out = bits + static_cast<size_t>(lane) * T;
    for (int t = j; t < T; t += 32)
        out[t] = reinterpret_cast<const uint8_t*>(dec + t)[0];
}

}  // namespace

// Decodes L lanes of a T-step trellis of the rate-1/2 mother code with
// constraint length K (3..7) and generators g0, g1. Step t of lane i reads
// l0[i*ld + t*es] and l1[i*ld + t*es]. pm0: (L, 2^(K-1)) initial metrics for
// the chunked mode, or nullptr for the terminated mode. bits: (L, T) uint8
// decoded bits. dec_scratch: nullptr to keep the decisions in shared memory,
// or an (L, T) array of 8-byte words for trellises too long for it. Returns
// a cudaError_t code (0 on a successful launch).
extern "C" int viterbi_acs_traceback(const float* l0, const float* l1,
                                     long long ld, int es, const float* pm0,
                                     int L, int T, int K, int g0, int g1,
                                     uint8_t* bits, void* dec_scratch,
                                     void* stream) {
    if (L <= 0 || T <= 0) return 0;
    if (K < 3 || K > 7) return static_cast<int>(cudaErrorInvalidValue);
    const size_t per_lane = static_cast<size_t>(T) * sizeof(uint2);
    int warps = 4;
    size_t smem = 0;
    if (dec_scratch == nullptr) {
        warps = static_cast<int>(kSmemTarget / per_lane);
        warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
        smem = static_cast<size_t>(warps) * per_lane;
    }
    auto fn = pm0 != nullptr ? viterbi_kernel<true> : viterbi_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int grid = (L + warps - 1) / warps;
    fn<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        l0, l1, ld, es, pm0, L, T, K, g0, g1, bits,
        static_cast<uint2*>(dec_scratch));
    return static_cast<int>(cudaGetLastError());
}
