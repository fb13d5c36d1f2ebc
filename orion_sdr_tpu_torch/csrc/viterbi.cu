// Batched soft-decision Viterbi (ACS + traceback) for Hopper (sm_90a), in
// two radices.
//
// Radix 2 replaces orion_sdr_tpu/ops/viterbi.py:200 _make_kernel (the
// radix-2 Pallas TPU kernel behind viterbi_chunks_pallas and
// viterbi_decode_soft_pallas), with the semantics of the jnp references in
// orion_sdr_tpu/fec/conv.py:
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
//
// Radix 4 replaces orion_sdr_tpu/ops/viterbi.py:347 _make_kernel4: four
// trellis steps a phase. In the shift-register convention the 16
// predecessors of state ns four steps back are the contiguous block
// base + idx, base = (ns << 4) & (S-1), idx = z1 + 2 z2 + 4 z3 + 8 z4 (z1
// the first step's decision). Both states j and j + S/2 of thread j share
// that block, so each phase the warp stages its metrics in shared memory
// (S floats) and every thread reads its 16 predecessors once. Step i's
// branch value is s = l0 + l1 or d = l0 - l1, negated by the coded bits of
// the window X >> i, X = (ns << 4) | idx (patterns precomputed per thread,
// one byte a candidate); candidate = pm[pred] + ((v0 + v1) + (v2 + v3)).
// A four-level select tree (pairs adjacent in idx first: z1, then z2, z3,
// z4; the upper one only where strictly greater) gives the survivor and its
// 4-bit decision, kept as four ballot words per state half; the maximum is
// subtracted once a phase in both modes. The traceback reads one 4-bit
// decision a phase and emits four bits (the state's top four bits). The
// plain torch version (ops/viterbi.py::_acs_traceback4) does the same
// float operations in the same order.

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

// Radix 4. Decisions: per phase two uint4 (state half 0, half 1), word k
// holding bit k of every state's 4-bit decision; the traceback leaves the
// phase's four output bits in the first four bytes of its first uint4.
template <bool CHUNKED>
__global__ void __launch_bounds__(256)
viterbi4_kernel(const float* __restrict__ l0, const float* __restrict__ l1,
                long long ld, int es, const float* __restrict__ pm0, int L,
                int T, int K, int g0, int g1, uint8_t* __restrict__ bits,
                uint4* __restrict__ dec_global) {
    extern __shared__ uint4 s_mem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int j = threadIdx.x & 31;
    const int lane = blockIdx.x * warps + warp;
    if (lane >= L) return;  // whole warps leave; no block-wide barrier below

    const int top = K - 2;
    const int H = 1 << top;
    const int S = 2 * H;
    const int T4 = T >> 2;
    const bool active = j < H;
    const unsigned hmask = H >= 32 ? kFull : ((1u << H) - 1u);
    // shared memory: [warps][64] metric staging, then (shared mode) the
    // decision planes [warps][2 * T4]
    float* s_pm = reinterpret_cast<float*>(s_mem) + warp * 64;
    uint4* dec = dec_global
        ? dec_global + static_cast<size_t>(lane) * 2 * T4
        : s_mem + warps * 16 + static_cast<size_t>(warp) * 2 * T4;

    // per candidate of each state half, the branch pattern of its four
    // steps: bit 2i = step i uses d (else s), bit 2i+1 = negated
    uint32_t pat[2][4];
    const int base = (j << 4) & (S - 1);
    const int wmask = (1 << K) - 1;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            uint32_t w = 0;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int idx = 4 * q + r;
                const int x = ((j + half * H) << 4) | idx;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int win = (x >> i) & wmask;
                    const uint32_t ca = __popc(win & g0) & 1;
                    const uint32_t cb = __popc(win & g1) & 1;
                    w |= ((ca ^ cb) | (ca << 1)) << (8 * r + 2 * i);
                }
            }
            pat[half][q] = w;
        }

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
        const int phases = (T - t0 >= 32 ? 32 : T - t0) >> 2;
        for (int ph = 0; ph < phases; ++ph) {
            float sv[4], dv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float la = __shfl_sync(kFull, a, 4 * ph + i);
                const float lb = __shfl_sync(kFull, b, 4 * ph + i);
                sv[i] = la + lb;
                dv[i] = la - lb;
            }
            __syncwarp();
            if (active) {
                s_pm[j] = pm_lo;
                s_pm[j + H] = pm_hi;
            }
            __syncwarp();
            float p[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) p[k] = s_pm[base + k];

            float nv[2];
            int nd[2];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                float val[16];
                int idx[16];
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                    const uint32_t w = pat[half][k >> 2] >> (8 * (k & 3));
                    float v[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float m = (w >> (2 * i)) & 1u ? dv[i] : sv[i];
                        v[i] = (w >> (2 * i + 1)) & 1u ? -m : m;
                    }
                    val[k] = p[k] + ((v[0] + v[1]) + (v[2] + v[3]));
                    idx[k] = k;
                }
#pragma unroll
                for (int n = 8; n >= 1; n >>= 1)
#pragma unroll
                    for (int k = 0; k < n; ++k) {
                        const bool up = val[2 * k + 1] > val[2 * k];
                        val[k] = up ? val[2 * k + 1] : val[2 * k];
                        idx[k] = up ? idx[2 * k + 1] : idx[2 * k];
                    }
                nv[half] = val[0];
                nd[half] = idx[0];
            }
            const int g = (t0 >> 2) + ph;
            unsigned wl[4], wh[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                wl[k] = __ballot_sync(kFull, (nd[0] >> k) & 1) & hmask;
                wh[k] = __ballot_sync(kFull, (nd[1] >> k) & 1) & hmask;
            }
            if (j == 0) {
                dec[2 * g] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
                dec[2 * g + 1] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
            }
            float m = active ? (nv[1] > nv[0] ? nv[1] : nv[0]) : -INFINITY;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float o = __shfl_xor_sync(kFull, m, off);
                m = o > m ? o : m;
            }
            pm_lo = nv[0] - m;
            pm_hi = nv[1] - m;
        }
    }

    int state = 0;
    if (CHUNKED) {
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

    if (j == 0) {
        for (int g = T4 - 1; g >= 0; --g) {
            const uint4 w = dec[2 * g + (state >= H ? 1 : 0)];
            const int low = state & (H - 1);
            const int d = static_cast<int>(((w.x >> low) & 1u)
                                           | (((w.y >> low) & 1u) << 1)
                                           | (((w.z >> low) & 1u) << 2)
                                           | (((w.w >> low) & 1u) << 3));
            uint8_t* o = reinterpret_cast<uint8_t*>(dec + 2 * g);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                o[3 - i] = static_cast<uint8_t>((state >> (top - i)) & 1);
            state = ((state << 4) | d) & (S - 1);
        }
    }
    __syncwarp();
    uint8_t* out = bits + static_cast<size_t>(lane) * T;
    for (int t = j; t < T; t += 32)
        out[t] = reinterpret_cast<const uint8_t*>(dec + 2 * (t >> 2))[t & 3];
}

}  // namespace

// Decodes L lanes of a T-step trellis of the rate-1/2 mother code with
// constraint length K (3..7) and generators g0, g1, in radix 2 or 4 (radix
// 4 needs T % 4 == 0 and K >= 5). Step t of lane i reads l0[i*ld + t*es]
// and l1[i*ld + t*es]. pm0: (L, 2^(K-1)) initial metrics for the chunked
// mode, or nullptr for the terminated mode. bits: (L, T) uint8 decoded bits.
// dec_scratch: nullptr to keep the decisions in shared memory, or an 8*T
// byte scratch per lane for trellises too long for it. Returns a
// cudaError_t code (0 on a successful launch).
extern "C" int viterbi_acs_traceback(const float* l0, const float* l1,
                                     long long ld, int es, const float* pm0,
                                     int L, int T, int K, int g0, int g1,
                                     int radix, uint8_t* bits,
                                     void* dec_scratch, void* stream) {
    if (L <= 0 || T <= 0) return 0;
    if (K < 3 || K > 7) return static_cast<int>(cudaErrorInvalidValue);
    if (radix != 2 && radix != 4) return static_cast<int>(cudaErrorInvalidValue);
    if (radix == 4 && (T % 4 != 0 || K < 5))
        return static_cast<int>(cudaErrorInvalidValue);
    // both radices keep 8 bytes of decisions a step a lane; radix 4 also
    // stages 64 metrics a warp
    const size_t per_lane = static_cast<size_t>(T) * sizeof(uint2);
    const size_t staging = radix == 4 ? 64 * sizeof(float) : 0;
    int warps = 4;
    size_t smem = 4 * staging;
    if (dec_scratch == nullptr) {
        warps = static_cast<int>(kSmemTarget / per_lane);
        warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
        smem = static_cast<size_t>(warps) * (per_lane + staging);
    }
    const int grid = (L + warps - 1) / warps;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (radix == 4) {
        auto fn = pm0 != nullptr ? viterbi4_kernel<true> : viterbi4_kernel<false>;
        if (smem > 48 * 1024) {
            const cudaError_t err = cudaFuncSetAttribute(
                fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        fn<<<grid, warps * 32, smem, st>>>(l0, l1, ld, es, pm0, L, T, K, g0,
                                           g1, bits,
                                           static_cast<uint4*>(dec_scratch));
        return static_cast<int>(cudaGetLastError());
    }
    auto fn = pm0 != nullptr ? viterbi_kernel<true> : viterbi_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    fn<<<grid, warps * 32, smem, st>>>(l0, l1, ld, es, pm0, L, T, K, g0, g1,
                                       bits, static_cast<uint2*>(dec_scratch));
    return static_cast<int>(cudaGetLastError());
}
