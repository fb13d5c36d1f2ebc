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
// Radix 4 replaces orion_sdr_tpu/ops/viterbi.py:347 _make_kernel4: four
// trellis steps a phase, T % 4 == 0, S >= 16. The 16 predecessors of state
// ns four steps back are the contiguous block base + idx, base = (ns << 4) &
// (S-1), idx = z1 + 2 z2 + 4 z3 + 8 z4 (z1 the first step's decision); a
// candidate is pm[base + idx] + ((v0 + v1) + (v2 + v3)), step i's value v_i
// being s = l0 + l1 or d = l0 - l1, negated as the coded bits say; a
// four-level select tree (pairs adjacent in idx first: z1, then z2, z3, z4;
// the upper one only where strictly greater) gives the survivor and its
// 4-bit decision; the maximum is subtracted once a phase in both modes. The
// plain version is ops/viterbi.py::_acs_traceback4.
//
// What bounds them on this card: latency and instruction slots, not bytes. A
// lane (a codeword, or one chunk of a stream) is a chain of T dependent steps;
// device memory sees the LLRs once and the bits once. So a lane's time is
// its step chain, and the card's time is the lanes in flight times the
// instructions each step runs (PERF.md: both kernels at a few % of the
// operation bound). The first design (one warp per lane, a 5-level shuffle
// maximum a step, every decision word a ballot; radix 4 with 16-wide value
// and index arrays a thread, 254 registers) spent its time in the shuffle
// chains, in the per-candidate branch sums of radix 4 and in too few
// resident lanes. This design:
//  * keeps one warp per lane; thread j owns states j and j + S/2; the idle
//    threads of K < 7 repeat an active thread's work exactly, so nothing
//    has to be masked out of a maximum;
//  * takes each renormalising maximum with one __reduce_max_sync (redux.sync)
//    on an order-preserving integer image of the float (the bits where the
//    sign is clear, else the bits ^ 0x7fffffff). It equals the shuffle
//    chain's maximum for every non-NaN value but for +0.0 against -0.0, which
//    '>' compares as equal: no decision and no traceback start changes;
//  * radix 2 passes the metrics through a shared copy (two buffers, one
//    __syncwarp a step; each thread reads its two predecessors as one 8-byte
//    load) and the LLR pairs of each 32-step block through another, and
//    forms the four candidates from two products instead of eight
//    (generators that tap both end stages);
//  * keeps each thread's own decision bits in registers over a block of 32
//    steps (radix 2: one word a state; radix 4: a nibble a state and phase,
//    four phases a word) and stores them once a block, coalesced, instead
//    of ballots every step. Radix 2 keeps its first four blocks' words in
//    registers for the whole lane, so a lane of 1216 steps takes 9472 B of
//    shared memory and 24 lanes fit on an SM: the DVB-T batch (3168 lanes)
//    runs in one wave;
//  * radix 4 builds the lane's table of the 256 four-step sums once a phase
//    (8 entries a thread, each one add of two pair sums v0 + v1 and
//    v2 + v3 taken from the warp by shuffle), so a candidate is one shared
//    load and one add; the table's addresses (ops/viterbi.py::
//    radix4_sum_table, built on the host) are a GF(2) image of the pattern
//    chosen so that no load of the warp meets a bank conflict; the select
//    tree runs as a stream, merging each finished pair at once (a stack of
//    depth 4), over the 16 predecessor metrics read as four 16-byte loads
//    from a padded staging copy: no stack frame, registers for 16 resident
//    lanes a SM;
//  * the traceback is walked by all 32 threads of the warp together on the
//    same state (broadcast loads), thread j keeping the bit of step j of the
//    current 32-step block and writing it out when the block is done;
//  * the launch picks its block size from cudaOccupancyMaxActiveBlocksPer-
//    Multiprocessor (viterbi_launch_plan), queried at the first launch of a
//    device, radix, mode and T and kept, and spreads a small batch one lane
//    a block over the SMs, where only one lane's latency counts.
// Decisions go to a global scratch buffer instead of shared memory when a
// trellis is too long for it (ops/viterbi.py::MAX_SMEM_STEPS).
//
// The TPU kernels' one-hot MXU products, interleaved (8, B) LLR plane, bf16
// LLRs, VMEM budget and lane padding have no counterpart here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1.0e30f;
constexpr int kMaxWarps = 8;
// radix 4, per warp: two 256-float sum tables, two padded 64-state staging
// copies (72 floats: 4 floats of padding after each 32 states) and the LLR
// pairs of a 32-step block
constexpr int kR4WarpFloats = 2 * 256 + 2 * 72 + 64;

// order-preserving integer image of a float (non-NaN), and back
__device__ __forceinline__ int ord_key(float x) {
    const int i = __float_as_int(x);
    return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int k) {
    return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ float warp_max(float x) {
    return key_float(__reduce_max_sync(kFull, ord_key(x)));
}

// argmax over the warp's states, lowest state index on ties (chunked start)
__device__ __forceinline__ int warp_argmax(float lo, float hi, int j, int H,
                                           bool active) {
    float v = active ? lo : -INFINITY;
    int idx = active ? j : 2 * H;
    if (active && hi > v) {
        v = hi;
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
    return idx;
}

// Radix 2: decision blocks kept in registers for the whole lane, and the
// per-warp staging floats (the LLR pairs of a 32-step block, two copies of
// the 64 metrics)
constexpr int kKeepBlocks = 4;
constexpr int kR2StageFloats = 64 + 2 * 64;

// one radix-2 step on the metrics staged in buf: new metrics of states jj
// (lo) and jj + H (hi), decisions d_lo and d_hi. sa, sb: the signs of coded
// bits 0 and 1 on branch (half 0, z 0). Both generators tap the first and
// the last stage (end_taps), so branch (1, 1) has the same signs and
// branches (0, 1) and (1, 0) the opposite ones: two products serve the four
// candidates, and p + (-x) rounds as p - x.
template <bool CHUNKED>
__device__ __forceinline__ void r2_step(float2 l, float* buf, int j, int H,
                                        bool active, float sa, float sb,
                                        float& pm_lo, float& pm_hi,
                                        bool& d_lo, bool& d_hi) {
    if (active) {
        buf[j] = pm_lo;
        buf[j + H] = pm_hi;
    }
    __syncwarp();
    // predecessors pm[2jj] and pm[2jj + 1]
    const float2 p = reinterpret_cast<const float2*>(buf)[j & (H - 1)];
    const float u = sa * l.x;
    const float v = sb * l.y;
    const float c0 = (p.x + u) + v;
    const float c1 = (p.y - u) - v;
    const float e0 = (p.x - u) - v;
    const float e1 = (p.y + u) + v;
    d_lo = c1 > c0;
    d_hi = e1 > e0;
    float n_lo = d_lo ? c1 : c0;
    float n_hi = d_hi ? e1 : e0;
    if (CHUNKED) {
        // idle threads (K < 7) hold copies of active ones: no masking
        const float m = warp_max(fmaxf(n_lo, n_hi));
        n_lo = n_lo - m;
        n_hi = n_hi - m;
    }
    pm_lo = n_lo;
    pm_hi = n_hi;
}

// Radix 2. Thread j runs butterfly jj = j & (H-1): predecessors 2jj, 2jj + 1,
// next states jj (lo) and jj + H (hi); threads j >= H (K < 7) repeat thread
// jj exactly and write nothing. Each step the metrics go through a shared
// copy (two buffers, one __syncwarp a step) and each thread reads its two
// predecessors as one 8-byte load. Decisions: per 32-step block, thread j's
// words (bit i = step 32 b + i) for states j (x) and j + H (y); blocks 0-3
// stay in registers, block b >= 4 sits at dec[(b - 4) * 32 + j].
template <bool CHUNKED>
__global__ void __launch_bounds__(256, 3)
viterbi_kernel(const float* __restrict__ l0, const float* __restrict__ l1,
               long long ld, int es, const float* __restrict__ pm0, int L,
               int T, int K, int g0, int g1, uint8_t* __restrict__ bits,
               uint2* __restrict__ dec_global) {
    extern __shared__ float4 s_mem2[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int j = threadIdx.x & 31;
    const int lane = blockIdx.x * warps + warp;
    if (lane >= L) return;  // whole warps leave; no block-wide barrier below

    const int top = K - 2;
    const int H = 1 << top;  // butterflies = S/2
    const int S = 2 * H;
    const int jj = j & (H - 1);
    const bool active = j < H;
    const int nblk = (T + 31) >> 5;
    const int nsh = nblk > kKeepBlocks ? nblk - kKeepBlocks : 0;
    float* s_llr = reinterpret_cast<float*>(s_mem2) + warp * kR2StageFloats;
    float* s_pm = s_llr + 64;
    uint2* dec = dec_global
        ? dec_global + static_cast<size_t>(lane) * nblk * 32
        : reinterpret_cast<uint2*>(reinterpret_cast<float*>(s_mem2)
                                   + warps * kR2StageFloats)
              + static_cast<size_t>(warp) * nsh * 32;

    const float sa = 1.0f - 2.0f * static_cast<float>(__popc((2 * jj) & g0) & 1);
    const float sb = 1.0f - 2.0f * static_cast<float>(__popc((2 * jj) & g1) & 1);

    float pm_lo, pm_hi;
    if (CHUNKED) {
        const float* row = pm0 + static_cast<size_t>(lane) * S;
        pm_lo = row[jj];
        pm_hi = row[jj + H];
    } else {
        pm_lo = jj == 0 ? 0.0f : kNeg;
        pm_hi = kNeg;
    }

    const float* r0 = l0 + static_cast<size_t>(lane) * ld;
    const float* r1 = l1 + static_cast<size_t>(lane) * ld;
    float2* sl = reinterpret_cast<float2*>(s_llr);
    uint2 k0 = make_uint2(0u, 0u), k1 = k0, k2 = k0, k3 = k0;
    for (int b = 0; b < nblk; ++b) {
        const int t0 = b << 5;
        const int t = t0 + j;
        const float a = t < T ? r0[static_cast<size_t>(t) * es] : 0.0f;
        const float c = t < T ? r1[static_cast<size_t>(t) * es] : 0.0f;
        __syncwarp();  // every thread has read the previous block's pairs
        sl[j] = make_float2(a, c);
        __syncwarp();
        const int n = T - t0 < 32 ? T - t0 : 32;
        unsigned w_lo = 0u, w_hi = 0u;
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
            bool d_lo, d_hi;
            r2_step<CHUNKED>(sl[i], s_pm + (i & 1) * 64, j, H, active, sa, sb,
                             pm_lo, pm_hi, d_lo, d_hi);
            w_lo |= static_cast<unsigned>(d_lo) << i;
            w_hi |= static_cast<unsigned>(d_hi) << i;
        }
        const uint2 w = make_uint2(w_lo, w_hi);
        switch (b) {
            case 0: k0 = w; break;
            case 1: k1 = w; break;
            case 2: k2 = w; break;
            case 3: k3 = w; break;
            default: dec[(b - kKeepBlocks) * 32 + j] = w;
        }
    }

    int state = CHUNKED ? warp_argmax(pm_lo, pm_hi, j, H, active) : 0;
    __syncwarp();  // the block words above, before every thread reads them

    // traceback by the whole warp on one state; thread j keeps the bit of
    // step 32 b + j and writes it when block b is done
    uint8_t* out = bits + static_cast<size_t>(lane) * T;
    const unsigned* dw = reinterpret_cast<const unsigned*>(dec);
    for (int b = nblk - 1; b >= 0; --b) {
        const int n = T - (b << 5) < 32 ? T - (b << 5) : 32;
        uint8_t mine = 0;
        if (b >= kKeepBlocks) {
            const unsigned* blk = dw + (b - kKeepBlocks) * 64;
            for (int i = n - 1; i >= 0; --i) {
                const int low = state & (H - 1);
                const unsigned word = blk[2 * low + (state >= H)];
                if (i == j) mine = static_cast<uint8_t>(state >> top);
                state = (low << 1) | static_cast<int>((word >> i) & 1u);
            }
        } else {
            const uint2 kb = b == 0 ? k0 : b == 1 ? k1 : b == 2 ? k2 : k3;
            for (int i = n - 1; i >= 0; --i) {
                const int low = state & (H - 1);
                // state is the same in every thread: all pick one register
                const unsigned word = __shfl_sync(kFull, state >= H ? kb.y : kb.x,
                                                  low);
                if (i == j) mine = static_cast<uint8_t>(state >> top);
                state = (low << 1) | static_cast<int>((word >> i) & 1u);
            }
        }
        if (j < n) out[(b << 5) + j] = mine;
    }
}

// padded staging address of state s: 4 floats after each 32 states, so the
// 16-byte loads of the four predecessor bases (0, 16, 32, 48) of a quarter
// warp fall in distinct banks
__device__ __forceinline__ int r4_pad(int s) { return s + ((s >> 5) << 2); }

// Radix 4. Decisions: per group of four phases, thread j's word holds one
// byte a phase (byte g & 3): the 4-bit decision of state j in the low
// nibble, of state j + H in the high one; group q sits at dec[q * 32 + j].
template <bool CHUNKED>
__global__ void __launch_bounds__(256, 2)
viterbi4_kernel(const float* __restrict__ l0, const float* __restrict__ l1,
                long long ld, int es, const float* __restrict__ pm0, int L,
                int T, int K, const uint8_t* __restrict__ index,
                const uint8_t* __restrict__ spec, uint8_t* __restrict__ bits,
                unsigned* __restrict__ dec_global) {
    extern __shared__ float4 s_mem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int j = threadIdx.x & 31;
    const int lane = blockIdx.x * warps + warp;
    if (lane >= L) return;  // whole warps leave; no block-wide barrier below

    const int top = K - 2;
    const int H = 1 << top;
    const int S = 2 * H;
    const int T4 = T >> 2;
    const int ngrp = (T4 + 3) >> 2;
    const bool active = j < H;
    float* s_tab = reinterpret_cast<float*>(s_mem) + warp * kR4WarpFloats;
    float* s_pm = s_tab + 2 * 256;
    float2* sl = reinterpret_cast<float2*>(s_pm + 2 * 72);
    unsigned* dec = dec_global
        ? dec_global + static_cast<size_t>(lane) * (((T + 31) >> 5) * 64)
        : reinterpret_cast<unsigned*>(s_mem) + warps * kR4WarpFloats
              + static_cast<size_t>(warp) * ngrp * 32;

    // this thread's table entries j + 32 k: their pattern bytes; its states'
    // candidate addresses (16 bytes a state; idle threads of K = 5 repeat an
    // active thread's)
    unsigned sp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        sp[h] = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            sp[h] |= static_cast<unsigned>(spec[j + 32 * (4 * h + k)]) << (8 * k);
    }
    const int row = j & (H - 1);
    const uint4 ix_lo = reinterpret_cast<const uint4*>(index)[row];
    const uint4 ix_hi = reinterpret_cast<const uint4*>(index)[row + H];
    const int base = r4_pad((j << 4) & (S - 1));
    // the pair sum this thread builds: steps 0-1 (j < 16) or 2-3, pattern
    // nibble j & 15 (bit 0 = first step's d, 1 = its sign, 2-3 the second's)
    const int nib = j & 15;
    const int pair = (j >> 4) << 1;

    // idle threads (K < 7) repeat thread row exactly and write nothing
    float pm_lo, pm_hi;
    if (CHUNKED) {
        const float* r = pm0 + static_cast<size_t>(lane) * S;
        pm_lo = r[row];
        pm_hi = r[row + H];
    } else {
        pm_lo = row == 0 ? 0.0f : kNeg;
        pm_hi = kNeg;
    }

    const float* r0 = l0 + static_cast<size_t>(lane) * ld;
    const float* r1 = l1 + static_cast<size_t>(lane) * ld;
    unsigned word = 0u;
    for (int t0 = 0; t0 < T; t0 += 32) {
        const int t = t0 + j;
        const float a = t < T ? r0[static_cast<size_t>(t) * es] : 0.0f;
        const float c = t < T ? r1[static_cast<size_t>(t) * es] : 0.0f;
        const int phases = (T - t0 >= 32 ? 32 : T - t0) >> 2;
        __syncwarp();  // every thread has read the previous block's pairs
        sl[j] = make_float2(a, c);
        __syncwarp();
        for (int ph = 0; ph < phases; ++ph) {
            const int g = (t0 >> 2) + ph;
            // pair sum v_first + v_second of this thread's nibble
            const float4 ll = *reinterpret_cast<const float4*>(sl + 4 * ph + pair);
            const float la0 = ll.x, lb0 = ll.y, la1 = ll.z, lb1 = ll.w;
            float v0 = (nib & 1) ? la0 - lb0 : la0 + lb0;
            float v1 = (nib & 4) ? la1 - lb1 : la1 + lb1;
            v0 = (nib & 2) ? -v0 : v0;
            v1 = (nib & 8) ? -v1 : v1;
            const float q = v0 + v1;
            // table entries j + 32 k: (v0 + v1) + (v2 + v3) of their pattern
            float* tab = s_tab + (g & 1) * 256;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const unsigned p = (sp[k >> 2] >> (8 * (k & 3))) & 0xffu;
                const float lo = __shfl_sync(kFull, q, p & 15u);
                const float hi = __shfl_sync(kFull, q, 16u + (p >> 4));
                tab[j + 32 * k] = lo + hi;
            }
            float* stg = s_pm + (g & 1) * 72;
            if (active) {
                stg[r4_pad(j)] = pm_lo;
                stg[r4_pad(j + H)] = pm_hi;
            }
            __syncwarp();
            float p[16];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float4 v = *reinterpret_cast<const float4*>(stg + base + 4 * k);
                p[4 * k] = v.x;
                p[4 * k + 1] = v.y;
                p[4 * k + 2] = v.z;
                p[4 * k + 3] = v.w;
            }
            // select trees of both states, streamed in idx order: a pending
            // winner per level; the upper one wins only where strictly greater
            float nv[2];
            int nd[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint4 ix = h ? ix_hi : ix_lo;
                const unsigned iw[4] = {ix.x, ix.y, ix.z, ix.w};
                float sv[4];
                int si[4];
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                    const unsigned e = (iw[k >> 2] >> (8 * (k & 3))) & 0xffu;
                    float v = p[k] + tab[e];
                    int id = k;
#pragma unroll
                    for (int lv = 0; lv < 4; ++lv) {
                        if (((k >> lv) & 1) == 0) {
                            sv[lv] = v;
                            si[lv] = id;
                            break;
                        }
                        const bool up = v > sv[lv];
                        v = up ? v : sv[lv];
                        id = up ? id : si[lv];
                    }
                    if (k == 15) {
                        nv[h] = v;
                        nd[h] = id;
                    }
                }
            }
            word |= static_cast<unsigned>(nd[0] | (nd[1] << 4)) << (8 * (g & 3));
            if ((g & 3) == 3 || g == T4 - 1) {
                dec[(g >> 2) * 32 + j] = word;
                word = 0u;
            }
            const float m = warp_max(fmaxf(nv[0], nv[1]));
            pm_lo = nv[0] - m;
            pm_hi = nv[1] - m;
        }
    }

    int state = CHUNKED ? warp_argmax(pm_lo, pm_hi, j, H, active) : 0;
    __syncwarp();

    // traceback by the whole warp on one state: each phase reads one nibble
    // and emits four bits (the state's top four); thread j keeps the bit of
    // step 32 b + j and writes it when block b is done
    uint8_t* out = bits + static_cast<size_t>(lane) * T;
    uint8_t mine = 0;
    for (int g = T4 - 1; g >= 0; --g) {
        const int low = state & (H - 1);
        const unsigned w = dec[(g >> 2) * 32 + low];
        const int d = static_cast<int>(
            (w >> (8 * (g & 3) + (state >= H ? 4 : 0))) & 15u);
        const int r = j - ((4 * g) & 31);  // this thread's step is 4 g + r
        if (r >= 0 && r < 4)
            mine = static_cast<uint8_t>((state >> (top - 3 + r)) & 1);
        state = ((state << 4) | d) & (S - 1);
        if ((g & 7) == 0) {
            const int tb = 4 * g;
            if (tb + j < T) out[tb + j] = mine;
        }
    }
}

struct Plan {
    int warps;          // lanes (warps) a block
    int blocks_per_sm;  // resident blocks an SM, from the occupancy query
    size_t smem;        // dynamic shared memory a block
};

// dynamic shared memory a lane: radix 2 its staging and every 32-step block
// of decisions but the first four; radix 4 its tables, staging and decision
// groups
size_t smem_per_lane(int radix, int T, bool global) {
    if (radix == 4) {
        const size_t groups = static_cast<size_t>(((T >> 2) + 3) >> 2);
        return kR4WarpFloats * sizeof(float) + (global ? 0 : groups * 32 * 4);
    }
    const int nblk = (T + 31) / 32;
    return kR2StageFloats * sizeof(float)
        + (global || nblk <= kKeepBlocks
               ? 0 : static_cast<size_t>(nblk - kKeepBlocks) * 32 * 8);
}

// both generators tap the first and the last stage (see r2_step)
bool end_taps(int K, int g0, int g1) {
    const int ends = 1 | (1 << (K - 1));
    return (g0 & ends) == ends && (g1 & ends) == ends;
}

using R2Kernel = decltype(&viterbi_kernel<true>);
using R4Kernel = decltype(&viterbi4_kernel<true>);

R2Kernel r2_kernel(bool chunked) {
    return chunked ? viterbi_kernel<true> : viterbi_kernel<false>;
}

R4Kernel r4_kernel(bool chunked) {
    return chunked ? viterbi4_kernel<true> : viterbi4_kernel<false>;
}

const void* kernel_for(int radix, bool chunked) {
    if (radix == 4) return reinterpret_cast<const void*>(r4_kernel(chunked));
    return reinterpret_cast<const void*>(r2_kernel(chunked));
}

// what the occupancy queries gave for one (device, radix, mode, T, scratch):
// resident blocks an SM at w lanes a block, and the best w
struct Occupancy {
    int sms;
    size_t per_lane;
    int best_w;
    int blocks[kMaxWarps + 1];
};

std::mutex g_mu;
std::map<int, int> g_max_smem;  // device -> opt-in shared memory a block
std::map<std::tuple<int, int, bool, int, bool>, Occupancy> g_occupancy;

// once a device: its opt-in shared memory, set on all four kernels with the
// shared-memory carveout (caller holds g_mu)
cudaError_t device_setup(int dev, int* max_smem) {
    const auto it = g_max_smem.find(dev);
    if (it != g_max_smem.end()) {
        *max_smem = it->second;
        return cudaSuccess;
    }
    cudaError_t err = cudaDeviceGetAttribute(
        max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int radix = 2; radix <= 4 && err == cudaSuccess; radix += 2) {
        for (int c = 0; c < 2 && err == cudaSuccess; ++c) {
            const void* fn = kernel_for(radix, c != 0);
            err = cudaFuncSetAttribute(
                fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *max_smem);
            if (err == cudaSuccess)
                err = cudaFuncSetAttribute(
                    fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                    cudaSharedmemCarveoutMaxShared);
        }
    }
    if (err == cudaSuccess) g_max_smem[dev] = *max_smem;
    return err;
}

// the occupancy queries of a launch, made at its first use and kept
cudaError_t occupancy(int radix, bool chunked, int T, bool global,
                      const Occupancy** out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(g_mu);
    const auto key = std::make_tuple(dev, radix, chunked, T, global);
    const auto it = g_occupancy.find(key);
    if (it != g_occupancy.end()) {
        *out = &it->second;
        return cudaSuccess;
    }
    Occupancy occ{};
    int max_smem = 0;
    err = device_setup(dev, &max_smem);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return err;
    const void* fn = kernel_for(radix, chunked);
    occ.per_lane = smem_per_lane(radix, T, global);
    for (int w = 1; w <= kMaxWarps; ++w) {
        const size_t smem = occ.per_lane * w;
        if (smem > static_cast<size_t>(max_smem)) break;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.blocks[w], fn,
                                                            32 * w, smem);
        if (err != cudaSuccess) return err;
        if (occ.blocks[w] * w > occ.blocks[occ.best_w] * occ.best_w)
            occ.best_w = w;
    }
    if (occ.best_w == 0) return cudaErrorInvalidConfiguration;
    *out = &(g_occupancy[key] = occ);
    return cudaSuccess;
}

// the block size that keeps the most lanes resident on an SM (fewest warps
// on ties); a batch smaller than the SMs can hold one lane a block is spread
// over them, where one lane's latency sets the time
cudaError_t plan_launch(int radix, bool chunked, int L, int T, bool global,
                        Plan* plan) {
    const Occupancy* occ = nullptr;
    const cudaError_t err = occupancy(radix, chunked, T, global, &occ);
    if (err != cudaSuccess) return err;
    int w = (L + occ->sms - 1) / occ->sms;  // warps a block that fill the SMs once
    if (w > occ->best_w) w = occ->best_w;
    plan->warps = w;
    plan->blocks_per_sm = occ->blocks[w];
    plan->smem = occ->per_lane * w;
    return cudaSuccess;
}

int check_args(int T, int K, int g0, int g1, int radix, const uint8_t* index,
               const uint8_t* spec) {
    if (K < 3 || K > 7) return static_cast<int>(cudaErrorInvalidValue);
    if (radix != 2 && radix != 4) return static_cast<int>(cudaErrorInvalidValue);
    if (radix == 2 && !end_taps(K, g0, g1))
        return static_cast<int>(cudaErrorInvalidValue);
    if (radix == 4 && (T % 4 != 0 || K < 5 || index == nullptr || spec == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    return 0;
}

}  // namespace

// Decodes L lanes of a T-step trellis of the rate-1/2 mother code with
// constraint length K (3..7) and generators g0, g1, in radix 2 (generators
// that tap the first and the last stage, as every code of fec/conv.py
// does) or 4 (T % 4 == 0 and K >= 5, any generators, and the sum table of
// ops/viterbi.py::radix4_sum_table on the device: index (S, 16) and spec
// (256,) bytes). Step t of lane i reads l0[i*ld + t*es] and l1[i*ld + t*es].
// pm0: (L, 2^(K-1)) initial metrics for the chunked mode, or nullptr for the
// terminated mode. bits: (L, T) uint8 decoded bits. dec_scratch: nullptr to
// keep the decisions in shared memory, or a scratch of ceil(T/32) * 256
// bytes a lane for trellises too long for it. Returns a cudaError_t code (0
// on a successful launch).
extern "C" int viterbi_acs_traceback(const float* l0, const float* l1,
                                     long long ld, int es, const float* pm0,
                                     int L, int T, int K, int g0, int g1,
                                     int radix, const uint8_t* r4_index,
                                     const uint8_t* r4_spec, uint8_t* bits,
                                     void* dec_scratch, void* stream) {
    if (L <= 0 || T <= 0) return 0;
    const int bad = check_args(T, K, g0, g1, radix, r4_index, r4_spec);
    if (bad) return bad;
    const bool chunked = pm0 != nullptr;
    Plan plan;
    const cudaError_t err = plan_launch(radix, chunked, L, T,
                                        dec_scratch != nullptr, &plan);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (L + plan.warps - 1) / plan.warps;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (radix == 4) {
        r4_kernel(chunked)<<<grid, plan.warps * 32, plan.smem, st>>>(
            l0, l1, ld, es, pm0, L, T, K, r4_index, r4_spec, bits,
            static_cast<unsigned*>(dec_scratch));
    } else {
        r2_kernel(chunked)<<<grid, plan.warps * 32, plan.smem, st>>>(
            l0, l1, ld, es, pm0, L, T, K, g0, g1, bits,
            static_cast<uint2*>(dec_scratch));
    }
    return static_cast<int>(cudaGetLastError());
}

// The launch viterbi_acs_traceback would make for these arguments: lanes
// (warps) a block, resident blocks an SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor with that block size and shared memory) and the block's
// dynamic shared memory in bytes. Returns a cudaError_t code.
extern "C" int viterbi_launch_plan(int L, int T, int K, int g0, int g1,
                                   int radix, int chunked, int global_scratch,
                                   int* warps, int* blocks_per_sm,
                                   long long* smem) {
    uint8_t dummy = 0;
    const int bad = check_args(T, K, g0, g1, radix, &dummy, &dummy);
    if (bad) return bad;
    Plan plan;
    const cudaError_t err = plan_launch(radix, chunked != 0, L, T,
                                        global_scratch != 0, &plan);
    if (err != cudaSuccess) return static_cast<int>(err);
    *warps = plan.warps;
    *blocks_per_sm = plan.blocks_per_sm;
    *smem = static_cast<long long>(plan.smem);
    return 0;
}
