// Batched LDPC belief-propagation decoder for Hopper (sm_90a).
//
// Replaces orion_sdr_tpu/ops/ldpc_bp.py:256 _ms_kernel_factory (the Pallas
// TPU kernel behind bp_decode_pallas, rules sum_product / min_sum /
// scaled_min_sum) and orion_sdr_tpu/ops/ldpc_bp.py:200 _bp_kernel_factory
// (rule sum_product_edge), with the per-row semantics of the f32 reference
// orion_sdr_tpu/fec/ldpc.py::bp_decode: the same check-node rules
// (sum-product with the fast_tanh/fast_atanh rationals and clip(loo, -1, 1),
// min-sum and scaled min-sum with the argmin/min2 tie rule), a syndrome every
// iteration, the best snapshot replaced only on a strict improvement, and a
// stop at zero unsatisfied checks or at max_iter. The edge rule is the
// log-domain sum-product of _bp_kernel_factory: t clipped to +-0.9999999,
// log(max(|t|, 1e-12)) summed over the check in slot order, the own term
// subtracted, the sign from the other edges' negative-t parity, then
// expf and the clipped fast_atanh. It uses the accurate logf/expf (no fast
// math, no __logf/__expf intrinsics), as torch's log/exp on the card do; the
// TPU kernel's bf16 one-hot contractions become f32 sums.
//
// What bounds it on this card: latency and barriers, not bytes or FLOPs.
// Device memory sees one read of the LLRs and one write of the message bits
// per codeword; everything else lives in shared memory. Each iteration is
// three dependent phases over roughly 1.3k edges (check update, bit totals,
// syndrome + new messages), each ended by a __syncthreads, and the gathers
// through the edge tables are short dependent shared-memory loads.
//
// Design:
//  * one thread block per codeword; threads map to checks in the check
//    phases and to bits in the bit phase;
//  * edge messages (updated in place: message -> extrinsic -> message), the
//    LLRs, the bit totals and the best snapshot stay in shared memory for all
//    iterations (about 10 KB for N512R12), so many blocks are resident per SM
//    and one block's barrier waits are covered by the others' work;
//  * gathers go through the check -> bit table (check_bits/check_mask, m x D)
//    and a bit -> edge CSR list; each bit sums its extrinsics in that fixed
//    CSR order with no float atomics, so results are deterministic;
//  * the syndrome is counted with integer shared-memory atomics;
//  * each row exits on its own, so no batch-wide stall rule is needed;
//  * f32 throughout; the wrapper builds with -fmad=false so every operation
//    rounds as the plain torch version's separate tensor operations do.
// The TPU kernel's one-hot gather matmuls and bf16 contractions have no
// counterpart here: Hopper gathers through shared-memory indices directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSumProduct = 0;
constexpr int kMinSum = 1;  // min_sum (scale 1) and scaled_min_sum (scale alpha)
constexpr int kSumProductEdge = 2;
constexpr float kClipEdge = 0.9999999f;

// jnp.clip(v, -1, 1) semantics, NaN included.
__device__ __forceinline__ float clip1(float v) {
    return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}

// jnp.clip(v, -kClipEdge, kClipEdge) semantics, NaN included.
__device__ __forceinline__ float clip_edge(float v) {
    return v < -kClipEdge ? -kClipEdge : (v > kClipEdge ? kClipEdge : v);
}

__device__ __forceinline__ float fast_tanh(float x) {
    const float x2 = x * x;
    const float a = x * (945.0f + x2 * (105.0f + x2));
    const float b = 945.0f + x2 * (420.0f + x2 * 15.0f);
    return clip1(a / b);
}

__device__ __forceinline__ float fast_atanh(float x) {
    const float x2 = x * x;
    const float a = x * (945.0f + x2 * (-735.0f + x2 * 64.0f));
    const float b = 945.0f + x2 * (-1050.0f + x2 * 225.0f);
    return a / b;
}

// Check-node update of one check's D edge slots, in place: messages in,
// extrinsics out. Slots past D or masked off are left untouched.
template <int RULE, int MAXD>
__device__ __forceinline__ void check_update(float* edge, const uint8_t* mask,
                                             int D, float scale) {
    bool valid[MAXD];
    float v[MAXD];
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
        valid[j] = j < D && mask[j];
        v[j] = valid[j] ? edge[j] : 0.0f;
    }
    if (RULE == kSumProduct) {
        // leave-one-out product by exclusive prefix/suffix products
        float t[MAXD], left[MAXD];
        float acc = 1.0f;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
            t[j] = valid[j] ? fast_tanh(v[j] * 0.5f) : 1.0f;
            left[j] = acc;
            acc = acc * t[j];
        }
        acc = 1.0f;
#pragma unroll
        for (int j = MAXD - 1; j >= 0; --j) {
            const float loo = left[j] * acc;
            acc = acc * t[j];
            if (valid[j]) edge[j] = 2.0f * fast_atanh(clip1(loo));
        }
    } else if (RULE == kSumProductEdge) {
        // log-domain leave-one-out: masked slots hold t = 1, a = log 1 = 0
        float t[MAXD], a[MAXD];
        int n_neg = 0;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
            t[j] = valid[j] ? clip_edge(fast_tanh(v[j] * 0.5f)) : 1.0f;
            const float m = fabsf(t[j]);
            a[j] = logf(m < 1e-12f ? 1e-12f : m);
            n_neg += t[j] < 0.0f;
        }
        float total = a[0];
#pragma unroll
        for (int j = 1; j < MAXD; ++j) total = total + a[j];
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
            if (valid[j]) {
                const int others = n_neg - (t[j] < 0.0f ? 1 : 0);
                const float sign = (others & 1) ? -1.0f : 1.0f;
                edge[j] = 2.0f * fast_atanh(clip_edge(sign * expf(total - a[j])));
            }
        }
    } else {
        float a[MAXD], s[MAXD];
        float sign_par = 1.0f;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
            a[j] = valid[j] ? fabsf(v[j]) : INFINITY;
            s[j] = (valid[j] && v[j] < 0.0f) ? -1.0f : 1.0f;
            sign_par *= s[j];
        }
        // first minimum (argmin) and the minimum over the other slots
        float min1 = INFINITY;
        int am = 0;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
            if (a[j] < min1) { min1 = a[j]; am = j; }
        }
        float min2 = INFINITY;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
            if (j != am) min2 = fminf(min2, a[j]);
        }
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
            if (valid[j])
                edge[j] = (scale * (sign_par * s[j])) * (j == am ? min2 : min1);
        }
    }
}

template <int RULE, int MAXD>
__global__ void __launch_bounds__(512) ldpc_bp_kernel(
    const float* __restrict__ llr, int n, int k, int m, int D,
    const int* __restrict__ check_bits, const uint8_t* __restrict__ check_mask,
    const int* __restrict__ bit_ptr, const int* __restrict__ bit_edges,
    int max_iter, float scale, uint8_t* __restrict__ bits_out,
    int* __restrict__ unsat_out) {
    extern __shared__ float smem[];
    float* s_llr = smem;                               // n
    float* s_tot = s_llr + n;                          // n
    float* s_edge = s_tot + n;                         // m * D
    int* s_cnt = reinterpret_cast<int*>(s_edge + m * D);   // 2 (alternating)
    uint8_t* s_best = reinterpret_cast<uint8_t*>(s_cnt + 2);  // n

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const float* x = llr + static_cast<size_t>(blockIdx.x) * n;

    if (tid < 2) s_cnt[tid] = 0;
    for (int b = tid; b < n; b += nt) {
        const float v = x[b];
        s_llr[b] = v;
        s_tot[b] = v;
        s_best[b] = v <= 0.0f;
    }
    __syncthreads();

    // initial messages = channel LLRs; syndrome of the hard decisions
    int local = 0;
    for (int c = tid; c < m; c += nt) {
        int par = 0;
        for (int j = 0; j < D; ++j) {
            const int e = c * D + j;
            if (check_mask[e]) {
                const float v = s_llr[check_bits[e]];
                s_edge[e] = v;
                par ^= (v <= 0.0f);
            }
        }
        local += par;
    }
    if (local) atomicAdd(&s_cnt[0], local);
    __syncthreads();
    int min_unsat = s_cnt[0];

    for (int it = 0; it < max_iter && min_unsat > 0; ++it) {
        // counter of this iteration; its last reader finished two barriers ago
        const int cur = (it + 1) & 1;
        if (tid == 0) s_cnt[cur] = 0;

        // A: check update, messages -> extrinsics in place
        for (int c = tid; c < m; c += nt)
            check_update<RULE, MAXD>(s_edge + c * D, check_mask + c * D, D,
                                     scale);
        __syncthreads();

        // B: bit totals, extrinsics summed in fixed CSR order
        for (int b = tid; b < n; b += nt) {
            float s = 0.0f;
            const int p1 = bit_ptr[b + 1];
            for (int p = bit_ptr[b]; p < p1; ++p) s += s_edge[bit_edges[p]];
            s_tot[b] = s_llr[b] + s;
        }
        __syncthreads();

        // C: syndrome of the new hard decisions; extrinsics -> messages
        local = 0;
        for (int c = tid; c < m; c += nt) {
            int par = 0;
            for (int j = 0; j < D; ++j) {
                const int e = c * D + j;
                if (check_mask[e]) {
                    const float t = s_tot[check_bits[e]];
                    par ^= (t <= 0.0f);
                    s_edge[e] = t - s_edge[e];
                }
            }
            local += par;
        }
        if (local) atomicAdd(&s_cnt[cur], local);
        __syncthreads();

        // D: keep the snapshot on a strict improvement (same thread <-> bit
        // mapping as phase B, so no barrier is needed before the next B)
        const int unsat = s_cnt[cur];
        if (unsat < min_unsat) {
            min_unsat = unsat;
            for (int b = tid; b < n; b += nt) s_best[b] = s_tot[b] <= 0.0f;
        }
    }
    __syncthreads();

    uint8_t* out = bits_out + static_cast<size_t>(blockIdx.x) * k;
    for (int b = tid; b < k; b += nt) out[b] = s_best[b];
    if (tid == 0) unsat_out[blockIdx.x] = min_unsat;
}

typedef void (*KernelFn)(const float*, int, int, int, int, const int*,
                         const uint8_t*, const int*, const int*, int, float,
                         uint8_t*, int*);

template <int RULE>
KernelFn pick_width(int D) {
    if (D <= 8) return ldpc_bp_kernel<RULE, 8>;
    if (D <= 16) return ldpc_bp_kernel<RULE, 16>;
    return ldpc_bp_kernel<RULE, 32>;
}

}  // namespace

// Decodes `batch` codewords of llr (batch, n) float32. Writes the first k
// bits of each row's best snapshot to bits_out (batch, k) uint8 and its
// unsatisfied-check count to unsat_out (batch,) int32. rule: 0 sum-product,
// 1 min-sum with extrinsics scaled by `scale`, 2 edge-layout (log-domain)
// sum-product. Returns a cudaError_t code (0 on a successful launch).
extern "C" int ldpc_bp_decode(const float* llr, int batch, int n, int k, int m,
                              int D, const int* check_bits,
                              const uint8_t* check_mask, const int* bit_ptr,
                              const int* bit_edges, int max_iter, int rule,
                              float scale, uint8_t* bits_out, int* unsat_out,
                              void* stream) {
    if (batch <= 0) return 0;
    if (D < 1 || D > 32 || k > n ||
        (rule != kSumProduct && rule != kMinSum && rule != kSumProductEdge))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = (2 * static_cast<size_t>(n) + static_cast<size_t>(m) * D)
                            * sizeof(float) + 2 * sizeof(int) + n;
    KernelFn fn = rule == kSumProduct ? pick_width<kSumProduct>(D)
                  : rule == kMinSum   ? pick_width<kMinSum>(D)
                                      : pick_width<kSumProductEdge>(D);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    int threads = (n + 1) / 2 > m ? (n + 1) / 2 : m;
    threads = (threads + 31) / 32 * 32;
    threads = threads < 64 ? 64 : (threads > 512 ? 512 : threads);
    fn<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        llr, n, k, m, D, check_bits, check_mask, bit_ptr, bit_edges, max_iter,
        scale, bits_out, unsat_out);
    return static_cast<int>(cudaGetLastError());
}
