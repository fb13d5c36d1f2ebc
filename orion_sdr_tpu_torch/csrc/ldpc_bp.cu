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
// TPU kernel's bf16 one-hot contractions become f32 sums. Tensor cores do
// not apply: the TPU's one-hot SB/MC matmuls were its way to gather, and
// Hopper gathers through shared-memory indices directly.
//
// What bounds it on this card: latency, not bytes or FLOPs. Device memory
// sees one read of each LLR row and one write of its message bits; all else
// lives in shared memory. A codeword's iterations are a dependent chain of
// phases over its edges (1 279 for N512R12), each phase a few dependent
// shared-memory gathers and a check update of two IEEE divisions an edge,
// ended by a barrier. Rows of a real batch arrive as codewords on a clean
// link and stop after a few iterations near the code's threshold, so the
// per-row fixed cost weighs as much as an iteration. The design therefore
// cuts barriers and per-row cost, and keeps codewords in flight on every
// SM. What it gives up: a block decodes its rows in turn, so a batch whose
// every row iterates has fewer rows in flight (5 blocks an SM for N512R12)
// than a block a row would have, and runs its bulk iterations slower:
//  * persistent blocks: the grid is the resident block count from
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor (ldpc_bp_launch_plan);
//    each block stages the graph's tables into shared memory once, then
//    decodes rows blockIdx.x, blockIdx.x + grid, ... in turn. Rows never
//    interact, so no output depends on which block took a row;
//  * while a block decodes one row, the next two rows' LLRs stream into
//    shared buffers: one cp.async.bulk on an mbarrier where the row is
//    16-byte aligned (n a multiple of 4), 4-byte cp.async otherwise;
//  * compact tables built on the host (ops/ldpc_bp.py::graph_tables):
//    check -> bit as uint16 with a NO_BIT mark on a short check's padded
//    slots (no mask array), bit -> edge as a fixed-width uint16 table in the
//    plain version's order, its padding pointing at an edge slot that
//    holds 0.0;
//  * slot-major edge state: edge (c, j) at j*m + c, so the 32 checks of a
//    warp read 32 consecutive words at every slot, for any D;
//  * the check update is instantiated at the exact degree D of the repo's
//    codes (5, 8, 11), of FT8/FT4's LDPC(174, 91) graph (7: its checks hold
//    6 or 7 bits) and of the staircase (174, 91) test graph (6), so only
//    real slots are computed; any other D takes a padded width of 8, 16 or
//    32;
//  * a row starts with the channel's syndrome alone, so a row that arrives
//    as a codeword costs one barrier and no check update;
//  * one fused check phase reads each check's D totals once: their hard
//    decisions give the syndrome, total - old extrinsic is the message, and
//    the check update writes the new extrinsic in place. Then a barrier; the
//    syndrome, snapshot and exit decision; the bit phase; a barrier: two
//    barriers an iteration. The first pass reads the LLRs with no old
//    extrinsic (v - 0 = v); the update of the pass whose syndrome ends the
//    row is computed and thrown away;
//  * a syndrome is counted by the phase's barrier itself: a
//    __syncthreads_count of the threads' odd checks (one count where a
//    thread has one check, as for every code of the repo), with no shared
//    atomics or counters;
//  * each bit sums its extrinsics in the plain version's fixed order with no
//    float atomics, and the wrapper builds with -fmad=false, so every float
//    operation rounds as the plain torch version's separate tensor
//    operations do: kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSumProduct = 0;
constexpr int kMinSum = 1;  // min_sum (scale 1) and scaled_min_sum (scale alpha)
constexpr int kSumProductEdge = 2;
constexpr float kClipEdge = 0.9999999f;
constexpr uint16_t kNoBit = 0xFFFF;
// A block is one check a thread up to kMaxThreads; kMinBlocks of the
// largest blocks share an SM, which caps a thread at 64 registers
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;
// LLR row buffers: the row being decoded and the next kBufs - 1, in flight
constexpr int kBufs = 3;

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

// Check-node update of one check's W slots: messages v (0 on invalid slots)
// in, extrinsics out; out[j] is meaningful on valid slots only.
template <int RULE, int W>
__device__ __forceinline__ void check_update(const float (&v)[W],
                                             const bool (&valid)[W],
                                             float scale, float (&out)[W]) {
    if (RULE == kSumProduct) {
        // leave-one-out product by exclusive prefix/suffix products
        float t[W], left[W];
        float acc = 1.0f;
#pragma unroll
        for (int j = 0; j < W; ++j) {
            t[j] = valid[j] ? fast_tanh(v[j] * 0.5f) : 1.0f;
            left[j] = acc;
            acc = acc * t[j];
        }
        acc = 1.0f;
#pragma unroll
        for (int j = W - 1; j >= 0; --j) {
            const float loo = left[j] * acc;
            acc = acc * t[j];
            out[j] = 2.0f * fast_atanh(clip1(loo));
        }
    } else if (RULE == kSumProductEdge) {
        // log-domain leave-one-out: invalid slots hold t = 1, a = log 1 = 0
        float t[W], a[W];
        int n_neg = 0;
#pragma unroll
        for (int j = 0; j < W; ++j) {
            t[j] = valid[j] ? clip_edge(fast_tanh(v[j] * 0.5f)) : 1.0f;
            const float m = fabsf(t[j]);
            a[j] = logf(m < 1e-12f ? 1e-12f : m);
            n_neg += t[j] < 0.0f;
        }
        float total = a[0];
#pragma unroll
        for (int j = 1; j < W; ++j) total = total + a[j];
#pragma unroll
        for (int j = 0; j < W; ++j) {
            const int others = n_neg - (t[j] < 0.0f ? 1 : 0);
            const float sign = (others & 1) ? -1.0f : 1.0f;
            out[j] = 2.0f * fast_atanh(clip_edge(sign * expf(total - a[j])));
        }
    } else {
        float a[W], s[W];
        float sign_par = 1.0f;
#pragma unroll
        for (int j = 0; j < W; ++j) {
            a[j] = valid[j] ? fabsf(v[j]) : INFINITY;
            s[j] = (valid[j] && v[j] < 0.0f) ? -1.0f : 1.0f;
            sign_par *= s[j];
        }
        // first minimum (argmin) and the minimum over the other slots
        float min1 = INFINITY;
        int am = 0;
#pragma unroll
        for (int j = 0; j < W; ++j) {
            if (a[j] < min1) { min1 = a[j]; am = j; }
        }
        float min2 = INFINITY;
#pragma unroll
        for (int j = 0; j < W; ++j) {
            if (j != am) min2 = fminf(min2, a[j]);
        }
#pragma unroll
        for (int j = 0; j < W; ++j)
            out[j] = (scale * (sign_par * s[j])) * (j == am ? min2 : min1);
    }
}

// ── asynchronous row copies ──────────────────────────────────────────────────

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n\t"
            ".reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t"
            "}"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    }
}

// Starts the copy of one LLR row (n floats) into shared memory, if `any`:
// one bulk copy by thread 0, completing on `bar`, or one 4-byte cp.async a
// float by every thread, committed as a group (an empty group if not `any`,
// so that each row has one group).
__device__ __forceinline__ void load_row(float* dst, const float* src, int n,
                                         bool bulk, uint64_t* bar, bool any) {
    if (bulk) {
        // the buffer was last read by the generic proxy before a barrier,
        // and no proxy fence is needed between those reads and this write
        if (any && threadIdx.x == 0) {
            const uint32_t bytes = static_cast<uint32_t>(n) * 4u;
            uint64_t state;
            asm volatile(
                "mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
                : "=l"(state)
                : "r"(smem_addr(bar)), "r"(bytes)
                : "memory");
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
                "bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
                "l"(src), "r"(bytes), "r"(smem_addr(bar))
                : "memory");
        }
    } else {
        if (any)
            for (int b = threadIdx.x; b < n; b += blockDim.x)
                asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                                 smem_addr(dst + b)),
                             "l"(src + b)
                             : "memory");
        asm volatile("cp.async.commit_group;" ::: "memory");
    }
}

// ── shared-memory layout ─────────────────────────────────────────────────────

struct Layout {
    size_t llr, tot, ext, cb, b2e, best, bytes;
};

// [kBufs mbarriers | kBufs LLR rows | totals | edge
//  extrinsics + the zero slot | check -> bit | bit -> edge | snapshot]
__host__ __device__ inline Layout layout(int n, int m, int D, int C) {
    Layout L;
    const size_t n_pad = (static_cast<size_t>(n) + 3) / 4 * 4;
    const size_t E = static_cast<size_t>(m) * D;
    size_t o = (kBufs * 8 + 15) / 16 * 16;
    L.llr = o;  o += kBufs * n_pad * 4;
    L.tot = o;  o += static_cast<size_t>(n) * 4;
    L.ext = o;  o += (E + 1) * 4;
    o = (o + 15) / 16 * 16;
    L.cb = o;   o += (E * 2 + 15) / 16 * 16;
    L.b2e = o;  o += (static_cast<size_t>(C) * n * 2 + 15) / 16 * 16;
    L.best = o; o += n;
    L.bytes = (o + 15) / 16 * 16;
    return L;
}

// ── the kernel ───────────────────────────────────────────────────────────────

// Copies `len` uint16 from device memory (16-byte aligned) to shared memory
// (16-byte aligned): 16 bytes a load, so each thread has one or two loads in
// flight rather than a chain of 2-byte ones.
__device__ __forceinline__ void stage(uint16_t* dst,
                                      const uint16_t* __restrict__ src,
                                      int len) {
    const int vec = len / 8;
    for (int i = threadIdx.x; i < vec; i += blockDim.x)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(src)[i];
    for (int i = vec * 8 + threadIdx.x; i < len; i += blockDim.x)
        dst[i] = src[i];
}

// The block's count of odd checks, given each thread's count `odd` (at
// most `rounds`, the thread's number of checks): one __syncthreads_count a
// bit of `rounds`, one for the repo's codes, which is also the barrier that
// ends the phase. The empty asm statements keep the compiler from moving
// shared-memory accesses across the count; the barrier orders them on the
// card.
__device__ __forceinline__ int block_count(int odd, int rounds) {
    int total = 0;
    for (int bit = 0; (rounds >> bit) != 0; ++bit) {
        asm volatile("" ::: "memory");
        total += __syncthreads_count((odd >> bit) & 1) << bit;
        asm volatile("" ::: "memory");
    }
    return total;
}

// W: the check update's width; EXACT: W is the graph's D, so every slot but a
// short check's padded ones is real.
template <int RULE, int W, bool EXACT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) ldpc_bp_kernel(
    const float* __restrict__ llr, int batch, int n, int k, int m, int D,
    int C, const uint16_t* __restrict__ check_slots,
    const uint16_t* __restrict__ bit_slots, int max_iter, float scale,
    int bulk, uint8_t* __restrict__ bits_out, int* __restrict__ unsat_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L = layout(n, m, D, C);
    uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem);        // kBufs
    float* s_llr = reinterpret_cast<float*>(smem + L.llr);      // kBufs x n_pad
    float* s_tot = reinterpret_cast<float*>(smem + L.tot);      // n
    float* s_ext = reinterpret_cast<float*>(smem + L.ext);      // m*D + 1
    uint16_t* s_cb = reinterpret_cast<uint16_t*>(smem + L.cb);  // D x m
    uint16_t* s_b2e = reinterpret_cast<uint16_t*>(smem + L.b2e);  // C x n
    uint8_t* s_best = smem + L.best;                            // n

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int grid = gridDim.x;
    const int Dk = EXACT ? W : D;
    const int E = m * Dk;
    const int n_pad = (n + 3) / 4 * 4;
    const int rounds = (m + nt - 1) / nt;   // checks a thread, at most

    // the block's rows are blockIdx.x + i * grid; row i's LLRs go to buffer
    // i % kBufs, copied while rows i - kBufs + 1 .. i - 1 decode
    if (tid == 0 && bulk) {
        for (int b = 0; b < kBufs; ++b) mbar_init(&s_bar[b]);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    for (int i = 0; i < kBufs - 1; ++i) {
        const int row = blockIdx.x + i * grid;
        load_row(s_llr + i * n_pad, llr + static_cast<size_t>(row) * n, n,
                 bulk, &s_bar[i], row < batch);
    }
    stage(s_cb, check_slots, E);
    stage(s_b2e, bit_slots, C * n);
    if (tid == 0) s_ext[E] = 0.0f;
    __syncthreads();

    uint32_t phase = 0;   // bit b: the parity to wait for on buffer b
    int buf = 0;
    for (int row = blockIdx.x; row < batch; row += grid) {
        if (bulk) {
            mbar_wait(&s_bar[buf], (phase >> buf) & 1u);
            phase ^= 1u << buf;
        } else {
            asm volatile("cp.async.wait_group %0;" ::"n"(kBufs - 2)
                         : "memory");
            __syncthreads();   // every thread's 4-byte copies in
        }
        const float* x = s_llr + buf * n_pad;

        // the channel's syndrome alone first: a row that arrives as a
        // codeword (or max_iter 0) needs no check update
        int odd = 0;
        for (int c = tid; c < m; c += nt) {
            int par = 0;
#pragma unroll
            for (int j = 0; j < W; ++j) {
                const uint16_t b =
                    (EXACT || j < Dk) ? s_cb[j * m + c] : kNoBit;
                par ^= static_cast<int>(b != kNoBit && x[b] <= 0.0f);
            }
            odd += par;
        }
        int min_unsat = block_count(odd, rounds);
        {
            // past that barrier every thread is done with the last row, whose
            // buffer takes the row kBufs - 1 ahead
            const int fb = buf == 0 ? kBufs - 1 : buf - 1;
            const int nxt = row + (kBufs - 1) * grid;
            load_row(s_llr + fb * n_pad, llr + static_cast<size_t>(nxt) * n,
                     n, bulk, &s_bar[fb], nxt < batch);
        }

        uint8_t* out = bits_out + static_cast<size_t>(row) * k;
        if (min_unsat == 0 || max_iter <= 0) {
            if ((k & 3) == 0) {   // four bits a store
                for (int w = tid; w < k / 4; w += nt) {
                    const float4 v = reinterpret_cast<const float4*>(x)[w];
                    reinterpret_cast<uint32_t*>(out)[w] =
                        static_cast<uint32_t>(v.x <= 0.0f) |
                        static_cast<uint32_t>(v.y <= 0.0f) << 8 |
                        static_cast<uint32_t>(v.z <= 0.0f) << 16 |
                        static_cast<uint32_t>(v.w <= 0.0f) << 24;
                }
            } else {
                for (int b = tid; b < k; b += nt) out[b] = x[b] <= 0.0f;
            }
        } else {
            // each thread owns bits tid, tid + nt, ... in the snapshot, the
            // bit phase and the output, so those need no barrier between them
            for (int b = tid; b < n; b += nt) s_best[b] = x[b] <= 0.0f;
            for (int pass = 0;; ++pass) {
                // fused check phase: totals (the LLRs on the first pass)
                // read once for the syndrome, the messages and the update
                const float* src = pass == 0 ? x : s_tot;
                odd = 0;
                for (int c = tid; c < m; c += nt) {
                    float v[W], upd[W];
                    bool valid[W];
                    int par = 0;
#pragma unroll
                    for (int j = 0; j < W; ++j) {
                        const int e = j * m + c;
                        const uint16_t b =
                            (EXACT || j < Dk) ? s_cb[e] : kNoBit;
                        valid[j] = b != kNoBit;
                        const float t = valid[j] ? src[b] : 0.0f;
                        par ^= static_cast<int>(valid[j] && t <= 0.0f);
                        v[j] = (valid[j] && pass > 0) ? t - s_ext[e] : t;
                    }
                    odd += par;
                    // after the last pass only the syndrome counts
                    if (pass == max_iter) continue;
                    check_update<RULE, W>(v, valid, scale, upd);
#pragma unroll
                    for (int j = 0; j < W; ++j)
                        if (valid[j]) s_ext[j * m + c] = upd[j];
                }
                const int unsat = block_count(odd, rounds);

                // syndrome (pass 0's is the channel's, already taken),
                // snapshot and exit
                if (pass > 0 && unsat < min_unsat) {
                    min_unsat = unsat;
                    for (int b = tid; b < n; b += nt)
                        s_best[b] = s_tot[b] <= 0.0f;
                }
                if (min_unsat == 0 || pass == max_iter) break;

                // bit phase: extrinsics summed in the plain version's order
                for (int b = tid; b < n; b += nt) {
                    float s = s_ext[s_b2e[b]];
                    for (int i = 1; i < C; ++i)
                        s = s + s_ext[s_b2e[i * n + b]];
                    s_tot[b] = x[b] + s;
                }
                __syncthreads();
            }
            for (int b = tid; b < k; b += nt) out[b] = s_best[b];
        }
        if (tid == 0) unsat_out[row] = min_unsat;
        buf = buf == kBufs - 1 ? 0 : buf + 1;
    }
}

typedef void (*KernelFn)(const float*, int, int, int, int, int, int,
                         const uint16_t*, const uint16_t*, int, float, int,
                         uint8_t*, int*);

template <int RULE>
KernelFn pick_width(int D) {
    switch (D) {
        case 5: return ldpc_bp_kernel<RULE, 5, true>;
        case 6: return ldpc_bp_kernel<RULE, 6, true>;
        case 7: return ldpc_bp_kernel<RULE, 7, true>;
        case 8: return ldpc_bp_kernel<RULE, 8, true>;
        case 11: return ldpc_bp_kernel<RULE, 11, true>;
        default: break;
    }
    if (D <= 8) return ldpc_bp_kernel<RULE, 8, false>;
    if (D <= 16) return ldpc_bp_kernel<RULE, 16, false>;
    return ldpc_bp_kernel<RULE, 32, false>;
}

KernelFn pick(int rule, int D) {
    return rule == kSumProduct ? pick_width<kSumProduct>(D)
           : rule == kMinSum   ? pick_width<kMinSum>(D)
                               : pick_width<kSumProductEdge>(D);
}

bool valid_args(int n, int m, int D, int C, int rule) {
    return n >= 1 && n <= kNoBit && m >= 1 && D >= 1 && D <= 32 && C >= 1 &&
           static_cast<long long>(m) * D < kNoBit &&
           (rule == kSumProduct || rule == kMinSum || rule == kSumProductEdge);
}

// One check a thread up to kMaxThreads checks, at least two warps.
int block_threads(int m) {
    int t = (m + 31) / 32 * 32;
    return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

// The launch ldpc_bp_decode makes for this graph and rule: threads a block,
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor with
// that block size and shared memory) and the block's dynamic shared memory
// in bytes. Sets the kernel's shared-memory limit when it needs more than
// 48 KB. Returns a cudaError_t code.
extern "C" int ldpc_bp_launch_plan(int n, int m, int D, int C, int rule,
                                   int* threads, int* blocks_per_sm,
                                   long long* smem) {
    if (!valid_args(n, m, D, C, rule))
        return static_cast<int>(cudaErrorInvalidValue);
    const KernelFn fn = pick(rule, D);
    const size_t bytes = layout(n, m, D, C).bytes;
    if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    *threads = block_threads(m);
    *smem = static_cast<long long>(bytes);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fn, *threads, bytes));
}

// Decodes `batch` codewords of llr (batch, n) float32 on `grid` persistent
// blocks of `threads` threads and `smem` bytes (ldpc_bp_launch_plan's, on
// the same device). check_slots (D x m) and bit_slots (C x n) are
// graph_tables' uint16 tables, 16-byte aligned. Writes the first k bits of
// each row's best snapshot to bits_out (batch, k) uint8 (k is the store
// width: the message's bits on the decode path, or n for the whole snapshot,
// the plane ops.bp_decode_pallas returns) and its unsatisfied-check count to unsat_out (batch,) int32. rule: 0 sum-product, 1 min-sum with extrinsics
// scaled by `scale`, 2 edge-layout (log-domain) sum-product. Returns a
// cudaError_t code (0 on a successful launch).
extern "C" int ldpc_bp_decode(const float* llr, int batch, int n, int k, int m,
                              int D, int C, const uint16_t* check_slots,
                              const uint16_t* bit_slots, int max_iter,
                              int rule, float scale, int grid, int threads,
                              long long smem, uint8_t* bits_out,
                              int* unsat_out, void* stream) {
    if (batch <= 0) return 0;
    if (!valid_args(n, m, D, C, rule) || k > n || grid < 1 || grid > batch ||
        threads != block_threads(m) ||
        reinterpret_cast<uintptr_t>(check_slots) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(bit_slots) % 16 != 0 ||
        smem != static_cast<long long>(layout(n, m, D, C).bytes))
        return static_cast<int>(cudaErrorInvalidValue);
    const int bulk = n % 4 == 0 && reinterpret_cast<uintptr_t>(llr) % 16 == 0;
    pick(rule, D)<<<grid, threads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
        llr, batch, n, k, m, D, C, check_slots, bit_slots, max_iter, scale,
        bulk, bits_out, unsat_out);
    return static_cast<int>(cudaGetLastError());
}
