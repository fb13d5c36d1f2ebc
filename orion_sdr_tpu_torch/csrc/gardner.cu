// Gardner symbol-timing loop for Hopper (sm_90a): fractional-delay symbol
// sampling driven by the mid-symbol error, one block a row (a burst or a
// channel), the row staged through a ring of chunks in shared memory.
//
// No Pallas kernel of the JAX package computes this: it replaces the
// lax.scan of orion_sdr_tpu/demodulate/digital.py:127-161 (_gardner_kernel).
// Over unit-RMS samples z of a row (the wrapper normalises each row with a
// torch reduction before the launch, which the plain version shares), each
// output symbol k:
//     interp(p): i = clip(floor(p), 0, n-2), t = p - i,
//                z[i]·(1 - t) + z[i+1]·t      (extrapolates at the edges)
//     y  = interp(pos);  m = interp(pos - rate/2)
//     e  = clip(-Re[(y - prev)·conj(m)], -1, 1)
//     rate ← clip(rate + ki·e, lo, hi);  pos ← (pos + rate) + kp·e
//     out_k = y;  prev = y
// pos is float32, as in the reference. The plain torch version is
// ops/gardner.py::gardner_reference, which writes the same real operations
// in the same order: every product and sum rounds apart here (-fmad=false,
// __fmul_rn/__fadd_rn), so the two agree bit for bit.
//
// What bounds it on this card: the latency of the per-row chain, in which
// each step's position picks the samples the next step reads, not bytes (a
// row's samples are read about once, its symbols written once) or
// operations. Read straight from device memory, each step waits out a
// load whose address the step before computed (rows of 2^17 samples x 64
// hold 64 MB, more than the 50 MB L2). The design takes device memory off
// the chain:
//   - one block a row, three warps. Lane 0 of warp 0 runs the recurrence
//     and reads every sample from a ring of kDepth chunks of kChunk samples
//     in shared memory. The window a step reads, [floor(pos - hi/2),
//     floor(pos) + 1] clamped to [0, n - 1], slides forward by about sps
//     samples a step whenever kp < 0.95·sps (rate >= 0.95·sps and
//     |kp·e| <= kp), so the chunks are needed in order;
//   - warp 1 loads chunk c + kDepth into the ring as soon as the chain has
//     left chunk c: 8-byte cp.async a lane (a row may start at any 8-byte
//     address, so no bulk copy), completing on the chunk's "full" mbarrier
//     (cp.async.mbarrier.arrive.noinc, 32 arrivals); the chain frees a
//     chunk on its "empty" mbarrier. It waits on a barrier only when a
//     step first reaches a chunk or leaves one (once in kChunk / sps steps),
//     and warp 1's polling never shares the chain's warp;
//   - the symbols go to a ring of kOutDepth output chunks in shared
//     memory; warp 2 writes each chunk back to device memory, coalesced,
//     and frees it on its own barrier;
//   - the chain's loop holds nothing but the step: the output barriers
//     run once an output chunk, and the loop's constants (the gains, the
//     rate's clip, the ring's shared address) sit in registers, not
//     reloaded from the constant bank or rebuilt each step;
//   - a step whose reads do not all lie in the chunks the chain holds (pos
//     stepping back when kp >= 0.95·sps, or jumping more than the ring
//     ahead) reads those samples from device memory with the same
//     arithmetic, and counts one window miss (misses, one int32 a row).
// The ring model of tests/test_torch_gardner_schedule.py replays this
// schedule (the same kChunk, kDepth, acquire and release rules) beside
// the plain version.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLogChunk = 9;
constexpr int kChunk = 1 << kLogChunk;    // samples a chunk (4 KB)
constexpr int kDepth = 4;                 // chunks in the ring
constexpr int kRingMask = kChunk * kDepth - 1;
constexpr int kOutChunk = 256;            // symbols an output chunk (2 KB)
constexpr int kOutDepth = 2;              // output chunks in their ring
constexpr int kThreads = 96;              // chain, loader, writer warps

struct Smem {
    float2 ring[kChunk * kDepth];
    float2 out[kOutChunk * kOutDepth];
    uint64_t full[kDepth], empty[kDepth];
    uint64_t out_full[kOutDepth], out_empty[kOutDepth];
    int stop;
    float consts[4];          // kp, ki, lo, hi for the chain's registers
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_done(uint64_t* bar, uint32_t parity) {
    uint32_t ok;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    while (!mbar_done(bar, parity)) {
    }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// x in a register that stays live through the chain's loop, where the
// compiler would otherwise rebuild it (the shared window's base: S2R)
__device__ __forceinline__ uint32_t pinned(uint32_t x) {
    uint32_t y;
    asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
    return y;
}

// Sample i of the ring (its slot: i masked by the ring's length), from the
// ring's shared-memory address
__device__ __forceinline__ float2 ring_at(uint32_t ring, int i) {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v.x), "=f"(v.y)
                 : "r"(ring + (static_cast<uint32_t>(i & kRingMask) << 3)));
    return v;
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
    // NaN passes through, as jnp.clip and torch.clamp let it
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int clip_index(float p, int last) {
    // floor to int32 (saturating), clipped to [0, last]
    const int i = static_cast<int>(floorf(p));
    return i < 0 ? 0 : (i > last ? last : i);
}

__device__ __forceinline__ float2 lerp(float2 a, float2 b, float p, int i) {
    const float t = __fsub_rn(p, static_cast<float>(i));
    const float w = __fsub_rn(1.f, t);
    return make_float2(__fadd_rn(__fmul_rn(a.x, w), __fmul_rn(b.x, t)),
                       __fadd_rn(__fmul_rn(a.y, w), __fmul_rn(b.y, t)));
}

// Warp 1: chunk c of the row into ring slot c % kDepth once the chain has
// freed the chunk kDepth before it; stops when the chain is done.
__device__ void load_row(Smem& s, const float2* zr, int n) {
    const int lane = threadIdx.x & 31;
    const int n_chunks = (n + kChunk - 1) >> kLogChunk;
    int c = 0;
    for (; c < n_chunks; ++c) {
        const int slot = c & (kDepth - 1);
        if (c >= kDepth) {
            int go = 1;
            if (lane == 0) {
                const uint32_t par = static_cast<uint32_t>((c / kDepth - 1) & 1);
                while (!mbar_done(&s.empty[slot], par)) {
                    if (*static_cast<volatile int*>(&s.stop)) {
                        go = 0;
                        break;
                    }
                }
            }
            if (!__shfl_sync(0xffffffffu, go, 0)) break;
        }
        const int base = c << kLogChunk;
        const int m = n - base < kChunk ? n - base : kChunk;
        float2* dst = s.ring + slot * kChunk;
        for (int j = lane; j < m; j += 32)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                         :: "r"(smem_u32(dst + j)), "l"(zr + base + j)
                         : "memory");
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(smem_u32(&s.full[slot])) : "memory");
    }
    // no copy or arrival may land after the block has exited
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (lane == 0)
        for (int d = c - kDepth < 0 ? 0 : c - kDepth; d < c; ++d)
            mbar_wait(&s.full[d & (kDepth - 1)],
                      static_cast<uint32_t>((d / kDepth) & 1));
}

// Warp 2: each output chunk back to device memory as the chain fills it.
__device__ void store_row(Smem& s, float2* orow, int64_t n_out) {
    const int lane = threadIdx.x & 31;
    const int64_t n_oc = (n_out + kOutChunk - 1) / kOutChunk;
    for (int64_t j = 0; j < n_oc; ++j) {
        const int slot = static_cast<int>(j & (kOutDepth - 1));
        mbar_wait(&s.out_full[slot],
                  static_cast<uint32_t>((j / kOutDepth) & 1));
        const int64_t k0 = j * kOutChunk;
        const int m = static_cast<int>(n_out - k0 < kOutChunk ? n_out - k0
                                                              : kOutChunk);
        const float2* src = s.out + slot * kOutChunk;
        for (int i = lane; i < m; i += 32) orow[k0 + i] = src[i];
        mbar_arrive(&s.out_empty[slot]);
    }
}

// The chain's hold on the ring: chunks [lo, hi) are loaded and not freed.
struct Hold {
    int lo, hi;
};

// Frees every chunk below the step's lowest read (taking, then freeing,
// any not yet taken) and takes the chunks up to its highest read while the
// ring has room for them.
__device__ __forceinline__ void advance(Smem& s, Hold& h, int low_c,
                                        int top_c, int n_chunks) {
    while (h.lo < low_c) {
        if (h.lo == h.hi) {
            mbar_wait(&s.full[h.hi & (kDepth - 1)],
                      static_cast<uint32_t>((h.hi / kDepth) & 1));
            ++h.hi;
        }
        mbar_arrive(&s.empty[h.lo & (kDepth - 1)]);
        ++h.lo;
    }
    while (h.hi <= top_c && h.hi < h.lo + kDepth && h.hi < n_chunks) {
        mbar_wait(&s.full[h.hi & (kDepth - 1)],
                  static_cast<uint32_t>((h.hi / kDepth) & 1));
        ++h.hi;
    }
}

__device__ __forceinline__ float2 read(uint32_t ring, const float2* zr,
                                       int i, int r_lo, int r_hi) {
    return (i >= r_lo && i < r_hi) ? ring_at(ring, i) : __ldg(zr + i);
}

__global__ void __launch_bounds__(kThreads)
gardner_kernel(const float2* __restrict__ z, int n, int64_t n_out,
               float pos0, float rate0, float kp, float ki, float lo,
               float hi, float2* __restrict__ out,
               float* __restrict__ pos_out, int* __restrict__ misses) {
    __shared__ __align__(16) Smem s;
    const int64_t r = blockIdx.x;
    const float2* zr = z + r * n;
    const int warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) {
        for (int d = 0; d < kDepth; ++d) {
            mbar_init(&s.full[d], 32);
            mbar_init(&s.empty[d], 1);
        }
        for (int d = 0; d < kOutDepth; ++d) {
            mbar_init(&s.out_full[d], 1);
            mbar_init(&s.out_empty[d], 32);
        }
        s.stop = 0;
        s.consts[0] = kp;
        s.consts[1] = ki;
        s.consts[2] = lo;
        s.consts[3] = hi;
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == 1) {
        load_row(s, zr, n);
        return;
    }
    if (warp == 2) {
        store_row(s, out + r * n_out, n_out);
        return;
    }
    if (threadIdx.x != 0) return;
    const int n_chunks = (n + kChunk - 1) >> kLogChunk;
    const int last = static_cast<int>(pinned(static_cast<uint32_t>(n - 2)));
    const uint32_t ring = pinned(smem_u32(s.ring));
    // loaded from shared memory, they stay in registers: as parameters the
    // compiler reloads them from the constant bank each step, on the chain
    kp = *static_cast<volatile float*>(&s.consts[0]);
    ki = *static_cast<volatile float*>(&s.consts[1]);
    lo = *static_cast<volatile float*>(&s.consts[2]);
    hi = *static_cast<volatile float*>(&s.consts[3]);
    Hold h = {0, 0};
    int n_miss = 0;
    float pos = pos0, rate = rate0, pr = 0.f, pi = 0.f;
    // one output chunk at a time: its barriers stay off the per-step loop
    for (int64_t k0 = 0; k0 < n_out; k0 += kOutChunk) {
      const int64_t oc = k0 / kOutChunk;
      const int slot = static_cast<int>(oc & (kOutDepth - 1));
      if (oc >= kOutDepth)      // warp 2 has written this slot back
          mbar_wait(&s.out_empty[slot],
                    static_cast<uint32_t>((oc / kOutDepth - 1) & 1));
      float2* ob = s.out + slot * kOutChunk;
      const int m_out = static_cast<int>(
          n_out - k0 < kOutChunk ? n_out - k0 : kOutChunk);
      for (int o = 0; o < m_out; ++o) {
        const float pm = __fsub_rn(pos, __fmul_rn(rate, 0.5f));
        const int iy = clip_index(pos, last);
        const int im = clip_index(pm, last);
        const int low = min(iy, im), top = max(iy, im) + 1;
        // the ring's copies, right whenever every read lies in the chunks
        // held (the only case that keeps them)
        float2 ya = ring_at(ring, iy), yb = ring_at(ring, iy + 1);
        float2 ma = ring_at(ring, im), mb = ring_at(ring, im + 1);
        if (__builtin_expect((low >> kLogChunk) != h.lo ||
                             (top >> kLogChunk) >= h.hi, 0)) {
            advance(s, h, low >> kLogChunk, top >> kLogChunk, n_chunks);
            const int r_lo = h.lo << kLogChunk, r_hi = h.hi << kLogChunk;
            n_miss += (low < r_lo || top >= r_hi) ? 1 : 0;
            ya = read(ring, zr, iy, r_lo, r_hi);
            yb = read(ring, zr, iy + 1, r_lo, r_hi);
            ma = read(ring, zr, im, r_lo, r_hi);
            mb = read(ring, zr, im + 1, r_lo, r_hi);
        }
        const float2 y = lerp(ya, yb, pos, iy);
        const float2 m = lerp(ma, mb, pm, im);
        const float dr = __fsub_rn(y.x, pr);
        const float di = __fsub_rn(y.y, pi);
        float e = -__fadd_rn(__fmul_rn(dr, m.x), __fmul_rn(di, m.y));
        e = clipf(e, -1.f, 1.f);
        rate = clipf(__fadd_rn(rate, __fmul_rn(ki, e)), lo, hi);
        pos = __fadd_rn(__fadd_rn(pos, rate), __fmul_rn(kp, e));
        ob[o] = y;
        pr = y.x;
        pi = y.y;
      }
      mbar_arrive(&s.out_full[slot]);
    }
    *static_cast<volatile int*>(&s.stop) = 1;
    pos_out[r] = pos;
    misses[r] = n_miss;
}

}  // namespace

// z: (rows, n) complex64 as float2, unit RMS a row, 2 <= n < 2^31; out:
// (rows, n_out) complex64; pos_out: (rows,) float32; misses: (rows,) int32
// (each row's window misses); all contiguous. Returns the CUDA error of the
// launch (0 when it was accepted).
extern "C" int gardner(const void* z, int rows, int64_t n, int64_t n_out,
                       float pos0, float rate0, float kp, float ki, float lo,
                       float hi, void* out, float* pos_out, int* misses,
                       void* stream) {
    if (rows <= 0 || n_out <= 0) return 0;
    if (n < 2 || n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    gardner_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(z), static_cast<int>(n), n_out, pos0, rate0,
        kp, ki, lo, hi, static_cast<float2*>(out), pos_out, misses);
    return static_cast<int>(cudaGetLastError());
}
