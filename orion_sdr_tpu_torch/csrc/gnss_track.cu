// GPS L1 C/A early/prompt/late tracking loops for Hopper (sm_90a): the
// epoch recurrence of a Costas PLL and an envelope DLL with a carrier-aided
// code NCO, one block a satellite.
//
// No Pallas kernel of the JAX package computes this: it replaces the
// lax.scan of orion_sdr_tpu/gnss.py:200-254 (_track_scan), which the JAX
// bench vmaps over 8 satellites. Each epoch of a satellite, from the carry
// (base int32, frac, carr_ph, carr_f):
//     s_X   = base + {-d, 0, +d}, plus n where negative, then clamped to
//             [0, n - spms]   (lax.dynamic_slice wraps a negative start
//             numpy-style before it clamps)
//     wipe  = e^{-j(carr_ph + (w0·carr_f)·k)},  k = 0..spms-1
//     E,P,L = Σ_k code_k · z[s_X + k]·wipe_k           (vdot: code is real)
//     pll   = atan2(Im P·sign(Re P), max(|Re P|, 1e-12))   (sign(0) = 0)
//     dll   = (|E| - |L|) / max(|E| + |L|, 1e-12)
//     carr_ph ← floor-mod((carr_ph + (w0·carr_f)·spms) + kp·pll, 2π)
//     carr_f  ← carr_f + kf·pll
//     frac    ← (frac - spms·(carr_f / L1)) - (kd·dll)·spc
//     shift = rint(frac) (half to even);  base ← base + spms + shift;
//     frac ← frac - shift;   out: P, carr_f, base, frac
// The sums have a fixed order: thread t of the block's T adds the products
// of samples t, t + T, ... in turn; each warp adds its 32 partial sums by
// shuffles, pairs (l, l + s) for s = 16 .. 1; warp 0 adds the T/32 warp
// sums the same way, pairs (w, w + s) for s = T/64 .. 1. The plain torch
// version, ops/gnss_track.py::track_reference (_sum_fixed), sums in that
// order and writes the same real operations (-fmad=false, __fmul_rn/
// __fadd_rn here; cosf/sinf/atan2f/sqrtf/fmodf/rintf are what torch.cos/
// sin/atan2/sqrt/remainder/round call on the card, and L1 divides as a
// tensor), so the two agree bit for bit. The wipe's cos and sin come from
// one sincosf, which gives the bits of cosf and sinf on every float32
// (dd_pll.cu's dd_pll_sincos_mismatches checks all 2^32 on the card).
//
// What bounds it on this card: the epoch chain. Each epoch depends on the
// last (its carry sets the slices and the wipe), and only S blocks run (8
// on the bench, 1 a call on the ephemeris path) on 132 SMs, so the time is
// epochs × the latency of one epoch, far above the bytes (the capture read
// once) and operations (30 a sample) bounds. The design shortens the epoch:
//   - one prefetched window serves E, P and L: as soon as an epoch reads its
//     base, a helper warp (one warp beside the T correlating threads)
//     starts a TMA bulk copy (cp.async.bulk completing on an mbarrier) of
//     the next epoch's likely samples, [base + spms - d - M, base + 2·spms
//     + d + M), into the other of two shared-memory buffers, so the copy
//     overlaps the whole epoch and costs the correlating warps nothing, and
//     no epoch starts with a round trip to device memory (the ~300 MB
//     capture of the ephemeris path lies beyond the 50 MB L2). An epoch
//     whose three slices do not all lie in its window (a code shift beyond
//     M, or a slice wrapped or clamped at the capture's edges) reads device
//     memory instead: the same values, so the result is the same; such
//     epochs are counted in `misses`, one int32 a satellite;
//   - two block barriers an epoch, not ten: warp shuffles, then one
//     shared-memory step across warps;
//   - the codes stay in shared memory for the whole launch;
//   - the update stays on one thread for each of its dependent chains, but
//     the chains run at once on three warps: warp 0 the Costas error
//     (atan2f), the frequency and the code NCO (a division and rintf);
//     warp 1 the Costas error again and the carrier phase's fmodf; the
//     helper the DLL (two sqrtf, a division), handed to warp 0 at a named
//     barrier. On one thread the compiler lays these out one after the
//     other, each behind its branches to the slow paths.
// T (correlating threads a satellite) is 128, 256 or 512;
// ops/gnss_track.py::THREADS holds the width chip_smoke [41]'s sweep found
// fastest (PERF.md §6).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int slice_start(int s, int n, int hi) {
    if (s < 0) s += n;
    return s < 0 ? 0 : (s > hi ? hi : s);
}

__device__ __forceinline__ float sgn(float x) {
    return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float max_nan(float a, float b) {
    // torch.maximum: NaN wins
    return (a != a) ? a : (a > b ? a : b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT_%=;\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The window an epoch reads, placed from the base of the epoch before it
// (pb): [pb + spms - d - M, pb + 2·spms + d + M) clamped to the capture,
// its start aligned down and its length up to 16 bytes (2 samples), as a
// bulk copy needs; a length that would then pass the capture's end is cut
// to the 16 bytes below it. cnt = 0: no window.
struct Window {
    int64_t lo, cnt;
};

__device__ __forceinline__ Window window_of(int64_t pb, int64_t n, int spms,
                                            int d_el, int margin) {
    int64_t lo = pb + spms - d_el - margin;
    int64_t hi = pb + 2 * static_cast<int64_t>(spms) + d_el + margin;
    lo = (lo < 0 ? 0 : lo) & ~static_cast<int64_t>(1);
    hi = hi > n ? n : hi;
    int64_t cnt = hi - lo;
    if (cnt <= 0) return {lo, 0};
    cnt = (cnt + 1) & ~static_cast<int64_t>(1);
    if (lo + cnt > n) cnt -= 2;
    return {lo, cnt};
}

// Thread 0: fill buffer `dst` with window w, arriving on `bar` (an empty
// window only arrives, so every buffer's phases stay one an epoch).
__device__ __forceinline__ void fetch(const float2* z, Window w, float2* dst,
                                      uint64_t* bar) {
    // order the block's earlier reads of dst (generic proxy) before the
    // copy's writes (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (w.cnt > 0) {
        const uint32_t bytes = static_cast<uint32_t>(w.cnt * 8);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(dst)), "l"(z + w.lo), "r"(bytes),
               "r"(smem_u32(bar)) : "memory");
    } else {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                     :: "r"(smem_u32(bar)) : "memory");
    }
}

// This thread's partial sums of the three correlators (re, im each) over
// samples t, t + T, ...; xe/xp/xl point at each slice's first sample, in
// the window or in device memory.
template <int T>
__device__ __forceinline__ void correlate(const float2* xe, const float2* xp,
                                          const float2* xl,
                                          const float* code, int spms,
                                          float ph0, float wf, float acc[6]) {
#pragma unroll 4
    for (int k = threadIdx.x; k < spms; k += T) {
        const float ph = __fadd_rn(ph0, __fmul_rn(wf, static_cast<float>(k)));
        float s, c;
        sincosf(ph, &s, &c);
        const float cd = code[k];
        const float2 x[3] = {xe[k], xp[k], xl[k]};
#pragma unroll
        for (int v = 0; v < 3; ++v) {
            const float yr = __fadd_rn(__fmul_rn(x[v].x, c),
                                       __fmul_rn(x[v].y, s));
            const float yi = __fsub_rn(__fmul_rn(x[v].y, c),
                                       __fmul_rn(x[v].x, s));
            acc[2 * v] = __fadd_rn(acc[2 * v], __fmul_rn(cd, yr));
            acc[2 * v + 1] = __fadd_rn(acc[2 * v + 1], __fmul_rn(cd, yi));
        }
    }
}

__device__ __forceinline__ float pll_of(float pr, float pi) {
    return atan2f(__fmul_rn(pi, sgn(pr)), max_nan(fabsf(pr), 1e-12f));
}

// A warp's six partial sums, pairs (l, l + s) for s = 16 .. 1, with half
// the shuffles: the first step leaves values 0-2 on lanes 0-15 and 3-5 on
// lanes 16-31 (each lane sends its partner the three it drops), and the
// rest run on those halves. Lane 0 ends with sums 0-2, lane 16 with 3-5.
__device__ __forceinline__ void sum_lanes(float acc[6], int lane) {
    const bool up = lane & 16;
    float keep[3], give[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
        keep[v] = up ? acc[v + 3] : acc[v];
        give[v] = up ? acc[v] : acc[v + 3];
    }
#pragma unroll
    for (int v = 0; v < 3; ++v)
        keep[v] = __fadd_rn(keep[v], __shfl_xor_sync(kFull, give[v], 16));
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) {
#pragma unroll
        for (int v = 0; v < 3; ++v)
            keep[v] = __fadd_rn(keep[v], __shfl_xor_sync(kFull, keep[v], s));
    }
#pragma unroll
    for (int v = 0; v < 3; ++v) {      // selects, not an index: acc stays in
        acc[v] = up ? acc[v] : keep[v];          // registers
        acc[v + 3] = up ? keep[v] : acc[v + 3];
    }
}

// Two of the block's sums, va and vb, from the W warps' partial sums in
// red: pairs (w, w + s) for s = W/2 .. 1, va on lanes 0 .. W-1 and vb on
// lanes 16 .. 16 + W - 1 at once. Lane 0 gets both.
template <int W>
__device__ __forceinline__ void sum_warps(const float (&red)[6][W], int lane,
                                          int va, int vb, float& a,
                                          float& b) {
    const int w = lane & 15;
    float x = w < W ? red[lane < 16 ? va : vb][w] : 0.f;
#pragma unroll
    for (int s = W / 2; s > 0; s >>= 1)
        x = __fadd_rn(x, __shfl_down_sync(kFull, x, s));
    a = x;
    b = __shfl_sync(kFull, x, 16);
}

// Named barrier 1 between warp 0 (waits) and the helper warp (arrives):
// the helper hands warp 0 the DLL discriminator through shared memory.
__device__ __forceinline__ void dll_sync() {
    asm volatile("bar.sync 1, 64;\n" ::: "memory");
}
__device__ __forceinline__ void dll_arrive() {
    asm volatile("bar.arrive 1, 64;\n" ::: "memory");
}

// T threads correlate; one more warp (the helper, warp W) runs the window
// copies and part of the update. The second bound (one block an SM: S
// blocks on 132 SMs) lets a thread take up to 65536 / (T + 32) registers;
// with the thread count alone ptxas holds every width to 32 and spills.
template <int T>
__global__ void __launch_bounds__(T + 32, 1)
gnss_track_kernel(const float2* __restrict__ z, int n,
                  const float* __restrict__ codes, int spms,
                  const int* __restrict__ starts,
                  const float* __restrict__ f0, int64_t n_epochs, int d_el,
                  int margin, int win_cap, float w0, float spms_f, float tau,
                  float l1, float spc, float kf, float kp, float kd,
                  float2* __restrict__ prompts, float* __restrict__ freqs,
                  int* __restrict__ bases, float* __restrict__ fracs,
                  int* __restrict__ misses) {
    constexpr int W = T / 32;       // correlating warps; warp W helps
    // dynamic: the codes (spms floats, padded to 16 B), then two windows of
    // win_cap samples (none when win_cap is 0)
    extern __shared__ __align__(16) unsigned char smem[];
    float* s_code = reinterpret_cast<float*>(smem);
    float2* s_win = reinterpret_cast<float2*>(
        smem + ((static_cast<int64_t>(spms) * 4 + 15) & ~15));
    __shared__ float red[6][W];
    __shared__ __align__(8) uint64_t bar[2];
    __shared__ int s_wlo[2], s_wcnt[2];       // each buffer's window
    __shared__ int s_base;
    __shared__ float s_ph, s_f, s_dll;
    const int sat = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const bool helper = warp == W;
    const int hi = n - spms;
    const float* code = codes + static_cast<int64_t>(sat) * spms;
    // the helper's lane 0: fill buffer b with the window placed from pb
    auto fetch_from = [&](int64_t pb, int b) {
        const Window w = window_of(pb, n, spms, d_el, margin);
        s_wlo[b] = static_cast<int>(w.lo);
        s_wcnt[b] = static_cast<int>(w.cnt);
        fetch(z, w, s_win + b * static_cast<int64_t>(win_cap), &bar[b]);
    };
    for (int k = t; k < spms; k += T + 32) s_code[k] = code[k];
    if (t == 0) {
        s_base = starts[sat];
        s_ph = 0.f;
        s_f = f0[sat];
        s_wcnt[0] = s_wcnt[1] = 0;
        if (win_cap) {
            mbar_init(&bar[0]);
            mbar_init(&bar[1]);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
    }
    __syncthreads();
    if (helper && win_cap) {
        // epoch 0's window, placed as if an epoch had ended at the start
        if (lane == 0) fetch_from(static_cast<int64_t>(s_base) - spms, 0);
        mbar_wait(&bar[0], 0);
    }
    __syncthreads();
    int n_miss = 0;
    float frac = 0.f;       // the code NCO's fraction, kept by thread 0
    for (int64_t ep = 0; ep < n_epochs; ++ep) {
        const int base = s_base;
        const float ph0 = s_ph, cf = s_f;
        const float wf = __fmul_rn(w0, cf);
        const int b = static_cast<int>(ep & 1);
        float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (helper) {
            // the next epoch's window, while the others correlate
            if (lane == 0 && win_cap && ep + 1 < n_epochs)
                fetch_from(base, b ^ 1);
        } else {
            const int se = slice_start(base - d_el, n, hi);
            const int sp = slice_start(base, n, hi);
            const int sl = slice_start(base + d_el, n, hi);
            const int s_lo = min(se, min(sp, sl));
            const int s_hi = max(se, max(sp, sl)) + spms;
            const int lo = s_wlo[b], cnt = s_wcnt[b];
            const bool inside = cnt > 0 && s_lo >= lo && s_hi <= lo + cnt;
            n_miss += inside ? 0 : 1;
            if (inside) {
                const float2* xw = s_win + b * static_cast<int64_t>(win_cap) - lo;
                correlate<T>(xw + se, xw + sp, xw + sl, s_code, spms, ph0, wf,
                             acc);
            } else {
                correlate<T>(z + se, z + sp, z + sl, s_code, spms, ph0, wf,
                             acc);
            }
            sum_lanes(acc, lane);
            if (lane == 0) {
                red[0][warp] = acc[0];
                red[1][warp] = acc[1];
                red[2][warp] = acc[2];
            } else if (lane == 16) {
                red[3][warp] = acc[3];
                red[4][warp] = acc[4];
                red[5][warp] = acc[5];
            }
        }
        __syncthreads();
        // the update, its independent chains on three warps at once (each
        // adds the warp sums it needs, the same way): warp 0 the Costas
        // error, the frequency and the code NCO, waiting for the helper's
        // DLL discriminator; warp 1 the Costas error again (the same bits)
        // and the carrier phase's floor-mod; the helper the DLL, then it
        // waits for the next epoch's window
        if (warp == 0) {
            float pr, pi;
            sum_warps<W>(red, lane, 2, 3, pr, pi);
            float cf2 = 0.f, fr = 0.f;
            if (lane == 0) {
                cf2 = __fadd_rn(cf, __fmul_rn(kf, pll_of(pr, pi)));
                fr = __fsub_rn(frac, __fmul_rn(spms_f, __fdiv_rn(cf2, l1)));
            }
            dll_sync();
            if (lane == 0) {
                fr = __fsub_rn(fr, __fmul_rn(__fmul_rn(kd, s_dll), spc));
                const float shift = rintf(fr);
                const int base2 = base + spms + static_cast<int>(shift);
                fr = __fsub_rn(fr, shift);
                const int64_t o = static_cast<int64_t>(sat) * n_epochs + ep;
                prompts[o] = make_float2(pr, pi);
                freqs[o] = cf2;
                bases[o] = base2;
                fracs[o] = fr;
                frac = fr;
                s_base = base2;
                s_f = cf2;
            }
        } else if (warp == 1) {
            float pr, pi;
            sum_warps<W>(red, lane, 2, 3, pr, pi);
            if (lane == 0) {
                const float u = __fadd_rn(__fadd_rn(ph0, __fmul_rn(wf, spms_f)),
                                          __fmul_rn(kp, pll_of(pr, pi)));
                float m = fmodf(u, tau);
                if (m != 0.f && ((tau < 0.f) != (m < 0.f)))
                    m = __fadd_rn(m, tau);
                s_ph = m;
            }
        } else if (helper) {
            float er, ei, lr, li;
            sum_warps<W>(red, lane, 0, 1, er, ei);
            sum_warps<W>(red, lane, 4, 5, lr, li);
            if (lane == 0) {
                const float ae = sqrtf(__fadd_rn(__fmul_rn(er, er),
                                                 __fmul_rn(ei, ei)));
                const float al = sqrtf(__fadd_rn(__fmul_rn(lr, lr),
                                                 __fmul_rn(li, li)));
                s_dll = __fdiv_rn(__fsub_rn(ae, al),
                                  max_nan(__fadd_rn(ae, al), 1e-12f));
            }
            dll_arrive();
            // the copy has had the whole epoch; the barrier below hands it
            // to the correlating warps
            if (win_cap && ep + 1 < n_epochs)
                mbar_wait(&bar[b ^ 1],
                          static_cast<uint32_t>(((ep + 1) >> 1) & 1));
        }
        __syncthreads();
    }
    if (t == 0) misses[sat] = n_miss;
}

template <int T>
int launch(const float2* z, int n, const float* codes, int n_sat,
           int spms, const int* starts, const float* f0, int64_t n_epochs,
           int d_el, int margin, int win_cap, size_t smem, float w0,
           float spms_f, float tau, float l1, float spc, float kf, float kp,
           float kd, float2* prompts, float* freqs, int* bases, float* fracs,
           int* misses, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            gnss_track_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    gnss_track_kernel<T><<<n_sat, T + 32, smem, stream>>>(
        z, n, codes, spms, starts, f0, n_epochs, d_el, margin, win_cap, w0,
        spms_f, tau, l1, spc, kf, kp, kd, prompts, freqs, bases, fracs,
        misses);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: (n,) complex64 as float2; codes: (S, spms) float32 ±1; starts: (S,)
// int32; f0: (S,) float32; prompts: (S, n_epochs) complex64; freqs, fracs:
// (S, n_epochs) float32; bases: (S, n_epochs) int32; misses: (S,) int32,
// the epochs that read device memory; all contiguous, spms <= n < 2^31.
// threads:
// 128, 256 or 512 a satellite; margin: M, the code shift (samples) an
// epoch's window allows for. Without a 16-byte aligned capture, or where
// two windows and the codes exceed the block's shared memory, every epoch
// reads device memory. Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int gnss_track(const void* z, int64_t n, const float* codes,
                          int n_sat, int spms, const int* starts,
                          const float* f0, int64_t n_epochs, int d_el,
                          int margin, int threads, float w0, float spms_f,
                          float tau, float l1, float spc, float kf, float kp,
                          float kd, void* prompts, float* freqs, int* bases,
                          float* fracs, int* misses, void* stream) {
    if (n_sat <= 0 || n_epochs <= 0) return 0;
    if (spms <= 0 || n < spms || n > INT32_MAX || margin < 0 || d_el < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t code_bytes = (static_cast<size_t>(spms) * 4 + 15) & ~size_t(15);
    // a window holds spms + 2·d + 2·M samples, one more for the aligned
    // start and one for the rounded length; 1 KB is left for the kernel's
    // static shared memory
    int win_cap = (spms + 2 * d_el + 2 * margin + 2) & ~1;
    size_t smem = code_bytes + 2 * static_cast<size_t>(win_cap) * 8;
    if (smem + 1024 > static_cast<size_t>(optin) ||
        (reinterpret_cast<uintptr_t>(z) & 15) != 0) {
        win_cap = 0;
        smem = code_bytes;
    }
    if (smem + 1024 > static_cast<size_t>(optin))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto zz = static_cast<const float2*>(z);
    const auto pp = static_cast<float2*>(prompts);
    switch (threads) {
        case 128:
            return launch<128>(zz, static_cast<int>(n), codes, n_sat, spms, starts, f0,
                               n_epochs, d_el, margin, win_cap, smem, w0,
                               spms_f, tau, l1, spc, kf, kp, kd, pp, freqs,
                               bases, fracs, misses, st);
        case 256:
            return launch<256>(zz, static_cast<int>(n), codes, n_sat, spms, starts, f0,
                               n_epochs, d_el, margin, win_cap, smem, w0,
                               spms_f, tau, l1, spc, kf, kp, kd, pp, freqs,
                               bases, fracs, misses, st);
        case 512:
            return launch<512>(zz, static_cast<int>(n), codes, n_sat, spms, starts, f0,
                               n_epochs, d_el, margin, win_cap, smem, w0,
                               spms_f, tau, l1, spc, kf, kp, kd, pp, freqs,
                               bases, fracs, misses, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
