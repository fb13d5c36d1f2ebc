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
// The sums have a fixed order: thread t of the block's kThreads adds the
// products of samples t, t + kThreads, ... in turn, then a shared-memory
// tree adds pairs (t, t + stride) for stride = kThreads/2 .. 1. The plain
// torch version, ops/gnss_track.py::track_reference, sums in that order and
// writes the same real operations (-fmad=false, __fmul_rn/__fadd_rn here;
// cosf/sinf/atan2f/sqrtf/fmodf/rintf are what torch.cos/sin/atan2/sqrt/
// remainder/round call on the card, and L1 divides as a tensor), so the two
// agree bit for bit.
//
// What bounds it on this card: latency. Each epoch is a dependent step (its
// carry sets the next epoch's slices and wipe), and only S blocks run (8 on
// the bench, 1 a call on the ephemeris path) on 132 SMs; within an epoch
// the block's threads share 3·spms wiped products and a tree, then one
// thread runs the loop update while the others wait at a barrier. The
// operations and bytes of the whole run would take the card some
// microseconds; the design spends its threads on the epoch's products and
// keeps the carry in shared memory, broadcast to the block each epoch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;   // the plain version's tree has this width

__device__ __forceinline__ int64_t slice_start(int64_t s, int64_t n,
                                               int64_t hi) {
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

__global__ void __launch_bounds__(kThreads)
gnss_track_kernel(const float2* __restrict__ z, int64_t n,
                  const float* __restrict__ codes, int spms,
                  const int* __restrict__ starts,
                  const float* __restrict__ f0, int64_t n_epochs, int d_el,
                  float w0, float spms_f, float tau, float l1, float spc,
                  float kf, float kp, float kd, float2* __restrict__ prompts,
                  float* __restrict__ freqs, int* __restrict__ bases,
                  float* __restrict__ fracs) {
    __shared__ float red[6][kThreads];
    __shared__ int s_base;
    __shared__ float s_frac, s_ph, s_f;
    const int sat = blockIdx.x;
    const int t = threadIdx.x;
    const float* code = codes + static_cast<int64_t>(sat) * spms;
    const int64_t hi = n - spms;
    if (t == 0) {
        s_base = starts[sat];
        s_frac = 0.f;
        s_ph = 0.f;
        s_f = f0[sat];
    }
    __syncthreads();
    for (int64_t ep = 0; ep < n_epochs; ++ep) {
        const int base = s_base;
        const float ph0 = s_ph, cf = s_f;
        const int64_t se = slice_start(static_cast<int64_t>(base) - d_el, n, hi);
        const int64_t sp = slice_start(static_cast<int64_t>(base), n, hi);
        const int64_t sl = slice_start(static_cast<int64_t>(base) + d_el, n, hi);
        const float wf = __fmul_rn(w0, cf);
        float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int k = t; k < spms; k += kThreads) {
            const float ph = __fadd_rn(ph0, __fmul_rn(wf, static_cast<float>(k)));
            const float c = cosf(ph);
            const float s = sinf(ph);
            const float cd = __ldg(code + k);
            const float2 x[3] = {__ldg(z + se + k), __ldg(z + sp + k),
                                 __ldg(z + sl + k)};
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
#pragma unroll
        for (int v = 0; v < 6; ++v) red[v][t] = acc[v];
        __syncthreads();
        for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
            if (t < stride) {
#pragma unroll
                for (int v = 0; v < 6; ++v)
                    red[v][t] = __fadd_rn(red[v][t], red[v][t + stride]);
            }
            __syncthreads();
        }
        if (t == 0) {
            const float er = red[0][0], ei = red[1][0];
            const float pr = red[2][0], pi = red[3][0];
            const float lr = red[4][0], li = red[5][0];
            const float pll = atan2f(__fmul_rn(pi, sgn(pr)),
                                     max_nan(fabsf(pr), 1e-12f));
            const float ae = sqrtf(__fadd_rn(__fmul_rn(er, er), __fmul_rn(ei, ei)));
            const float al = sqrtf(__fadd_rn(__fmul_rn(lr, lr), __fmul_rn(li, li)));
            const float dll = __fdiv_rn(__fsub_rn(ae, al),
                                        max_nan(__fadd_rn(ae, al), 1e-12f));
            const float u = __fadd_rn(__fadd_rn(ph0, __fmul_rn(wf, spms_f)),
                                      __fmul_rn(kp, pll));
            float m = fmodf(u, tau);
            if (m != 0.f && ((tau < 0.f) != (m < 0.f))) m = __fadd_rn(m, tau);
            const float cf2 = __fadd_rn(cf, __fmul_rn(kf, pll));
            float fr = __fsub_rn(__fsub_rn(s_frac,
                                           __fmul_rn(spms_f, __fdiv_rn(cf2, l1))),
                                 __fmul_rn(__fmul_rn(kd, dll), spc));
            const float shift = rintf(fr);
            const int base2 = base + spms + static_cast<int>(shift);
            fr = __fsub_rn(fr, shift);
            const int64_t o = static_cast<int64_t>(sat) * n_epochs + ep;
            prompts[o] = make_float2(pr, pi);
            freqs[o] = cf2;
            bases[o] = base2;
            fracs[o] = fr;
            s_base = base2;
            s_frac = fr;
            s_ph = m;
            s_f = cf2;
        }
        __syncthreads();
    }
}

}  // namespace

// z: (n,) complex64 as float2; codes: (S, spms) float32 ±1; starts: (S,)
// int32; f0: (S,) float32; prompts: (S, n_epochs) complex64; freqs, fracs:
// (S, n_epochs) float32; bases: (S, n_epochs) int32; all contiguous, n >=
// spms. Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int gnss_track(const void* z, int64_t n, const float* codes,
                          int n_sat, int spms, const int* starts,
                          const float* f0, int64_t n_epochs, int d_el,
                          float w0, float spms_f, float tau, float l1,
                          float spc, float kf, float kp, float kd,
                          void* prompts, float* freqs, int* bases,
                          float* fracs, void* stream) {
    if (n_sat <= 0 || n_epochs <= 0) return 0;
    if (spms <= 0 || n < spms) return static_cast<int>(cudaErrorInvalidValue);
    gnss_track_kernel<<<n_sat, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(z), n, codes, spms, starts, f0, n_epochs,
        d_el, w0, spms_f, tau, l1, spc, kf, kp, kd,
        static_cast<float2*>(prompts), freqs, bases, fracs);
    return static_cast<int>(cudaGetLastError());
}
