// PSK31 decision-feedback matched filter + first-order PLL for Hopper
// (sm_90a): the per-symbol recurrence over precomputed matched-filter dots,
// one row (a channel or carrier) a thread.
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
// rounds apart here (-fmad=false, __fmul_rn/__fadd_rn), cosf/sinf/rsqrtf
// are the functions torch.cos/sin/rsqrt call on the card, and fmodf is the
// remainder torch.remainder takes.
//
// What bounds it on this card: the latency of the per-row chain (a
// complex multiply-add, cos and sin of the phase, rsqrt, fmod: some 100
// dependent instructions a symbol), not bytes (each dot is read once, each
// soft value written once) or operations. The design keeps the carry in
// registers and loads later dots ahead of the chain (__restrict__
// pointers, unrolled loop).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // rows a block: one warp, so rows spread over SMs
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

template <bool kQpsk>
__global__ void __launch_bounds__(kThreads)
psk31_pll_kernel(const float2* __restrict__ dots,
                 const float2* __restrict__ prev0,
                 const float* __restrict__ acc0, int rows, int64_t n,
                 float c_fb, float scale, float gain,
                 float* __restrict__ soft, float2* __restrict__ prev_out,
                 float* __restrict__ acc_out) {
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= rows) return;
    const float2* dr = dots + r * n;
    float* sr = soft + r * n * (kQpsk ? 2 : 1);
    float pr = prev0[r].x, pi = prev0[r].y;
    float acc = acc0[r];
#pragma unroll 4
    for (int64_t k = 0; k < n; ++k) {
        const float2 dot = dr[k];
        const float yr = __fmul_rn(__fsub_rn(dot.x, __fmul_rn(pr, c_fb)), scale);
        const float yi = __fmul_rn(__fsub_rn(dot.y, __fmul_rn(pi, c_fb)), scale);
        const float c = cosf(acc);
        const float s = sinf(acc);
        const float cr = __fadd_rn(__fmul_rn(yr, c), __fmul_rn(yi, s));
        const float ci = __fsub_rn(__fmul_rn(yi, c), __fmul_rn(yr, s));
        const float d_re = __fadd_rn(__fmul_rn(cr, pr), __fmul_rn(ci, pi));
        const float d_im = __fsub_rn(__fmul_rn(ci, pr), __fmul_rn(cr, pi));
        float cross;
        if (kQpsk) {
            const bool re_wins = fabsf(d_re) >= fabsf(d_im);
            const float dec_re = re_wins ? (d_re >= 0.f ? 1.f : -1.f) : 0.f;
            const float dec_im = re_wins ? 0.f : (d_im >= 0.f ? 1.f : -1.f);
            cross = __fsub_rn(__fmul_rn(d_im, dec_re), __fmul_rn(d_re, dec_im));
            sr[2 * k] = d_re;
            sr[2 * k + 1] = d_im;
        } else {
            cross = __fmul_rn(d_im, d_re >= 0.f ? 1.f : -1.f);
            sr[k] = d_re;
        }
        const float mag = __fadd_rn(__fmul_rn(d_re, d_re), __fmul_rn(d_im, d_im));
        const float err = mag > 1e-6f ? __fmul_rn(cross, rsqrtf(mag)) : 0.f;
        const float u = __fadd_rn(__fadd_rn(acc, __fmul_rn(gain, err)), kPi);
        // fmodf(u, 2π) is u itself on [0, 2π), where a wrapped phase lands
        // but for a step across ±π: skip the call there
        float m = (u >= 0.f && u < kTwoPi) ? u : fmodf(u, kTwoPi);
        if (m != 0.f && m < 0.f) m = __fadd_rn(m, kTwoPi);
        acc = __fsub_rn(m, kPi);
        pr = cr;
        pi = ci;
    }
    prev_out[r] = make_float2(pr, pi);
    acc_out[r] = acc;
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
    if (rows <= 0) return 0;
    const dim3 grid((rows + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2* d = static_cast<const float2*>(dots);
    const float2* p0 = static_cast<const float2*>(prev0);
    float2* po = static_cast<float2*>(prev_out);
    if (qpsk)
        psk31_pll_kernel<true><<<grid, kThreads, 0, s>>>(
            d, p0, acc0, rows, n, c_fb, scale, gain, soft, po, acc_out);
    else
        psk31_pll_kernel<false><<<grid, kThreads, 0, s>>>(
            d, p0, acc0, rows, n, c_fb, scale, gain, soft, po, acc_out);
    return static_cast<int>(cudaGetLastError());
}
