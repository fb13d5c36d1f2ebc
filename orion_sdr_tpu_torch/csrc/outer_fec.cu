// Batched BCH and Reed-Solomon outer decoding for Hopper (sm_90a).
//
// No Pallas kernel of the JAX package computes this: the kernels replace
// the jnp programs orion_sdr_tpu/fec/bch_device.py:87 bch_decode_batch_device
// and :206 rs_decode_batch_device, with their semantics bit for bit (the
// plain torch versions are fec/bch_device.py::bch_decode_batch_reference and
// ::rs_decode_batch_reference):
//  * syndromes S_j = sum_p r_p a^(j deg p), deg p = n-1-p+shift = 254-p,
//    shift = 255-n (the shortened code sits at the high end of the length-255
//    frame). BCH takes the odd syndromes from one 64-bit word a position
//    (byte i = a^((2i+1) deg p)) and the even ones as squares, S_2j = S_j^2,
//    which holds for every binary word;
//  * Berlekamp-Massey over 2t iterations with the shift register kept
//    pre-multiplied by x, truncated to cap = t+2 coefficients: delta =
//    sum_i sigma_i S_(n-i) over n-i >= start; reset when delta != 0 and
//    2l < n (BCH, start 1; l <- n-l) or 2l <= n (RS, start 0; l <- n+1-l);
//    sigma ^= delta bx when delta != 0; bx <- x sigma_old / delta on reset,
//    else bx <- x bx;
//  * Chien over the window d = shift .. 254: a root of sigma(a^-d) marks word
//    position 254-d;
//  * RS: Forney magnitudes e = x Omega(x^-1) / sigma'(x^-1) at x = a^d, with
//    Omega = S sigma mod x^2t and 1/0 taken as 0 (flagged bad_dv);
//  * the residual syndrome of the corrected word (updated by the flips, by
//    linearity) and the accept sets: BCH resid_ok && n_found <= t; RS
//    resid_ok && !bad_dv && n_err == deg sigma && deg sigma <= t. Rows with
//    no error are ok; failed rows keep their systematic prefix.
// All of it is integer arithmetic over GF(256) (poly 0x11D) through exp/log
// tables, so the kernel and the plain version agree on every bit.
//
// What bounds it on this card: latency, not bytes or operations. A codeword
// is a chain of dependent steps (n syndrome positions, 2t BM iterations of
// up to cap products each, n Chien positions of cap terms each); device
// memory sees each codeword byte once and each message byte once. The
// design: one thread a codeword, 64 codewords a block; the block stages its
// rows in shared memory with coalesced loads, holds the GF tables (and for
// BCH the syndrome words) in shared memory, keeps the syndromes and the BM
// registers in registers (t is a template parameter, so every index is a
// constant), and writes the messages back from shared memory, coalesced.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // codewords a block
constexpr int kOrder = 255;

struct GfTables {
    uint8_t exp[512];
    uint8_t log[256];
};

__device__ __forceinline__ int gmul(const GfTables& g, int a, int b) {
    return (a != 0 && b != 0) ? g.exp[g.log[a] + g.log[b]] : 0;
}

__device__ __forceinline__ int ginv(const GfTables& g, int a) {
    return a != 0 ? g.exp[kOrder - g.log[a]] : 0;  // 0 maps to 0, as a^254
}

// the tables arrive as one 768-byte device array: exp[512] then log[256]
__device__ __forceinline__ void load_tables(GfTables& g, const uint8_t* tab) {
    for (int i = threadIdx.x; i < 768; i += blockDim.x) {
        if (i < 512)
            g.exp[i] = tab[i];
        else
            g.log[i - 512] = tab[i];
    }
}

// Berlekamp-Massey over iterations START..NS-1 on syndromes s[0..NS-1]
// (BCH: START = 1, s[0] = 0, s[j] = S_j; RS: START = 0, s[j] = S_j),
// iteration n reading s[n - i] for sigma_i. Returns sigma in sig[].
template <int CAP, int NS, int START>
__device__ __forceinline__ void berlekamp_massey(const GfTables& g,
                                                 const int (&s)[NS],
                                                 int (&sig)[CAP]) {
    int bx[CAP];
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
        sig[i] = i == 0 ? 1 : 0;
        bx[i] = i == 1 ? 1 : 0;
    }
    int l = 0;
#pragma unroll
    for (int nn = START; nn < NS; ++nn) {
        int delta = 0;
#pragma unroll
        for (int i = 0; i < CAP; ++i) {
            if (nn - i >= START) delta ^= gmul(g, sig[i], s[nn - i]);
        }
        const bool reset =
            delta != 0 && (START == 1 ? 2 * l < nn : 2 * l <= nn);
        const int dinv = ginv(g, delta);
        int nb[CAP];
        nb[0] = 0;
#pragma unroll
        for (int i = 1; i < CAP; ++i) nb[i] = gmul(g, dinv, sig[i - 1]);
        if (delta != 0) {
#pragma unroll
            for (int i = 0; i < CAP; ++i) sig[i] ^= gmul(g, delta, bx[i]);
        }
        if (reset) {
#pragma unroll
            for (int i = 0; i < CAP; ++i) bx[i] = nb[i];
            l = START == 1 ? nn - l : nn + 1 - l;
        } else {
#pragma unroll
            for (int i = CAP - 1; i > 0; --i) bx[i] = bx[i - 1];
            bx[0] = 0;
        }
    }
}

// Chien over the window: for p = 0..n-1 (d = shift + p) counts the roots of
// sigma(a^-d) and records their d (at most CAP-1: a nonzero polynomial of
// degree <= CAP-1 has no more). Returns the root count.
template <int CAP>
__device__ __forceinline__ int chien(const GfTables& g, const int (&sig)[CAP],
                                     int n, int (&root_d)[CAP - 1]) {
    const int shift = kOrder - n;
    int e[CAP];  // log of sigma_m a^(-m d), or -1 where sigma_m = 0
#pragma unroll
    for (int m = 0; m < CAP; ++m)
        e[m] = sig[m] != 0 ? (g.log[sig[m]] + m * (kOrder - shift)) % kOrder
                           : -1;
    int found = 0;
    for (int p = 0; p < n; ++p) {
        int v = 0;
#pragma unroll
        for (int m = 0; m < CAP; ++m) {
            if (e[m] >= 0) {
                v ^= g.exp[e[m]];
                e[m] -= m;
                if (e[m] < 0) e[m] += kOrder;
            }
        }
        if (v == 0) {
            if (found < CAP - 1) root_d[found] = shift + p;
            ++found;
        }
    }
    return found;
}

// Stage rows [row0, row0 + rows) of n bytes into shared memory (masked
// with `mask`), coalesced.
__device__ __forceinline__ void stage_in(uint8_t* rows_s, const uint8_t* in,
                                         long long row0, int rows, int n,
                                         int mask) {
    const uint8_t* src = in + row0 * n;
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x)
        rows_s[i] = static_cast<uint8_t>(src[i] & mask);
}

// Write the first k bytes of each staged row to out, coalesced.
__device__ __forceinline__ void stage_out(uint8_t* out, const uint8_t* rows_s,
                                          long long row0, int rows, int n,
                                          int k) {
    uint8_t* dst = out + row0 * k;
    for (int i = threadIdx.x; i < rows * k; i += blockDim.x)
        dst[i] = rows_s[(i / k) * n + i % k];
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    bch_decode_kernel(const uint8_t* __restrict__ in, int B, int n, int k,
                      const uint8_t* __restrict__ tab,
                      uint8_t* __restrict__ out, int* __restrict__ ok) {
    constexpr int CAP = T + 2;
    constexpr int NS = 2 * T + 1;  // s[0] = 0, s[j] = S_j
    __shared__ GfTables g;
    __shared__ unsigned long long w64[kOrder];
    extern __shared__ uint8_t rows_s[];
    load_tables(g, tab);
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        const int deg = 254 - p;
        unsigned long long w = 0;
        for (int i = 0; i < T; ++i)
            w |= static_cast<unsigned long long>(
                     g.exp[((2 * i + 1) * deg) % kOrder])
                 << (8 * i);
        w64[p] = w;
    }
    const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
    const int rows = static_cast<int>(min(static_cast<long long>(kThreads),
                                          B - row0));
    stage_in(rows_s, in, row0, rows, n, 1);
    __syncthreads();
    if (threadIdx.x < rows) {
        uint8_t* r = rows_s + threadIdx.x * n;
        unsigned long long acc = 0;
        for (int p = 0; p < n; ++p)
            acc ^= w64[p] & (0ull - static_cast<unsigned long long>(r[p]));
        int okv = 1;
        if (acc != 0) {  // odd syndromes all zero <=> all zero
            int s[NS];
            s[0] = 0;
#pragma unroll
            for (int i = 0; i < T; ++i)
                s[2 * i + 1] = static_cast<int>((acc >> (8 * i)) & 0xFF);
#pragma unroll
            for (int j = 2; j < NS; j += 2) s[j] = gmul(g, s[j / 2], s[j / 2]);
            int sig[CAP];
            berlekamp_massey<CAP, NS, 1>(g, s, sig);
            int root_d[CAP - 1];
            const int found = chien<CAP>(g, sig, n, root_d);
            unsigned long long resid = acc;
            const int kept = min(found, CAP - 1);
            for (int i = 0; i < kept; ++i) resid ^= w64[254 - root_d[i]];
            okv = resid == 0 && found <= T;
            if (okv) {
                for (int i = 0; i < kept; ++i) r[254 - root_d[i]] ^= 1;
            }
        }
        ok[row0 + threadIdx.x] = okv;
    }
    __syncthreads();
    stage_out(out, rows_s, row0, rows, n, k);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    rs_decode_kernel(const uint8_t* __restrict__ in, int B, int n,
                     const uint8_t* __restrict__ tab,
                     uint8_t* __restrict__ out, int* __restrict__ ok) {
    constexpr int CAP = T + 2;
    constexpr int NP = 2 * T;
    const int k = n - NP;
    __shared__ GfTables g;
    extern __shared__ uint8_t rows_s[];
    load_tables(g, tab);
    const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
    const int rows = static_cast<int>(min(static_cast<long long>(kThreads),
                                          B - row0));
    stage_in(rows_s, in, row0, rows, n, 0xFF);
    __syncthreads();
    if (threadIdx.x < rows) {
        uint8_t* r = rows_s + threadIdx.x * n;
        int s[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) s[j] = 0;
        for (int p = 0; p < n; ++p) {
            const int rp = r[p];
            if (rp == 0) continue;
            const int deg = 254 - p;
            int e = g.log[rp];
#pragma unroll
            for (int j = 0; j < NP; ++j) {
                s[j] ^= g.exp[e];
                e += deg;
                if (e >= kOrder) e -= kOrder;
            }
        }
        bool any = false;
#pragma unroll
        for (int j = 0; j < NP; ++j) any |= s[j] != 0;
        int okv = 1;
        if (any) {
            int sig[CAP];
            berlekamp_massey<CAP, NP, 0>(g, s, sig);
            int sdeg = 0;
#pragma unroll
            for (int i = 0; i < CAP; ++i)
                if (sig[i] != 0) sdeg = i;
            int root_d[CAP - 1];
            const int n_err = chien<CAP>(g, sig, n, root_d);
            // Omega = S sigma mod x^2t; sigma' keeps sigma's odd terms
            int omega[NP];
#pragma unroll
            for (int i = 0; i < NP; ++i) {
                int acc = 0;
#pragma unroll
                for (int j = 0; j < CAP; ++j)
                    if (j <= i) acc ^= gmul(g, sig[j], s[i - j]);
                omega[i] = acc;
            }
            bool bad_dv = false;
            int mag[CAP - 1];
            const int kept = min(n_err, CAP - 1);
            int resid[NP];
#pragma unroll
            for (int j = 0; j < NP; ++j) resid[j] = s[j];
            for (int e = 0; e < kept; ++e) {
                const int d = root_d[e];
                const int step = kOrder - d;  // log of a^-d
                int om = 0, dv = 0, xm = 0;   // xm: log of a^(-m d)
#pragma unroll
                for (int m = 0; m < NP; ++m) {
                    if (omega[m] != 0) om ^= g.exp[g.log[omega[m]] + xm];
                    if (m + 1 < CAP && (m & 1) == 0 && sig[m + 1] != 0)
                        dv ^= g.exp[g.log[sig[m + 1]] + xm];
                    xm += step;
                    if (xm >= kOrder) xm -= kOrder;
                }
                bad_dv |= dv == 0;
                const int x = g.exp[d];
                const int me = gmul(g, x, gmul(g, om, ginv(g, dv)));
                mag[e] = me;
                if (me != 0) {
                    int ee = g.log[me];
#pragma unroll
                    for (int j = 0; j < NP; ++j) {
                        resid[j] ^= g.exp[ee];
                        ee += d;
                        if (ee >= kOrder) ee -= kOrder;
                    }
                }
            }
            bool resid_ok = true;
#pragma unroll
            for (int j = 0; j < NP; ++j) resid_ok &= resid[j] == 0;
            okv = resid_ok && !bad_dv && n_err == sdeg && sdeg <= T;
            if (okv) {
                for (int e = 0; e < kept; ++e)
                    r[254 - root_d[e]] ^= static_cast<uint8_t>(mag[e]);
            }
        }
        ok[row0 + threadIdx.x] = okv;
    }
    __syncthreads();
    stage_out(out, rows_s, row0, rows, n, k);
}

int grid_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

// BCH(n, k, t) decode of B codewords of n bits (one byte a bit, masked to
// its low bit): out (B, k) message bits, ok (B,) flags. 1 <= t <= 8,
// k < n <= 255. Returns a cudaError_t code (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int outer_bch_decode(const uint8_t* in, int B, int n, int k, int t,
                                const uint8_t* tables, uint8_t* out, int* ok,
                                void* stream) {
    if (t < 1 || t > 8 || n > 255 || k <= 0 || k >= n || B < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = static_cast<size_t>(kThreads) * n;
    const int grid = grid_for(B);
    switch (t) {
#define ORION_BCH_CASE(TT)                                                   \
    case TT:                                                                 \
        bch_decode_kernel<TT><<<grid, kThreads, smem, st>>>(in, B, n, k,     \
                                                           tables, out, ok); \
        break;
        ORION_BCH_CASE(1) ORION_BCH_CASE(2) ORION_BCH_CASE(3) ORION_BCH_CASE(4)
        ORION_BCH_CASE(5) ORION_BCH_CASE(6) ORION_BCH_CASE(7) ORION_BCH_CASE(8)
#undef ORION_BCH_CASE
    }
    return static_cast<int>(cudaGetLastError());
}

// RS(n, n - n_parity) decode of B codewords of n bytes: out (B, k) message
// bytes, ok (B,) flags. n_parity even, 2..16; n_parity < n <= 255. Returns
// a cudaError_t code.
extern "C" int outer_rs_decode(const uint8_t* in, int B, int n, int n_parity,
                               const uint8_t* tables, uint8_t* out, int* ok,
                               void* stream) {
    if (n_parity < 2 || n_parity > 16 || (n_parity & 1) || n > 255 ||
        n_parity >= n || B < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = static_cast<size_t>(kThreads) * n;
    const int grid = grid_for(B);
    switch (n_parity / 2) {
#define ORION_RS_CASE(TT)                                                     \
    case TT:                                                                  \
        rs_decode_kernel<TT><<<grid, kThreads, smem, st>>>(in, B, n, tables,  \
                                                          out, ok);           \
        break;
        ORION_RS_CASE(1) ORION_RS_CASE(2) ORION_RS_CASE(3) ORION_RS_CASE(4)
        ORION_RS_CASE(5) ORION_RS_CASE(6) ORION_RS_CASE(7) ORION_RS_CASE(8)
#undef ORION_RS_CASE
    }
    return static_cast<int>(cudaGetLastError());
}
