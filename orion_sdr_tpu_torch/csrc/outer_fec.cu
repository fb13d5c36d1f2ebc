// Batched BCH and Reed-Solomon outer decoding for Hopper (sm_90a).
//
// No Pallas kernel of the JAX package computes this: the kernels replace
// the jnp programs orion_sdr_tpu/fec/bch_device.py:87 bch_decode_batch_device
// and :206 rs_decode_batch_device, with their semantics bit for bit (the
// plain torch versions are fec/bch_device.py::bch_decode_batch_reference and
// ::rs_decode_batch_reference):
//  * syndromes S_j = sum_p r_p a^(j deg p), deg p = 254 - p (the shortened
//    code sits at the high end of the length-255 frame). BCH takes the odd
//    syndromes from one 64-bit word a position (byte i = a^((2i+1) deg p),
//    built on the host) and the even ones as squares, S_2j = S_j^2, which
//    holds for every binary word;
//  * Berlekamp-Massey over 2t iterations with the shift register kept
//    pre-multiplied by x, truncated to cap = t+2 coefficients: delta =
//    sum_i sigma_i S_(n-i) over n-i >= start; reset when delta != 0 and
//    2l < n (BCH, start 1; l <- n-l) or 2l <= n (RS, start 0; l <- n+1-l);
//    sigma ^= delta bx when delta != 0; bx <- x sigma_old / delta on reset,
//    else bx <- x bx;
//  * Chien: position p is in error when sigma(a^-deg p) = 0;
//  * RS: Forney magnitudes e = X Omega(X^-1) / sigma'(X^-1) at X = a^deg p,
//    with Omega = S sigma mod x^2t and 1/0 taken as 0 (flagged bad_dv);
//  * the residual syndrome of the corrected word (the syndromes with every
//    root's correction folded in, by linearity) and the accept sets: BCH
//    resid_ok && n_found <= t; RS resid_ok && !bad_dv && n_err == deg sigma
//    && deg sigma <= t. Rows with no error are ok; failed rows keep their
//    systematic prefix.
// Every root is corrected, as in the plain versions: sigma_0 = 1, so sigma
// is a nonzero polynomial of degree <= cap - 1 and has at most cap - 1
// roots among the window's distinct points, and no cut is needed.
// All of it is integer arithmetic over GF(256) (poly 0x11D) through exp/log
// tables, so the kernel and the plain version agree on every bit.
//
// What bounds it on this card: latency, not bytes or operations (device
// memory sees each codeword byte once and each message byte once). A
// codeword is a chain of dependent steps: n syndrome positions, 2t
// Berlekamp-Massey iterations, n Chien positions, the Forney terms. The
// design cuts the chain and spreads the batch:
//   - a group of G lanes a codeword (G = 16 or 32, a template parameter),
//     several groups a block, as ops/outer_fec.py::launch_plan chooses, so
//     one frame's 51 codewords run on 51 SMs and a batch of thousands on
//     all of them;
//   - lane l owns positions l, l + G, ...: it loads its bytes straight from
//     device memory (the group reads its row contiguously; at most 16
//     loads a lane, all in flight at once), keeps partial syndromes in
//     registers (RS: 2t bytes packed in 32-bit words; BCH: one 64-bit
//     word) and the group XOR-reduces them by shuffles. A row whose
//     syndromes are all zero ends there, which is nearly every row on the
//     receive paths;
//   - Berlekamp-Massey with one coefficient a lane: lane i holds sigma_i
//     and bx_i; S_(n-i) reaches lane i by a shuffle up the lanes each
//     iteration, delta is a 16-lane XOR reduction, and every lane decides
//     the reset alike;
//   - Chien by position: each lane evaluates sigma at its own positions and
//     keeps its roots in a bit mask; the Forney magnitude and the residual
//     fold of each root are computed by the lane that owns it (magnitudes
//     kept as bytes of two 64-bit registers), and the group reduces the
//     residual, the root count and bad_dv. An accepted row's lanes apply
//     their own corrections and write their message bytes;
//   - the exp/log tables (768 bytes, built on the host) are loaded with
//     16-byte loads once a block (RS requests its rows first, so the two
//     round trips overlap); BCH's syndrome words stay in device memory
//     (each lane reads its own positions' words).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kOrder = 255;
constexpr int kMaxThreads = 256;
constexpr int kBmLanes = 16;  // lanes of the Berlekamp-Massey reduction

struct __align__(16) GfTables {
    uint8_t exp[512];
    uint8_t log[256];
};

// a group's shared scratch: sigma, the syndromes, Omega (16 bytes each)
struct __align__(16) Scratch {
    uint8_t sig[16];
    uint8_t s[16];
    uint8_t om[16];
};

__device__ __forceinline__ int gmul(const GfTables& g, int a, int b) {
    return (a != 0 && b != 0) ? g.exp[g.log[a] + g.log[b]] : 0;
}

__device__ __forceinline__ int ginv(const GfTables& g, int a) {
    return a != 0 ? g.exp[kOrder - g.log[a]] : 0;  // 0 maps to 0, as a^254
}

// the tables arrive as one 16-byte aligned 768-byte device array: exp[512]
// then log[256]
__device__ __forceinline__ void load_tables(GfTables& g, const uint8_t* tab) {
    const uint4* src = reinterpret_cast<const uint4*>(tab);
    uint4* dst = reinterpret_cast<uint4*>(&g);
    for (int i = threadIdx.x; i < 48; i += blockDim.x) dst[i] = __ldg(src + i);
}

// byte j of 16 bytes held as four 32-bit words (j a constant after unrolling)
__device__ __forceinline__ int byte_of(const uint4& v, int j) {
    const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
    return static_cast<int>((w >> (8 * (j & 3))) & 0xFF);
}

// G lanes of a warp working on one codeword
template <int G>
struct Group {
    unsigned mask;  // the group's lanes in the warp
    int lane;       // 0 .. G-1
    __device__ __forceinline__ Group() {
        const int wl = threadIdx.x & 31;
        lane = wl & (G - 1);
        mask = G == 32 ? 0xffffffffu : (((1u << G) - 1) << (wl & ~(G - 1)));
    }
    __device__ __forceinline__ unsigned xor_all(unsigned v) const {
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
            v ^= __shfl_xor_sync(mask, v, o, G);
        return v;
    }
    __device__ __forceinline__ unsigned long long xor_all(
        unsigned long long v) const {
        unsigned lo = xor_all(static_cast<unsigned>(v));
        unsigned hi = xor_all(static_cast<unsigned>(v >> 32));
        return (static_cast<unsigned long long>(hi) << 32) | lo;
    }
    __device__ __forceinline__ int sum(int v) const {
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
            v += __shfl_xor_sync(mask, v, o, G);
        return v;
    }
    __device__ __forceinline__ bool any(bool p) const {
        return (__ballot_sync(mask, p) & mask) != 0;
    }
    __device__ __forceinline__ int up(int v) const {  // lane i <- lane i-1
        return __shfl_up_sync(mask, v, 1, G);
    }
};

// Berlekamp-Massey over iterations START..NS-1 on syndromes s[0..NS-1]
// (BCH: START = 1, s[0] = 0, s[j] = S_j; RS: START = 0, s[j] = S_j), lane
// i < CAP holding sigma_i. Every lane of the group takes part; lanes >= CAP
// hold 0. Returns this lane's sigma_i.
template <int CAP, int NS, int START, int G>
__device__ __forceinline__ int berlekamp_massey(const GfTables& g,
                                                const Group<G>& grp,
                                                const int (&s)[NS]) {
    const int i = grp.lane;
    int sig = i == 0 ? 1 : 0;
    int bx = i == 1 ? 1 : 0;
    int cur = 0;  // s[nn - i], 0 while nn - i < START
    int l = 0;
#pragma unroll
    for (int nn = START; nn < NS; ++nn) {
        cur = grp.up(cur);
        if (i == 0) cur = s[nn];
        int delta = gmul(g, sig, cur);
#pragma unroll
        for (int o = kBmLanes / 2; o > 0; o >>= 1)
            delta ^= __shfl_xor_sync(grp.mask, delta, o, G);
        const bool reset =
            delta != 0 && (START == 1 ? 2 * l < nn : 2 * l <= nn);
        const int below = grp.up(sig);  // sigma_(i-1)
        const int bx_below = grp.up(bx);
        const int nb = i == 0 ? 0 : gmul(g, ginv(g, delta), below);
        if (delta != 0) sig ^= gmul(g, delta, bx);
        bx = reset ? nb : (i == 0 ? 0 : bx_below);
        if (reset) l = START == 1 ? nn - l : nn + 1 - l;
        if (i >= CAP) sig = bx = 0;
    }
    return sig;
}

// sigma's coefficients from the group's scratch into every lane: the log
// of each (lsig) and a mask of the nonzero ones
template <int CAP>
__device__ __forceinline__ unsigned sigma_logs(const GfTables& g,
                                               const uint4& sv,
                                               int (&lsig)[CAP]) {
    unsigned nz = 0;
#pragma unroll
    for (int m = 0; m < CAP; ++m) {
        const int c = byte_of(sv, m);
        lsig[m] = g.log[c];
        if (c != 0) nz |= 1u << m;
    }
    return nz;
}

// Chien over this lane's positions p = lane + G q (q < NQ, p < n): bit q of
// the result is set when sigma(a^-(254-p)) = 0. The term sigma_m a^(-m deg)
// has log lsig_m + m (1 + p) mod 255.
template <int CAP, int NQ, int G>
__device__ __forceinline__ unsigned chien(const GfTables& g, int lane, int n,
                                          const int (&lsig)[CAP],
                                          unsigned nz) {
    int e[CAP];
#pragma unroll
    for (int m = 0; m < CAP; ++m) e[m] = (lsig[m] + m * (1 + lane)) % kOrder;
    unsigned roots = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        int v = 0;
#pragma unroll
        for (int m = 0; m < CAP; ++m) {
            if (nz >> m & 1) v ^= g.exp[e[m]];
            e[m] += (m * G) % kOrder;
            if (e[m] >= kOrder) e[m] -= kOrder;
        }
        if (lane + G * q < n && v == 0) roots |= 1u << q;
    }
    return roots;
}

template <int T, int G>
__global__ void __launch_bounds__(kMaxThreads)
    bch_decode_kernel(const uint8_t* __restrict__ in, int B, int n, int k,
                      const uint8_t* __restrict__ tab,
                      const unsigned long long* __restrict__ words,
                      uint8_t* __restrict__ out, int* __restrict__ ok) {
    constexpr int CAP = T + 2;
    constexpr int NS = 2 * T + 1;  // s[0] = 0, s[j] = S_j
    constexpr int NQ = (kOrder + G - 1) / G;
    __shared__ GfTables g;
    __shared__ Scratch scratch[kMaxThreads / G];
    load_tables(g, tab);
    __syncthreads();
    const Group<G> grp;
    const int gi = threadIdx.x / G;
    const long long row = static_cast<long long>(blockIdx.x) *
                              (blockDim.x / G) + gi;
    if (row >= B) return;
    const uint8_t* r_in = in + row * n;
    int r[NQ];
    unsigned long long acc = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int p = grp.lane + G * q;
        r[q] = p < n ? (r_in[p] & 1) : 0;
        const unsigned long long w = p < n ? __ldg(words + p) : 0ull;
        if (r[q]) acc ^= w;
    }
    acc = grp.xor_all(acc);
    int okv = 1;
    if (acc != 0) {  // odd syndromes all zero <=> all zero; group-uniform
        int s[NS];
        s[0] = 0;
#pragma unroll
        for (int i = 0; i < T; ++i)
            s[2 * i + 1] = static_cast<int>((acc >> (8 * i)) & 0xFF);
#pragma unroll
        for (int j = 2; j < NS; j += 2) s[j] = gmul(g, s[j / 2], s[j / 2]);
        const int sig = berlekamp_massey<CAP, NS, 1>(g, grp, s);
        Scratch& sc = scratch[gi];
        if (grp.lane < 16) sc.sig[grp.lane] = static_cast<uint8_t>(sig);
        __syncwarp(grp.mask);
        int lsig[CAP];
        const unsigned nz = sigma_logs<CAP>(
            g, *reinterpret_cast<const uint4*>(sc.sig), lsig);
        const unsigned roots = chien<CAP, NQ, G>(g, grp.lane, n, lsig, nz);
        unsigned long long fold = 0;
        for (unsigned m = roots; m != 0; m &= m - 1)
            fold ^= __ldg(words + grp.lane + G * (__ffs(m) - 1));
        fold = grp.xor_all(fold);
        const int found = grp.sum(__popc(roots));
        okv = fold == acc && found <= T;
        if (okv) {
#pragma unroll
            for (int q = 0; q < NQ; ++q) r[q] ^= (roots >> q) & 1;
        }
    }
    uint8_t* r_out = out + row * k;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int p = grp.lane + G * q;
        if (p < k) r_out[p] = static_cast<uint8_t>(r[q]);
    }
    if (grp.lane == 0) ok[row] = okv;
}

template <int T, int G>
__global__ void __launch_bounds__(kMaxThreads)
    rs_decode_kernel(const uint8_t* __restrict__ in, int B, int n,
                     const uint8_t* __restrict__ tab,
                     uint8_t* __restrict__ out, int* __restrict__ ok) {
    constexpr int CAP = T + 2;
    constexpr int NP = 2 * T;
    constexpr int NW = (NP + 3) / 4;  // syndrome words (4 bytes each)
    constexpr int NQ = (kOrder + G - 1) / G;
    const int k = n - NP;
    __shared__ GfTables g;
    __shared__ Scratch scratch[kMaxThreads / G];
    const Group<G> grp;
    const int gi = threadIdx.x / G;
    const long long row = static_cast<long long>(blockIdx.x) *
                              (blockDim.x / G) + gi;
    const bool live = row < B;
    // the row's bytes are requested before the tables, so the two
    // round trips to device memory overlap
    const uint8_t* r_in = in + (live ? row : 0) * n;
    int r[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int p = grp.lane + G * q;
        r[q] = live && p < n ? r_in[p] : 0;
    }
    load_tables(g, tab);
    __syncthreads();
    if (!live) return;
    unsigned w[NW];
#pragma unroll
    for (int c = 0; c < NW; ++c) w[c] = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        if (r[q] == 0) continue;
        const int deg = 254 - (grp.lane + G * q);
        int e = g.log[r[q]];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            w[j / 4] ^= static_cast<unsigned>(g.exp[e]) << (8 * (j % 4));
            e += deg;
            if (e >= kOrder) e -= kOrder;
        }
    }
    bool any = false;
#pragma unroll
    for (int c = 0; c < NW; ++c) {
        w[c] = grp.xor_all(w[c]);
        any |= w[c] != 0;
    }
    int okv = 1;
    if (any) {  // group-uniform
        int s[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j)
            s[j] = static_cast<int>((w[j / 4] >> (8 * (j % 4))) & 0xFF);
        const int sig = berlekamp_massey<CAP, NP, 0>(g, grp, s);
        const unsigned nzl = __ballot_sync(grp.mask, sig != 0) & grp.mask;
        const int sdeg = 31 - __clz(nzl >> (threadIdx.x & 31 & ~(G - 1)));
        Scratch& sc = scratch[gi];
        if (grp.lane < 16) sc.sig[grp.lane] = static_cast<uint8_t>(sig);
        if (grp.lane == 0) {
            uint4 sv = make_uint4(0, 0, 0, 0);
            sv.x = w[0];
            if (NW > 1) sv.y = w[NW > 1 ? 1 : 0];
            if (NW > 2) sv.z = w[NW > 2 ? 2 : 0];
            if (NW > 3) sv.w = w[NW > 3 ? 3 : 0];
            *reinterpret_cast<uint4*>(sc.s) = sv;
        }
        __syncwarp(grp.mask);
        const uint4 sv = *reinterpret_cast<const uint4*>(sc.sig);
        int lsig[CAP];
        const unsigned nz = sigma_logs<CAP>(g, sv, lsig);
        // Omega = S sigma mod x^2t, coefficient i on lane i
        if (grp.lane < NP) {
            int om = 0;
#pragma unroll
            for (int j = 0; j < CAP; ++j)
                if (j <= grp.lane)
                    om ^= gmul(g, byte_of(sv, j), sc.s[grp.lane - j]);
            sc.om[grp.lane] = static_cast<uint8_t>(om);
        }
        __syncwarp(grp.mask);
        const uint4 ov = *reinterpret_cast<const uint4*>(sc.om);
        const unsigned roots = chien<CAP, NQ, G>(g, grp.lane, n, lsig, nz);
        // Forney and the residual fold, one root at a time on its lane
        unsigned long long mag_lo = 0, mag_hi = 0;  // byte q: magnitude
        unsigned rw[NW];
#pragma unroll
        for (int c = 0; c < NW; ++c) rw[c] = 0;
        bool bad_dv = false;
        for (unsigned m = roots; m != 0; m &= m - 1) {
            const int q = __ffs(m) - 1;
            const int d = 254 - (grp.lane + G * q);
            const int step = kOrder - d;  // log of a^-d
            int om = 0, dv = 0, xm = 0;   // xm: log of a^(-m d)
#pragma unroll
            for (int mm = 0; mm < NP; ++mm) {
                const int oc = byte_of(ov, mm);
                if (oc != 0) om ^= g.exp[g.log[oc] + xm];
                if (mm + 1 < CAP && (mm & 1) == 0 && (nz >> (mm + 1) & 1))
                    dv ^= g.exp[lsig[mm + 1] + xm];
                xm += step;
                if (xm >= kOrder) xm -= kOrder;
            }
            bad_dv |= dv == 0;
            const int me = gmul(g, g.exp[d], gmul(g, om, ginv(g, dv)));
            if (q < 8)
                mag_lo |= static_cast<unsigned long long>(me) << (8 * q);
            else
                mag_hi |= static_cast<unsigned long long>(me) << (8 * (q - 8));
            if (me != 0) {
                int ee = g.log[me];
#pragma unroll
                for (int j = 0; j < NP; ++j) {
                    rw[j / 4] ^= static_cast<unsigned>(g.exp[ee])
                                 << (8 * (j % 4));
                    ee += d;
                    if (ee >= kOrder) ee -= kOrder;
                }
            }
        }
        bool resid_ok = true;
#pragma unroll
        for (int c = 0; c < NW; ++c) resid_ok &= grp.xor_all(rw[c]) == w[c];
        bad_dv = grp.any(bad_dv);
        const int n_err = grp.sum(__popc(roots));
        okv = resid_ok && !bad_dv && n_err == sdeg && sdeg <= T;
        if (okv) {
#pragma unroll
            for (int q = 0; q < NQ; ++q)
                r[q] ^= static_cast<int>(
                    ((q < 8 ? mag_lo >> (8 * q) : mag_hi >> (8 * (q - 8)))) &
                    0xFF);
        }
    }
    uint8_t* r_out = out + row * k;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int p = grp.lane + G * q;
        if (p < k) r_out[p] = static_cast<uint8_t>(r[q]);
    }
    if (grp.lane == 0) ok[row] = okv;
}

// a launch of `groups` codewords a block, G lanes each
bool plan_ok(int lanes, int groups) {
    return (lanes == 16 || lanes == 32) && groups >= 1 &&
           lanes * groups <= kMaxThreads && (lanes * groups) % 32 == 0;
}

}  // namespace

// BCH(n, k, t) decode of B codewords of n bits (one byte a bit, masked to
// its low bit): out (B, k) message bits, ok (B,) flags. 1 <= t <= 8,
// k < n <= 255. tables: exp[512] then log[256], 16-byte aligned; words:
// n 64-bit syndrome words (byte i of word p = a^((2i+1)(254-p)), i < t).
// `lanes` (16 or 32) lanes a codeword, `groups` codewords a block
// (lanes x groups a multiple of 32, at most 256). Returns a cudaError_t
// code (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int outer_bch_decode(const uint8_t* in, int B, int n, int k, int t,
                                const uint8_t* tables,
                                const unsigned long long* words, int lanes,
                                int groups, uint8_t* out, int* ok,
                                void* stream) {
    if (t < 1 || t > 8 || n > 255 || k <= 0 || k >= n || B < 0 ||
        !plan_ok(lanes, groups))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int grid = (B + groups - 1) / groups;
    const int threads = lanes * groups;
#define ORION_BCH_CASE(TT)                                                  \
    case TT:                                                                \
        if (lanes == 16)                                                    \
            bch_decode_kernel<TT, 16><<<grid, threads, 0, st>>>(            \
                in, B, n, k, tables, words, out, ok);                       \
        else                                                                \
            bch_decode_kernel<TT, 32><<<grid, threads, 0, st>>>(            \
                in, B, n, k, tables, words, out, ok);                       \
        break;
    switch (t) {
        ORION_BCH_CASE(1) ORION_BCH_CASE(2) ORION_BCH_CASE(3) ORION_BCH_CASE(4)
        ORION_BCH_CASE(5) ORION_BCH_CASE(6) ORION_BCH_CASE(7) ORION_BCH_CASE(8)
    }
#undef ORION_BCH_CASE
    return static_cast<int>(cudaGetLastError());
}

// RS(n, n - n_parity) decode of B codewords of n bytes: out (B, k) message
// bytes, ok (B,) flags. n_parity even, 2..16; n_parity < n <= 255. tables,
// lanes and groups as for outer_bch_decode. Returns a cudaError_t code.
extern "C" int outer_rs_decode(const uint8_t* in, int B, int n, int n_parity,
                               const uint8_t* tables, int lanes, int groups,
                               uint8_t* out, int* ok, void* stream) {
    if (n_parity < 2 || n_parity > 16 || (n_parity & 1) || n > 255 ||
        n_parity >= n || B < 0 || !plan_ok(lanes, groups))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int grid = (B + groups - 1) / groups;
    const int threads = lanes * groups;
#define ORION_RS_CASE(TT)                                                   \
    case TT:                                                                \
        if (lanes == 16)                                                    \
            rs_decode_kernel<TT, 16><<<grid, threads, 0, st>>>(             \
                in, B, n, tables, out, ok);                                 \
        else                                                                \
            rs_decode_kernel<TT, 32><<<grid, threads, 0, st>>>(             \
                in, B, n, tables, out, ok);                                 \
        break;
    switch (n_parity / 2) {
        ORION_RS_CASE(1) ORION_RS_CASE(2) ORION_RS_CASE(3) ORION_RS_CASE(4)
        ORION_RS_CASE(5) ORION_RS_CASE(6) ORION_RS_CASE(7) ORION_RS_CASE(8)
    }
#undef ORION_RS_CASE
    return static_cast<int>(cudaGetLastError());
}
