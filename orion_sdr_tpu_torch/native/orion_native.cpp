// Native batch decoders for the byte/bit-domain algebraic codes
// (GF(2^8) Reed-Solomon and binary BCH) — the host-side hot loops of the
// DVB-T/COFDM receive chains. Mirrors orion_sdr_tpu/fec/galois.py exactly
// (behavioral spec: reference src/fec/{gf,bch,reed_solomon}.rs): primitive
// polynomial 0x11D, RS FCR = 0, BCH syndromes α^1..α^2t, shortened codes at
// the high end of the 255-frame. Per-codeword decode is sequential
// (BM + Chien + Forney); the batch loop is the parallel axis.
//
// Perf layout (v2): every hot loop is branchless table algebra over a
// 64 KB full GF multiplication table — syndromes run Horner with a per-root
// row pointer (acc = MUL[α^j][acc] ^ r[p]; 2 L1 ops/byte, no modulo, no
// zero-test), the Chien search steps per-coefficient rows instead of
// re-evaluating σ, and binary-BCH even syndromes come from S_{2j} = S_j²
// (frobenius), halving the syndrome work. The v1 code computed
// exp[(j·deg) % 255] per nonzero byte — an integer divide in the innermost
// loop, which measured BELOW the reference's single-core Rust.
//
// C ABI for ctypes. Build: g++ -O3 -shared -fPIC (see native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Codewords are independent → split the batch across hardware threads.
// (The reference is single-core by design; this is the native runtime's
// free parallel axis — a no-op on a 1-core host.) Small batches stay
// single-threaded: spawn cost would dominate.
void parallel_rows(int batch, const std::function<void(int, int)>& fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int nt = (int)std::min<unsigned>(hw ? hw : 1u, 16u);
    nt = std::min(nt, batch / 32);
    if (nt <= 1) {
        fn(0, batch);
        return;
    }
    std::vector<std::thread> pool;
    int per = (batch + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int lo = t * per, hi = std::min(batch, lo + per);
        if (lo >= hi) break;
        pool.emplace_back(fn, lo, hi);
    }
    for (auto& th : pool) th.join();
}

constexpr int PRIM = 0x11D;
constexpr int ORDER = 255;

struct Tables {
    uint8_t exp[512];
    uint8_t log[256];
    // full multiplication table: MUL[a][b] = a·b in GF(2^8). 64 KB; the hot
    // loops touch only the ~2t rows MUL[α^j], which stay L1-resident.
    uint8_t mul[256][256];
    Tables() {
        int x = 1;
        for (int i = 0; i < ORDER; ++i) {
            exp[i] = (uint8_t)x;
            log[x] = (uint8_t)i;
            x <<= 1;
            if (x & 0x100) x ^= PRIM;
        }
        for (int i = ORDER; i < 510; ++i) exp[i] = exp[i - ORDER];
        exp[510] = exp[511] = 0;
        log[0] = 0;
        for (int a = 0; a < 256; ++a) {
            mul[0][a] = mul[a][0] = 0;
        }
        for (int a = 1; a < 256; ++a)
            for (int b = 1; b < 256; ++b)
                mul[a][b] = exp[log[a] + log[b]];
    }
};
const Tables GF;

inline uint8_t gmul(uint8_t a, uint8_t b) { return GF.mul[a][b]; }

inline uint8_t ginv(uint8_t a) { return GF.exp[ORDER - GF.log[a]]; }

// row pointer for multiply-by-constant: y = MROW(c)[x]
inline const uint8_t* MROW(uint8_t c) { return GF.mul[c]; }

// α^e for any non-negative e
inline uint8_t apow(long e) { return GF.exp[e % ORDER]; }

// Berlekamp–Massey. start = 0 (RS: s[0..2t-1]) or 1 (BCH: s[1..2t]).
// s has length 2t+start. sigma out is low-degree-first, length <= t+1.
int berlekamp_massey(const uint8_t* s, int t, int start, uint8_t* sigma_out,
                     int cap) {
    std::vector<uint8_t> sigma(cap, 0), b(cap, 0), tmp(cap, 0);
    sigma[0] = 1;
    b[0] = 1;
    int l = 0, m = 1;
    int n_lo = start == 1 ? 1 : 0;
    int n_hi = start == 1 ? 2 * t + 1 : 2 * t;
    for (int n = n_lo; n < n_hi; ++n) {
        int delta = s[n];
        for (int i = 1; i <= l && i < cap; ++i)
            delta ^= gmul(sigma[i], s[n - i]);
        bool cond = start == 1 ? (2 * l < n) : (2 * l <= n);
        if (delta == 0) {
            ++m;
        } else if (cond) {
            tmp = sigma;
            const uint8_t* md = MROW((uint8_t)delta);
            for (int i = 0; i + m < cap; ++i) sigma[i + m] ^= md[b[i]];
            l = start == 1 ? (n - l) : (n + 1 - l);
            const uint8_t* mi = MROW(ginv((uint8_t)delta));
            for (int i = 0; i < cap; ++i) b[i] = mi[tmp[i]];
            m = 1;
        } else {
            const uint8_t* md = MROW((uint8_t)delta);
            for (int i = 0; i + m < cap; ++i) sigma[i + m] ^= md[b[i]];
            ++m;
        }
    }
    std::memcpy(sigma_out, sigma.data(), cap);
    int deg = 0;
    for (int i = 0; i < cap; ++i)
        if (sigma_out[i]) deg = i;
    return deg;
}

inline uint8_t poly_eval(const uint8_t* p, int len, uint8_t x) {
    uint8_t acc = 0;
    const uint8_t* mx = MROW(x);
    for (int i = len - 1; i >= 0; --i) acc = (uint8_t)(mx[acc] ^ p[i]);
    return acc;
}

// S_j = Σ_p r[p]·α^{j·deg(p)}, deg(p) = n-1-p+shift — as Horner with the
// MUL[α^j] row (branchless, 2 L1 loads/byte) then one α^{j·shift} twist.
// All 2t accumulator chains advance interleaved in ONE pass over the bytes:
// a single Horner chain is a serial string of dependent L1 loads
// (latency-bound at ~5 cycles/byte); 2t independent chains pipeline to the
// load-port limit instead.
constexpr int MAX_SYN = 64;

void rs_syndromes_all(const uint8_t* r, int n, int shift, int n_parity,
                      uint8_t* s) {
    uint8_t acc[MAX_SYN] = {0};
    const uint8_t* rows[MAX_SYN];
    for (int j = 0; j < n_parity; ++j) rows[j] = MROW(apow(j));
    for (int p = 0; p < n; ++p) {
        uint8_t rp = r[p];
        for (int j = 0; j < n_parity; ++j)
            acc[j] = (uint8_t)(rows[j][acc[j]] ^ rp);
    }
    for (int j = 0; j < n_parity; ++j)
        s[j] = gmul(acc[j], apow((long)j * shift));
}

// binary-input variant (bits 0/1 in bytes); computes the ODD syndromes
// s[1], s[3], … s[2t-1] only (evens are frobenius squares of these).
// Bit-sliced for t ≤ 8: the 8 odd syndromes pack into ONE uint64 word per
// position (byte i of W64[p] = α^{(2i+1)·deg(p)}), so the whole syndrome
// pass is one branchless masked-XOR per bit — S_j = Σ_p bit_p·α^{j·deg(p)}
// needs no Horner and no shift twist.
void bch_syndromes_odd(const uint8_t* r, int n, int shift, int t,
                       uint8_t* s, const uint64_t* w64) {
    if (t <= 8 && w64) {
        uint64_t acc = 0;
        for (int p = 0; p < n; ++p)
            acc ^= w64[p] & (uint64_t)(-(int64_t)(r[p] & 1));
        for (int i = 0; i < t; ++i)
            s[2 * i + 1] = (uint8_t)(acc >> (8 * i));
        return;
    }
    uint8_t accs[MAX_SYN] = {0};
    const uint8_t* rows[MAX_SYN];
    for (int i = 0; i < t; ++i) rows[i] = MROW(apow(2 * i + 1));
    for (int p = 0; p < n; ++p) {
        uint8_t rp = (uint8_t)(r[p] & 1);
        for (int i = 0; i < t; ++i)
            accs[i] = (uint8_t)(rows[i][accs[i]] ^ rp);
    }
    for (int i = 0; i < t; ++i) {
        int j = 2 * i + 1;
        s[j] = gmul(accs[i], apow((long)j * shift));
    }
}

}  // namespace

extern "C" {

// RS(n, k = n - n_parity) decode of `batch` codewords. in: batch×n bytes,
// out: batch×k bytes, ok: batch flags (1 = decoded, 0 = uncorrectable —
// out row then holds the systematic prefix, matching the Python fallback).
void rs_decode_batch(int n, int n_parity, const uint8_t* in, int batch,
                     uint8_t* out, uint8_t* ok) {
    const int k = n - n_parity;
    const int t = n_parity / 2;
    const int shift = ORDER - n;
    const int cap = t + 2;

    // fixed-size fast-path buffers (acc[MAX_SYN], ch[4][40]) bound the
    // supported code sizes; the Python wrapper falls back to numpy beyond
    if (n_parity > MAX_SYN || t + 2 > 40) {
        for (int bi = 0; bi < batch; ++bi) {
            std::memcpy(out + (size_t)bi * k, in + (size_t)bi * n, k);
            ok[bi] = 0;
        }
        return;
    }

    parallel_rows(batch, [=](int row_lo, int row_hi) {
    std::vector<uint8_t> s(n_parity), sigma(cap), omega(n_parity),
        deriv(cap), word(n);

    for (int bi = row_lo; bi < row_hi; ++bi) {
        const uint8_t* r = in + (size_t)bi * n;
        uint8_t* o = out + (size_t)bi * k;
        std::memcpy(o, r, k);
        ok[bi] = 0;

        rs_syndromes_all(r, n, shift, n_parity, s.data());
        bool any = false;
        for (int j = 0; j < n_parity; ++j) any |= s[j] != 0;
        if (!any) {
            ok[bi] = 1;
            continue;
        }

        std::fill(sigma.begin(), sigma.end(), 0);
        int sdeg = berlekamp_massey(s.data(), t, 0, sigma.data(), cap);
        if (sdeg > t) continue;

        // Chien restricted to the valid degree window [shift, n-1+shift]
        // (roots below it can't be corrected and fail the count either
        // way), stepping σ's terms c_m = σ_m·α^{-m·i} with FOUR independent
        // interleaved chains (strides of 4 positions) — one chain is a
        // serial string of dependent L1 loads; four pipeline. Early exit
        // once all sdeg roots are found (a degree-sdeg σ has no more).
        int err_deg[64];
        int n_err = 0;
        uint8_t ch[4][40];
        for (int kk = 0; kk < 4; ++kk)
            for (int m = 0; m <= sdeg; ++m)
                ch[kk][m] = gmul(sigma[m], apow((long)(ORDER - m) *
                                                (shift + kk) % ORDER));
        const uint8_t* step[40];
        for (int m = 1; m <= sdeg; ++m)
            step[m] = MROW(apow((long)(ORDER - m) * 4 % ORDER));
        bool over = false;
        for (int i = shift; i < ORDER && n_err < sdeg; i += 4) {
            uint8_t v0 = 0, v1 = 0, v2 = 0, v3 = 0;
            for (int m = 0; m <= sdeg; ++m) {
                v0 ^= ch[0][m];
                v1 ^= ch[1][m];
                v2 ^= ch[2][m];
                v3 ^= ch[3][m];
            }
            const uint8_t vs[4] = {v0, v1, v2, v3};
            for (int kk = 0; kk < 4; ++kk)
                if (vs[kk] == 0 && i + kk < ORDER) {
                    if (n_err >= sdeg) { over = true; break; }
                    err_deg[n_err++] = i + kk;
                }
            for (int m = 1; m <= sdeg; ++m) {
                const uint8_t* sm = step[m];
                ch[0][m] = sm[ch[0][m]];
                ch[1][m] = sm[ch[1][m]];
                ch[2][m] = sm[ch[2][m]];
                ch[3][m] = sm[ch[3][m]];
            }
        }
        if (over || n_err != sdeg) continue;

        // Forney: Ω = S·σ mod x^(2t); σ' = odd terms
        std::fill(omega.begin(), omega.end(), 0);
        for (int i = 0; i < n_parity; ++i)
            if (s[i]) {
                const uint8_t* ms = MROW(s[i]);
                for (int j = 0; j <= sdeg && i + j < n_parity; ++j)
                    omega[i + j] ^= ms[sigma[j]];
            }
        std::fill(deriv.begin(), deriv.end(), 0);
        for (int kk = 1; kk <= sdeg; kk += 2) deriv[kk - 1] = sigma[kk];

        std::memcpy(word.data(), r, n);
        bool bad = false;
        for (int e = 0; e < n_err; ++e) {
            int i = err_deg[e];
            uint8_t x = apow(i);
            uint8_t x_inv = ginv(x);
            uint8_t ov = poly_eval(omega.data(), n_parity, x_inv);
            uint8_t dv = poly_eval(deriv.data(), sdeg > 0 ? sdeg : 1, x_inv);
            if (dv == 0) { bad = true; break; }
            uint8_t mag = gmul(x, gmul(ov, ginv(dv)));
            if (shift <= i && i <= n - 1 + shift)
                word[n - 1 + shift - i] ^= mag;
        }
        if (bad) continue;

        // residual check on the corrected word
        rs_syndromes_all(word.data(), n, shift, n_parity, s.data());
        bool resid = false;
        for (int j = 0; j < n_parity; ++j) resid |= s[j] != 0;
        if (resid) continue;
        std::memcpy(o, word.data(), k);
        ok[bi] = 1;
    }
    });
}

// Binary BCH(n, k, t) decode of `batch` codewords of n BITS (one byte per
// bit, 0/1). parity_bits = n - k is derived by the caller; out: batch×k bits.
void bch_decode_batch(int n, int k, int t, const uint8_t* in, int batch,
                      uint8_t* out, uint8_t* ok) {
    const int shift = ORDER - n;
    const int cap = t + 2;

    // bit-sliced syndrome table (t <= 8): byte i of w64[p] = α^{(2i+1)·deg(p)}
    std::vector<uint64_t> w64;
    if (t <= 8) {
        w64.resize(n);
        for (int p = 0; p < n; ++p) {
            long deg = n - 1 - p + shift;
            uint64_t w = 0;
            for (int i = 0; i < t; ++i)
                w |= (uint64_t)apow((long)(2 * i + 1) * deg) << (8 * i);
            w64[p] = w;
        }
    }
    const uint64_t* w64p = w64.empty() ? nullptr : w64.data();

    if (2 * t + 1 > MAX_SYN || cap > 40) {
        for (int bi = 0; bi < batch; ++bi) {
            for (int i = 0; i < k; ++i)
                out[(size_t)bi * k + i] = in[(size_t)bi * n + i] & 1;
            ok[bi] = 0;
        }
        return;
    }

    parallel_rows(batch, [=](int row_lo, int row_hi) {
    std::vector<uint8_t> s(2 * t + 1), sigma(cap), word(n);

    for (int bi = row_lo; bi < row_hi; ++bi) {
        const uint8_t* r = in + (size_t)bi * n;
        uint8_t* o = out + (size_t)bi * k;
        for (int i = 0; i < k; ++i) o[i] = r[i] & 1;
        ok[bi] = 0;

        // odd syndromes (bit-sliced); even by frobenius S_{2j} = S_j²
        bch_syndromes_odd(r, n, shift, t, s.data(), w64p);
        bool any = false;
        for (int j = 1; j <= 2 * t; j += 2) any |= s[j] != 0;
        for (int j = 2; j <= 2 * t; j += 2) {
            s[j] = gmul(s[j / 2], s[j / 2]);
            any |= s[j] != 0;
        }
        if (!any) {
            ok[bi] = 1;
            continue;
        }

        std::fill(sigma.begin(), sigma.end(), 0);
        int sdeg = berlekamp_massey(s.data(), t, 1, sigma.data(), cap);

        for (int i = 0; i < n; ++i) word[i] = r[i] & 1;
        // Chien over the valid window only, 4 interleaved stride chains
        // (see the RS decoder above), early exit at sdeg roots.
        int n_found = 0;
        uint8_t ch[4][40];
        for (int kk = 0; kk < 4; ++kk)
            for (int m = 0; m < cap; ++m)
                ch[kk][m] = gmul(sigma[m], apow((long)(ORDER - m) *
                                                (shift + kk) % ORDER));
        const uint8_t* step[40];
        for (int m = 1; m < cap; ++m)
            step[m] = MROW(apow((long)(ORDER - m) * 4 % ORDER));
        for (int d = shift; d < ORDER && n_found < sdeg; d += 4) {
            uint8_t v0 = 0, v1 = 0, v2 = 0, v3 = 0;
            for (int m = 0; m < cap; ++m) {
                v0 ^= ch[0][m];
                v1 ^= ch[1][m];
                v2 ^= ch[2][m];
                v3 ^= ch[3][m];
            }
            const uint8_t vs[4] = {v0, v1, v2, v3};
            for (int kk = 0; kk < 4; ++kk)
                if (vs[kk] == 0 && d + kk <= n - 1 + shift) {
                    int p = n - 1 + shift - (d + kk);
                    if (p >= 0 && p < n) {
                        word[p] ^= 1;
                        ++n_found;
                    }
                }
            for (int m = 1; m < cap; ++m) {
                const uint8_t* sm = step[m];
                ch[0][m] = sm[ch[0][m]];
                ch[1][m] = sm[ch[1][m]];
                ch[2][m] = sm[ch[2][m]];
                ch[3][m] = sm[ch[3][m]];
            }
        }

        // odd syndromes zero ⟺ all zero (evens are frobenius squares)
        bch_syndromes_odd(word.data(), n, shift, t, s.data(), w64p);
        bool resid = false;
        for (int j = 1; j <= 2 * t; j += 2) resid |= s[j] != 0;
        if (resid || n_found > t) continue;
        for (int i = 0; i < k; ++i) o[i] = word[i];
        ok[bi] = 1;
    }
    });
}

// ── batch encoders (round 3: the TX side must clear the Rust baseline;
// the numpy LFSRs measured 0.1-0.5x it) ──────────────────────────────────

// systematic RS encode, FCR=0 generator (matches fec/galois.py::_rs_generator
// + ReedSolomon.encode's LFSR bit-exactly)
void rs_encode_batch(int n, int n_parity, const uint8_t* in, int batch,
                     uint8_t* out) {
    int k = n - n_parity;
    // generator Π(x + α^i), i = 0..n_parity-1, built low-degree-first
    std::vector<uint8_t> g(n_parity + 1, 0);
    g[0] = 1;
    int deg = 0;
    for (int i = 0; i < n_parity; ++i) {
        std::vector<uint8_t> ng(n_parity + 1, 0);
        uint8_t ai = apow(i);
        for (int j = 0; j <= deg; ++j) {
            ng[j + 1] = (uint8_t)(ng[j + 1] ^ g[j]);
            ng[j] = (uint8_t)(ng[j] ^ gmul(ai, g[j]));
        }
        g.swap(ng);
        ++deg;
    }
    std::vector<uint8_t> genhi(n_parity);        // high-degree-first taps
    for (int j = 0; j < n_parity; ++j) genhi[j] = g[n_parity - 1 - j];
    if (n_parity <= 16) {
        // CRC-style table LFSR: the whole parity register lives in two
        // uint64s (byte p holds reg[n_parity-1-p]) and one step is
        // R = (R << 8) ^ T[fb], with T[fb] byte p = fb·g[p] — a 4 KB
        // L1-resident table replacing n_parity dependent MUL-row loads.
        // Two codewords interleave to pipeline the fb→T load chain.
        uint64_t T_hi[256], T_lo[256];
        for (int v = 0; v < 256; ++v) {
            uint64_t hi = 0, lo = 0;
            const uint8_t* mv = MROW((uint8_t)v);
            for (int pos = 0; pos < n_parity; ++pos) {
                uint64_t byte = mv[g[pos]];
                if (pos < 8) lo |= byte << (8 * pos);
                else hi |= byte << (8 * (pos - 8));
            }
            T_hi[v] = hi;
            T_lo[v] = lo;
        }
        int topshift = 8 * ((n_parity - 1) & 7);
        bool wide = n_parity > 8;                 // top byte lives in hi
        parallel_rows(batch, [&](int lo_b, int hi_b) {
            int b = lo_b;
            for (; b + 2 <= hi_b; b += 2) {
                const uint8_t* m0 = in + (size_t)b * k;
                const uint8_t* m1 = in + (size_t)(b + 1) * k;
                uint8_t* o0 = out + (size_t)b * n;
                uint8_t* o1 = out + (size_t)(b + 1) * n;
                std::memcpy(o0, m0, k);
                std::memcpy(o1, m1, k);
                uint64_t h0 = 0, l0 = 0, h1 = 0, l1 = 0;
                for (int i = 0; i < k; ++i) {
                    uint8_t f0 = (uint8_t)(m0[i]
                        ^ (uint8_t)((wide ? h0 : l0) >> topshift));
                    uint8_t f1 = (uint8_t)(m1[i]
                        ^ (uint8_t)((wide ? h1 : l1) >> topshift));
                    h0 = ((h0 << 8) | (l0 >> 56)) ^ T_hi[f0];
                    l0 = (l0 << 8) ^ T_lo[f0];
                    h1 = ((h1 << 8) | (l1 >> 56)) ^ T_hi[f1];
                    l1 = (l1 << 8) ^ T_lo[f1];
                }
                for (int j = 0; j < n_parity; ++j) {
                    int pos = n_parity - 1 - j;
                    o0[k + j] = (uint8_t)((pos < 8 ? l0 : h0)
                                          >> (8 * (pos & 7)));
                    o1[k + j] = (uint8_t)((pos < 8 ? l1 : h1)
                                          >> (8 * (pos & 7)));
                }
            }
            for (; b < hi_b; ++b) {
                const uint8_t* m0 = in + (size_t)b * k;
                uint8_t* o0 = out + (size_t)b * n;
                std::memcpy(o0, m0, k);
                uint64_t h0 = 0, l0 = 0;
                for (int i = 0; i < k; ++i) {
                    uint8_t f0 = (uint8_t)(m0[i]
                        ^ (uint8_t)((wide ? h0 : l0) >> topshift));
                    h0 = ((h0 << 8) | (l0 >> 56)) ^ T_hi[f0];
                    l0 = (l0 << 8) ^ T_lo[f0];
                }
                for (int j = 0; j < n_parity; ++j) {
                    int pos = n_parity - 1 - j;
                    o0[k + j] = (uint8_t)((pos < 8 ? l0 : h0)
                                          >> (8 * (pos & 7)));
                }
            }
        });
        return;
    }
    // 4 codewords advance interleaved per iteration: one LFSR chain is a
    // serial string of dependent L1 loads (fb → MUL row → reg[0] → next
    // fb); four independent chains pipeline to the load-port limit (the
    // same trick as rs_syndromes_all).
    constexpr int LANES = 4;
    parallel_rows(batch, [&](int lo, int hi) {
        std::vector<uint8_t> reg(LANES * 64);
        int b = lo;
        for (; b + LANES <= hi; b += LANES) {
            const uint8_t* msg[LANES];
            uint8_t* o[LANES];
            for (int l = 0; l < LANES; ++l) {
                msg[l] = in + (size_t)(b + l) * k;
                o[l] = out + (size_t)(b + l) * n;
                std::memcpy(o[l], msg[l], k);
            }
            std::fill(reg.begin(), reg.end(), 0);
            for (int i = 0; i < k; ++i) {
                const uint8_t* mr[LANES];
                for (int l = 0; l < LANES; ++l)
                    mr[l] = MROW((uint8_t)(msg[l][i] ^ reg[l * 64]));
                for (int j = 0; j + 1 < n_parity; ++j)
                    for (int l = 0; l < LANES; ++l)
                        reg[l * 64 + j] = (uint8_t)(reg[l * 64 + j + 1]
                                                    ^ mr[l][genhi[j]]);
                for (int l = 0; l < LANES; ++l)
                    reg[l * 64 + n_parity - 1] = mr[l][genhi[n_parity - 1]];
            }
            for (int l = 0; l < LANES; ++l)
                std::memcpy(o[l] + k, reg.data() + l * 64, n_parity);
        }
        for (; b < hi; ++b) {                        // remainder rows
            const uint8_t* msg = in + (size_t)b * k;
            uint8_t* o = out + (size_t)b * n;
            std::memcpy(o, msg, k);
            std::fill(reg.begin(), reg.begin() + 64, 0);
            for (int i = 0; i < k; ++i) {
                uint8_t fb = (uint8_t)(msg[i] ^ reg[0]);
                const uint8_t* mr = MROW(fb);
                for (int j = 0; j + 1 < n_parity; ++j)
                    reg[j] = (uint8_t)(reg[j + 1] ^ mr[genhi[j]]);
                reg[n_parity - 1] = mr[genhi[n_parity - 1]];
            }
            std::memcpy(o + k, reg.data(), n_parity);
        }
    });
}

// binary BCH generator g(x) = lcm of minimal polys of α^1..α^2t, MSB-first
// (matches fec/galois.py::_bch_generator); returns parity bit count, fills
// gen_bits[0..parity] MSB-first
int bch_generator(int t, uint8_t* gen_bits, int cap) {
    std::vector<uint8_t> g(1, 1);                // low-first, GF(256) coeffs
    bool used[256] = {false};
    for (int j = 1; j <= 2 * t; ++j) {
        // cyclotomic coset of j mod 255
        std::vector<int> coset;
        int r = j;
        while (std::find(coset.begin(), coset.end(), r) == coset.end()) {
            coset.push_back(r);
            r = (r * 2) % 255;
        }
        int key = *std::min_element(coset.begin(), coset.end());
        if (used[key]) continue;
        used[key] = true;
        std::vector<uint8_t> minp(1, 1);
        for (int rr : coset) {
            std::vector<uint8_t> nm(minp.size() + 1, 0);
            uint8_t ar = GF.exp[rr % ORDER];
            for (size_t q = 0; q < minp.size(); ++q) {
                nm[q + 1] = (uint8_t)(nm[q + 1] ^ minp[q]);
                nm[q] = (uint8_t)(nm[q] ^ gmul(ar, minp[q]));
            }
            minp.swap(nm);
        }
        std::vector<uint8_t> ng(g.size() + minp.size() - 1, 0);
        for (size_t a = 0; a < g.size(); ++a)
            for (size_t c = 0; c < minp.size(); ++c)
                ng[a + c] = (uint8_t)(ng[a + c] ^ gmul(g[a], minp[c]));
        g.swap(ng);
    }
    int parity = (int)g.size() - 1;
    if (parity + 1 > cap) return -1;
    for (int i = 0; i <= parity; ++i)            // low-first → MSB-first
        gen_bits[i] = (uint8_t)(g[parity - i] & 1);
    return parity;
}

// systematic binary BCH encode (bit in/out), matching Bch.encode's LFSR.
// parity <= 64 runs the uint64 register fast path (t=8 → exactly 64).
void bch_encode_batch(int n, int k, int t, const uint8_t* in, int batch,
                      uint8_t* out) {
    uint8_t gen_bits[256];
    int parity = bch_generator(t, gen_bits, 256);
    if (parity < 0 || k + parity != n) return;   // caller validates shapes
    if (parity <= 64) {
        // gtail mask: bit (parity-1-j) holds gen coefficient j+1 (MSB-first
        // tail), so reg's MSB is the LFSR's reg[0]
        uint64_t mask = 0;
        for (int j = 1; j <= parity; ++j)
            if (gen_bits[j]) mask |= 1ull << (parity - j);
        int top = parity - 1;
        // The LFSR is linear over GF(2), so parity(m) = XOR_i m_i·R[i]
        // where R[i] is the register a lone 1 at step i leaves after the
        // remaining k-1-i zero-input steps. Precomputing R deletes the
        // serial reg dependency — each codeword is k independent masked
        // XORs split over 4 accumulators (was a k-step dependent chain;
        // measured ~15× on the t=8 shortened code the frame chain uses).
        uint64_t top_bit = 1ull << top;
        uint64_t pmask = parity < 64 ? (1ull << parity) - 1 : ~0ull;
        std::vector<uint64_t> R((size_t)k);
        uint64_t r = mask & pmask;
        R[k - 1] = r;
        for (int i = k - 2; i >= 0; --i) {
            uint64_t fb = (r & top_bit) ? mask : 0ull;
            r = ((r << 1) ^ fb) & pmask;
            R[i] = r;
        }
        const uint64_t* Rp = R.data();
        parallel_rows(batch, [&](int lo, int hi) {
            for (int b = lo; b < hi; ++b) {
                const uint8_t* msg = in + (size_t)b * k;
                uint8_t* o = out + (size_t)b * n;
                std::memcpy(o, msg, k);
                uint64_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
                int i = 0;
                for (; i + 4 <= k; i += 4) {
                    a0 ^= (uint64_t)(-(int64_t)(msg[i] & 1)) & Rp[i];
                    a1 ^= (uint64_t)(-(int64_t)(msg[i + 1] & 1)) & Rp[i + 1];
                    a2 ^= (uint64_t)(-(int64_t)(msg[i + 2] & 1)) & Rp[i + 2];
                    a3 ^= (uint64_t)(-(int64_t)(msg[i + 3] & 1)) & Rp[i + 3];
                }
                for (; i < k; ++i)
                    a0 ^= (uint64_t)(-(int64_t)(msg[i] & 1)) & Rp[i];
                uint64_t reg = (a0 ^ a1) ^ (a2 ^ a3);
                for (int j = 0; j < parity; ++j)
                    o[k + j] = (uint8_t)((reg >> (top - j)) & 1ull);
            }
        });
        return;
    }
    parallel_rows(batch, [&](int lo, int hi) {
        std::vector<uint8_t> reg(parity);
        for (int b = lo; b < hi; ++b) {
            const uint8_t* msg = in + (size_t)b * k;
            uint8_t* o = out + (size_t)b * n;
            std::memcpy(o, msg, k);
            std::fill(reg.begin(), reg.end(), 0);
            for (int i = 0; i < k; ++i) {
                uint8_t fb = (uint8_t)((msg[i] ^ reg[0]) & 1);
                for (int j = 0; j + 1 < parity; ++j)
                    reg[j] = (uint8_t)(reg[j + 1] ^ (gen_bits[j + 1] & fb));
                reg[parity - 1] = (uint8_t)(gen_bits[parity] & fb);
            }
            std::memcpy(o + k, reg.data(), parity);
        }
    });
}

}  // extern "C"
