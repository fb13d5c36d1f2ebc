"""Batched binary-BCH and Reed–Solomon outer code on the device (counterpart
of ``orion_sdr_tpu/fec/bch_device.py``).

Encoders: the systematic LFSRs are linear over GF(2), so the parity of a
batch is one product mod 2 with a cached parity matrix (``torch.matmul`` on
0/1 float32 operands; every sum is at most n·8 < 2^24, so it is exact even
with TF32 on).

Decoders: ``bch_decode_batch_device`` / ``rs_decode_batch_device`` run the
CUDA kernel of ``ops/outer_fec.py`` on a CUDA tensor and the plain torch
versions below on a CPU tensor. The plain versions follow the JAX
decoders step for step: syndromes by a product mod 2, branchless
Berlekamp–Massey over 2t iterations (the shift register kept
pre-multiplied by x), Chien over the shortened code's degree window,
Forney magnitudes for RS, the residual syndrome, and the same accept sets
(BCH ``resid_ok & n_found <= t``; RS ``resid_ok & ~bad_dv & n_err == sdeg
& sdeg <= t``). Failed rows keep their systematic prefix. GF(256) products
use the log/exp tables of ``fec/galois.py`` instead of the JAX package's
carryless form: the same field, so the same bits.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..dsp.device import on_device
from .galois import GF_EXP, GF_LOG, ReedSolomon, _bch_generator, gf_mul

# the device decoders serve the deployed code sizes (DVB RS t=8, frame BCH
# t<=8); larger codes stay on the native host path
MAX_DEVICE_T = 8


@lru_cache(maxsize=16)
def _tables(n: int, t: int):
    """Syndrome bit-matrix T (n, 2t·8) with S_j bit b at column j·8+b, and
    the Chien plane α^{-m·d} (cap, n) over the valid degree window."""
    shift = 255 - n
    deg = (n - 1 - np.arange(n)) + shift
    js = np.arange(1, 2 * t + 1)
    alpha = GF_EXP[(js[:, None] * deg[None, :]) % 255]
    T = np.zeros((n, 2 * t * 8), np.int32)
    for j in range(2 * t):
        for b in range(8):
            T[:, j * 8 + b] = (alpha[j] >> b) & 1
    cap = t + 2
    d = shift + np.arange(n)
    chien = GF_EXP[(-(np.arange(cap)[:, None]) * d[None, :]) % 255]
    return shift, T, chien.astype(np.int32)


@lru_cache(maxsize=16)
def _rs_tables(n: int, n_parity: int):
    """RS syndrome bit-matrix (n·8, 2t·8) (S_j is GF(2)-bilinear in the
    bits of r_p), the α^{-m·d} evaluation plane over the valid degree
    window and the root locations x_d = α^{d}."""
    shift = 255 - n
    t = n_parity // 2
    cap = t + 2
    deg = (n - 1 - np.arange(n)) + shift
    js = np.arange(n_parity)
    alpha = GF_EXP[(js[:, None] * deg[None, :]) % 255]
    M = np.zeros((n * 8, n_parity * 8), np.int32)
    for j in range(n_parity):
        for c in range(8):
            # bit c of r_p contributes (2^c)·α^{j·deg(p)} to S_j
            contrib = gf_mul(np.full(n, 1 << c, np.uint8), alpha[j])
            for b in range(8):
                M[c::8, j * 8 + b] = (contrib >> b) & 1
    d = shift + np.arange(n)
    mmax = max(cap, n_parity)
    inv_plane = GF_EXP[(-(np.arange(mmax)[:, None]) * d[None, :]) % 255]
    x_d = GF_EXP[d % 255]
    return shift, M, inv_plane.astype(np.int32), x_d.astype(np.int32)


@lru_cache(maxsize=16)
def _bch_parity_matrix(n: int, k: int, t: int) -> np.ndarray:
    """(k, parity) GF(2) matrix P with parity(m) = m·P mod 2: row i is the
    register a lone 1 fed at step i leaves after the remaining k−1−i
    zero-input steps of the systematic LFSR, in output bit order."""
    gen = _bch_generator(t)
    parity = len(gen) - 1
    assert k + parity == n
    mask = 0
    for j in range(1, parity + 1):
        if gen[j]:
            mask |= 1 << (parity - j)
    pmask = (1 << parity) - 1
    top_bit = 1 << (parity - 1)
    R = [0] * k
    r = mask & pmask
    R[k - 1] = r
    for i in range(k - 2, -1, -1):
        fb = mask if (r & top_bit) else 0
        r = ((r << 1) ^ fb) & pmask
        R[i] = r
    P = np.zeros((k, parity), np.uint8)
    for i in range(k):
        for j in range(parity):
            P[i, j] = (R[i] >> (parity - 1 - j)) & 1
    return P


@lru_cache(maxsize=16)
def _rs_parity_bit_matrix(n: int, n_parity: int) -> np.ndarray:
    """(k·8, n_parity·8) GF(2) matrix P with parity_bits(m) =
    m_bits·P mod 2, built by encoding the k·8 unit-bit messages with the
    host encoder and unpacking the parity bytes MSB-first."""
    rs = ReedSolomon(n, n_parity)
    k = rs.k
    unit = np.zeros((k * 8, k), np.uint8)
    rows = np.repeat(np.arange(k), 8)
    unit[np.arange(k * 8), rows] = 0x80 >> np.tile(np.arange(8), k)
    parity = np.asarray(rs.encode(unit))[:, k:]
    return np.unpackbits(parity, axis=1)


_CONST: dict = {}


def _const(key: tuple, make, dtype, device) -> torch.Tensor:
    """A table from ``make()`` as a tensor on ``device``, built once."""
    full = key + (str(dtype), str(device))
    t = _CONST.get(full)
    if t is None:
        t = _CONST[full] = torch.as_tensor(np.asarray(make()), dtype=dtype,
                                           device=device)
    return t


_MSB_FIRST = np.arange(7, -1, -1)


def bits_from_bytes(byts: torch.Tensor) -> torch.Tensor:
    """(..., L) bytes → (..., 8L) bits, MSB first (np.unpackbits order)."""
    shifts = _const(("msb",), lambda: _MSB_FIRST, torch.int32, byts.device)
    bits = (byts.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(byts.shape[:-1] + (-1,)).to(torch.uint8)


def bytes_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8L) bits → (..., L) bytes, MSB first (np.packbits order)."""
    w = _const(("w_msb",), lambda: 1 << _MSB_FIRST, torch.int32, bits.device)
    b = bits.to(torch.int32).reshape(bits.shape[:-1] + (-1, 8))
    return (b * w).sum(-1).to(torch.uint8)


def _mod2_product(bits: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """bits (..., r) 0/1 · P (r, c) 0/1 mod 2 → (..., c) int32: exact in
    float32 (each sum at most r < 2^24)."""
    return torch.matmul(bits.to(torch.float32), P).to(torch.int32) & 1


# ── encode ───────────────────────────────────────────────────────────────────


def bch_encode_batch_device(n: int, k: int, t: int, message_bits,
                            device=None) -> torch.Tensor:
    """(..., k) message bits → (..., n) systematic codewords (uint8) on the
    tensor's device (host data: ``device``, None for the card); bit-exact
    with ``galois.Bch.encode``."""
    message_bits = on_device(message_bits, device)
    P = _const(("bch_P", n, k, t), lambda: _bch_parity_matrix(n, k, t),
               torch.float32, message_bits.device)
    m = message_bits.to(torch.int32) & 1
    return torch.cat([m, _mod2_product(m, P)], dim=-1).to(torch.uint8)


def rs_encode_batch_device(n: int, n_parity: int, message_bytes,
                           device=None) -> torch.Tensor:
    """(..., k) message bytes → (..., n) systematic RS codewords (uint8) on
    the tensor's device (host data: ``device``, None for the card);
    bit-exact with ``galois.ReedSolomon.encode``."""
    message_bytes = on_device(message_bytes, device)
    P = _const(("rs_P", n, n_parity),
               lambda: _rs_parity_bit_matrix(n, n_parity), torch.float32,
               message_bytes.device)
    m = message_bytes.to(torch.uint8)
    parity = bytes_from_bits(_mod2_product(bits_from_bytes(m), P))
    return torch.cat([m, parity], dim=-1)


# ── plain decoders ───────────────────────────────────────────────────────────


def _gf_ops(device):
    exp = _const(("gf_exp",), lambda: GF_EXP, torch.int64, device)
    log = _const(("gf_log",), lambda: GF_LOG, torch.int64, device)

    def mul(a, b):
        out = exp[log[a] + log[b]]
        return torch.where((a == 0) | (b == 0), 0, out)

    def inv(a):                      # zero maps to zero, as a²⁵⁴ does
        return torch.where(a == 0, 0, exp[255 - log[a]])

    return mul, inv


def gf_inv(a, device=None) -> torch.Tensor:
    """Elementwise inverse in GF(256) as int32, zero mapping to zero (the
    JAX package's a^254). A tensor stays on its device; host data goes to
    ``device`` (None: the card)."""
    x = on_device(a, device, torch.int64)
    return _gf_ops(x.device)[1](x).to(torch.int32)


def _xor_last(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis."""
    out = x[..., 0]
    for m in range(1, x.shape[-1]):
        out = out ^ x[..., m]
    return out


def _xor_mid(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce axis 1 of a (B, m, n) tensor."""
    out = x[:, 0]
    for m in range(1, x.shape[1]):
        out = out ^ x[:, m]
    return out


def _shift1(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(p[:, :1]), p[:, :-1]], dim=1)


def _berlekamp_massey(s_at, n_lo: int, n_hi: int, start: int, B: int,
                      cap: int, mul, inv, device):
    """Branchless BM over iterations n_lo..n_hi−1 with the reset rule of
    ``start`` (1: BCH, 2l < n, l ← n − l; 0: RS, 2l <= n, l ← n + 1 − l).
    Iteration n reads s_at[:, n − i] for σ_i where n − i >= ``start``.
    Returns (sigma (B, cap), its degree (B,))."""
    sigma = torch.zeros((B, cap), dtype=torch.int64, device=device)
    sigma[:, 0] = 1
    bx = torch.zeros_like(sigma)
    bx[:, 1] = 1
    l = torch.zeros(B, dtype=torch.int64, device=device)
    iidx = np.arange(cap)
    width = s_at.shape[1]
    for nn in range(n_lo, n_hi):
        j = nn - iidx
        gidx = torch.as_tensor(np.clip(j, 0, width - 1), device=device)
        valid = torch.as_tensor(j >= start, device=device)
        gather = torch.where(valid, s_at[:, gidx], 0)
        delta = _xor_last(mul(sigma, gather))
        t_new = sigma ^ mul(delta[:, None], bx)
        if start == 1:
            reset = (delta != 0) & (2 * l < nn)
            l_reset = nn - l
        else:
            reset = (delta != 0) & (2 * l <= nn)
            l_reset = nn + 1 - l
        bx_reset = _shift1(mul(inv(delta)[:, None], sigma))
        sigma = torch.where((delta != 0)[:, None], t_new, sigma)
        bx = torch.where(reset[:, None], bx_reset, _shift1(bx))
        l = torch.where(reset, l_reset, l)
    idx = torch.arange(cap, device=device)
    sdeg = torch.where(sigma != 0, idx, 0).amax(-1)
    return sigma, sdeg


def bch_decode_batch_reference(n: int, k: int, t: int, bits: torch.Tensor):
    """Plain torch BCH decode on ``bits``' device: (B, n) bit codewords →
    ((B, k) uint8 message bits, (B,) int32 ok flags)."""
    if not 1 <= t <= MAX_DEVICE_T:
        raise ValueError(f"device BCH supports 1 <= t <= {MAX_DEVICE_T}")
    shift, T, chien = _tables(n, t)
    dev = bits.device
    mul, inv = _gf_ops(dev)
    cap = t + 2
    r = bits.to(torch.int64) & 1
    B = r.shape[0]
    Tm = _const(("bch_T", n, t), lambda: T, torch.float32, dev)
    weights = 1 << torch.arange(8, device=dev)

    def syndromes(word):
        sb = _mod2_product(word, Tm).reshape(B, 2 * t, 8).to(torch.int64)
        return (sb * weights).sum(-1)

    s = syndromes(r)                               # s[:, j-1] = S_j
    any_err = (s != 0).any(-1)
    s1 = torch.cat([torch.zeros_like(s[:, :1]), s], dim=1)
    sigma, _ = _berlekamp_massey(s1, 1, 2 * t + 1, 1, B, cap, mul, inv, dev)

    plane = _const(("bch_chien", n, t), lambda: chien, torch.int64, dev)
    v = _xor_mid(mul(sigma[:, :, None], plane[None]))    # (B, n) by p
    roots = v == 0
    n_found = roots.sum(-1)
    corrected = r ^ roots.flip(-1).to(torch.int64)        # word order
    resid_ok = (syndromes(corrected) == 0).all(-1)
    ok_err = resid_ok & (n_found <= t)
    ok = torch.where(any_err, ok_err, True)
    use_corr = any_err & ok_err
    out = torch.where(use_corr[:, None], corrected[:, :k], r[:, :k])
    return out.to(torch.uint8), ok.to(torch.int32)


def rs_decode_batch_reference(n: int, n_parity: int, received: torch.Tensor):
    """Plain torch RS decode on ``received``' device: (B, n) byte codewords
    → ((B, k) uint8 messages, (B,) int32 ok flags)."""
    t = n_parity // 2
    if n_parity % 2 or not 1 <= t <= MAX_DEVICE_T:
        raise ValueError(f"device RS supports even n_parity of 2..."
                         f"{2 * MAX_DEVICE_T}")
    shift, M, inv_plane, x_d = _rs_tables(n, n_parity)
    dev = received.device
    mul, inv = _gf_ops(dev)
    cap = t + 2
    k = n - n_parity
    r = received.to(torch.int64) & 0xFF
    B = r.shape[0]
    Mm = _const(("rs_M", n, n_parity), lambda: M, torch.float32, dev)
    weights = 1 << torch.arange(8, device=dev)
    lsb_first = torch.arange(8, device=dev)

    def syndromes(word):
        wbits = ((word[:, :, None] >> lsb_first) & 1).reshape(B, n * 8)
        sb = _mod2_product(wbits, Mm).reshape(B, n_parity, 8).to(torch.int64)
        return (sb * weights).sum(-1)                   # S_0..S_{2t-1}

    s = syndromes(r)
    any_err = (s != 0).any(-1)
    sigma, sdeg = _berlekamp_massey(s, 0, n_parity, 0, B, cap, mul, inv, dev)

    # Ω = S·σ mod x^{2t}; σ' keeps the odd terms: deriv[m] = σ_{m+1}, m even
    omega = torch.zeros_like(s)
    for j in range(cap):
        prod = mul(sigma[:, j:j + 1], s)
        if j:
            prod = torch.cat([torch.zeros_like(prod[:, :j]), prod[:, :-j]],
                             dim=1)[:, :n_parity]
        omega = omega ^ prod
    deriv = torch.zeros_like(sigma)
    for m in range(0, cap - 1, 2):
        deriv[:, m] = sigma[:, m + 1]

    plane = _const(("rs_plane", n, n_parity), lambda: inv_plane, torch.int64,
                   dev)

    def poly_eval_all(coeffs, ncoef):
        return _xor_mid(mul(coeffs[:, :ncoef, None], plane[None, :ncoef]))

    sig_v = poly_eval_all(sigma, cap)
    roots = sig_v == 0                                  # (B, n) by p
    n_err = roots.sum(-1)
    om_v = poly_eval_all(omega, n_parity)
    dv_v = poly_eval_all(deriv, cap)
    xd = _const(("rs_xd", n, n_parity), lambda: x_d, torch.int64, dev)
    # Forney: e_p = x·Ω(x⁻¹)/σ'(x⁻¹) at x = α^{d}
    mag = mul(xd[None], mul(om_v, inv(dv_v)))
    bad_dv = (roots & (dv_v == 0)).any(-1)
    corrected = r ^ torch.where(roots, mag, 0).flip(-1)
    resid_ok = (syndromes(corrected) == 0).all(-1)
    ok_err = resid_ok & ~bad_dv & (n_err == sdeg) & (sdeg <= t)
    ok = torch.where(any_err, ok_err, True)
    use_corr = any_err & ok_err
    out = torch.where(use_corr[:, None], corrected[:, :k], r[:, :k])
    return out.to(torch.uint8), ok.to(torch.int32)


# ── decode entry points ──────────────────────────────────────────────────────


def bch_decode_batch_device(n: int, k: int, t: int, bits, device=None):
    """(B, n) bit codewords → ((B, k) message bits, (B,) int32 ok flags),
    the whole batch in one launch of the outer-code kernel on a CUDA
    tensor (its plain version on a CPU tensor; host data: ``device``, None
    for the card). t <= MAX_DEVICE_T."""
    from ..ops.outer_fec import bch_decode_kernel
    return bch_decode_kernel(n, k, t, on_device(bits, device, torch.uint8))


def rs_decode_batch_device(n: int, n_parity: int, received, device=None):
    """(B, n) byte codewords → ((B, k) messages, (B,) int32 ok flags), as
    :func:`bch_decode_batch_device`. n_parity // 2 <= MAX_DEVICE_T."""
    from ..ops.outer_fec import rs_decode_kernel
    return rs_decode_kernel(n, n_parity,
                            on_device(received, device, torch.uint8))
