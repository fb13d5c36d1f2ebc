"""Punctured convolutional codes and soft Viterbi decoding (counterpart of
``orion_sdr_tpu/fec/conv.py``).

Mother codes K5 (G0=0o25, G1=0o23) and DvbK7 (G0=0o171, G1=0o133, ETSI EN
300 744 §4.3.3); zero-tail termination; the DVB/802.11 puncture matrices.
Branch metric = LLR correlation Σ(1−2c)·llr, maximised (positive ⇒ bit 0).

Encoding is two binary convolutions over the bit stream on the bits'
device. Decoding runs the ACS + traceback of ``ops/viterbi.py``: the CUDA
kernel for a CUDA tensor, its plain torch version for a CPU tensor. Every
entry point takes host data (numpy, lists) as the JAX functions do and a
``device=`` keyword: None keeps a tensor on its device and sends host data
to the card (``dsp.device.on_device``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..dsp.device import on_device

CONV_CODES = {
    "k5": {"K": 5, "g0": 0b10101, "g1": 0b10011},
    "dvb_k7": {"K": 7, "g0": 0b1111001, "g1": 0b1011011},
}

PUNCTURE = {
    "1/2": ([1], [1]),
    "2/3": ([1, 1], [1, 0]),
    "3/4": ([1, 1, 0], [1, 0, 1]),
    "5/6": ([1, 1, 0, 1, 0], [1, 0, 1, 0, 1]),
    "7/8": ([1, 1, 1, 1, 0, 1, 0], [1, 0, 0, 0, 1, 0, 1]),
}

# chunked decode: trellis steps per chunk and the convergence margin each side
CHUNK_STEPS = 1024
CHUNK_OVERLAP = 96


def tail_bits(code: str) -> int:
    return CONV_CODES[code]["K"] - 1


@lru_cache(maxsize=None)
def _tables(code: str):
    """(K, S, top, taps0, taps1, prev, sign0, sign1): generator taps in time
    order and, per next state ns and input z, the predecessor
    ``prev(ns, z) = ((ns & (S/2−1)) << 1) | z`` and the branch signs
    (1 − 2c) of the two coded bits."""
    c = CONV_CODES[code]
    K, g0, g1 = c["K"], c["g0"], c["g1"]
    S = 1 << (K - 1)
    top = K - 2
    taps0 = np.array([(g0 >> (K - 1 - j)) & 1 for j in range(K)], np.int32)
    taps1 = np.array([(g1 >> (K - 1 - j)) & 1 for j in range(K)], np.int32)
    prev = np.zeros((S, 2), np.int32)
    sign0 = np.zeros((S, 2), np.float32)
    sign1 = np.zeros((S, 2), np.float32)
    for ns in range(S):
        b = (ns >> top) & 1
        base = (ns & ((S >> 1) - 1)) << 1 if S > 1 else 0
        for z in range(2):
            p = base | z
            prev[ns, z] = p
            window = (b << (K - 1)) | p
            sign0[ns, z] = 1.0 - 2.0 * (bin(window & g0).count("1") & 1)
            sign1[ns, z] = 1.0 - 2.0 * (bin(window & g1).count("1") & 1)
    return K, S, top, taps0, taps1, prev, sign0, sign1


def conv_encode(bits, code: str = "k5", device=None) -> torch.Tensor:
    """Rate-1/2 mother encode (no tail): (..., n) bits → (..., 2n) uint8,
    interleaved [g0_0, g1_0, g0_1, …]."""
    K, _, _, taps0, taps1, *_ = _tables(code)
    b = on_device(bits, device, torch.int32) & 1
    n = b.shape[-1]
    bp = torch.nn.functional.pad(b, (K - 1, 0))
    c0 = torch.zeros_like(b)
    c1 = torch.zeros_like(b)
    for j in range(K):          # taps[j] multiplies b_{t−j}
        win = bp[..., K - 1 - j:K - 1 - j + n]
        if taps0[j]:
            c0 = c0 ^ win
        if taps1[j]:
            c1 = c1 ^ win
    return torch.stack([c0, c1], dim=-1).reshape(b.shape[:-1] + (2 * n,)) \
        .to(torch.uint8)


def _puncture_mask(rate: str, n_steps: int) -> np.ndarray:
    """Boolean keep-mask over the interleaved 2·n_steps mother output."""
    g0, g1 = PUNCTURE[rate]
    cols = np.arange(n_steps) % len(g0)
    keep = np.empty(2 * n_steps, dtype=bool)
    keep[0::2] = np.asarray(g0, bool)[cols]
    keep[1::2] = np.asarray(g1, bool)[cols]
    return keep


def punctured_coded_len(info_bits: int, rate: str, code: str = "k5") -> int:
    return int(_puncture_mask(rate, info_bits + tail_bits(code)).sum())


def conv_encode_punctured(info_bits, rate: str = "1/2", code: str = "k5",
                          device=None) -> torch.Tensor:
    """Zero tail + mother encode + puncture: (..., n) → (..., coded)."""
    padded = torch.nn.functional.pad(
        on_device(info_bits, device, torch.uint8), (0, tail_bits(code)))
    coded = conv_encode(padded, code)
    if rate == "1/2":
        return coded
    keep = np.flatnonzero(_puncture_mask(rate, padded.shape[-1]))
    return coded[..., torch.as_tensor(keep, device=coded.device)]


def depuncture_llrs(coded_llrs, info_bits: int, rate: str,
                    code: str = "k5", device=None) -> torch.Tensor:
    """Reinsert LLR-0 erasures at punctured positions → (..., 2·n_steps)
    float32; input past the coded length is ignored, a short input leaves
    the missing positions at 0."""
    l = on_device(coded_llrs, device, torch.float32)
    n_steps = info_bits + tail_bits(code)
    out = l.new_zeros(l.shape[:-1] + (2 * n_steps,))
    if rate == "1/2":
        n = min(l.shape[-1], 2 * n_steps)
        out[..., :n] = l[..., :n]
        return out
    keep = np.flatnonzero(_puncture_mask(rate, n_steps))
    n = min(l.shape[-1], len(keep))
    out[..., torch.as_tensor(keep[:n], device=l.device)] = l[..., :n]
    return out


def viterbi_decode_soft(coded_llrs, info_bits: int, rate: str = "1/2",
                        code: str = "k5", device=None) -> torch.Tensor:
    """Soft Viterbi over a zero-tail-terminated punctured stream: (B,
    n_coded) or (n_coded,) LLRs → (B, info_bits) / (info_bits,) uint8 on the
    same device. Path metrics start pinned at state 0, are never
    renormalised, and the traceback starts at state 0."""
    from ..ops.viterbi import viterbi_decode_soft_kernel
    coded_llrs = on_device(coded_llrs, device, torch.float32)
    squeeze = coded_llrs.dim() == 1
    llrs = coded_llrs[None] if squeeze else coded_llrs
    out = viterbi_decode_soft_kernel(llrs.contiguous(), info_bits, rate,
                                     code)
    return out[0] if squeeze else out


def chunk_llrs(coded_llrs: torch.Tensor, info_bits: int, rate: str,
               code: str):
    """(B, n_coded) LLRs → per-chunk LLR pairs c0, c1 (B·n_chunk, span) and
    initial metrics pm0 (B·n_chunk, S): ``CHUNK_STEPS``-step chunks with
    ``CHUNK_OVERLAP`` zero-padded margins each side; chunk 0 starts pinned at
    state 0, the others uniform."""
    _, S, *_ = _tables(code)
    full = depuncture_llrs(coded_llrs, info_bits, rate, code)
    nb = full.shape[0]
    n_steps = info_bits + tail_bits(code)
    C, V = CHUNK_STEPS, CHUNK_OVERLAP
    nchunk = -(-n_steps // C)
    pad = (V, C * nchunk - n_steps + V)
    l0 = torch.nn.functional.pad(full[:, 0::2], pad)
    l1 = torch.nn.functional.pad(full[:, 1::2], pad)
    idx = torch.as_tensor(np.arange(nchunk)[:, None] * C
                          + np.arange(C + 2 * V)[None, :],
                          device=full.device).reshape(-1)
    span = C + 2 * V
    c0 = l0[:, idx].reshape(nb * nchunk, span).contiguous()
    c1 = l1[:, idx].reshape(nb * nchunk, span).contiguous()
    pm0 = full.new_zeros((nb, nchunk, S))
    pm0[:, 0] = -1e30
    pm0[:, 0, 0] = 0.0
    return c0, c1, pm0.reshape(nb * nchunk, S), nchunk


def viterbi_decode_soft_chunked(coded_llrs, info_bits: int,
                                rate: str = "1/2", code: str = "dvb_k7",
                                device=None) -> torch.Tensor:
    """Overlap-chunked soft Viterbi for long streams, as one batched decode
    of all chunks of all rows: a fixed-lag approximation of the full decode
    (each chunk renormalises its metrics every step and traces back from its
    best final state; the margins are dropped). (B, n_coded) or (n_coded,)
    → (B, info_bits) / (info_bits,) uint8."""
    from ..ops.viterbi import viterbi_chunks_kernel
    coded_llrs = on_device(coded_llrs, device)
    squeeze = coded_llrs.dim() == 1
    llrs = coded_llrs[None] if squeeze else coded_llrs
    nb = llrs.shape[0]
    c0, c1, pm0, nchunk = chunk_llrs(llrs, info_bits, rate, code)
    bits = viterbi_chunks_kernel(c0, c1, pm0, code)
    V = CHUNK_OVERLAP
    mid = bits.reshape(nb, nchunk, -1)[:, :, V:V + CHUNK_STEPS]
    out = mid.reshape(nb, -1)[:, :info_bits]
    return out[0] if squeeze else out
