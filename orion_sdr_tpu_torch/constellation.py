"""Gray-coded constellations: BPSK/QPSK/QAM-16/64/256 map and max-log soft LLRs
(counterpart of ``orion_sdr_tpu/constellation.py``).

Per-axis independent Gray coding, unit average symbol energy
(axis scale = 1/sqrt(2(M²−1)/3)), bit layout per symbol = BITS/2 I-axis bits
MSB-first then BITS/2 Q-axis bits MSB-first. Positive LLR ⇒ bit 0.
"""

from __future__ import annotations

import numpy as np
import torch

BITS_PER_SYMBOL = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6, "qam256": 8}


def bits_per_symbol(order: str) -> int:
    if order not in BITS_PER_SYMBOL:
        raise ValueError(f"unknown constellation {order!r} (expected one of "
                         f"{sorted(BITS_PER_SYMBOL)})")
    return BITS_PER_SYMBOL[order]


def axis_scale(bits: int) -> float:
    """1/sqrt(average symbol energy) for square QAM."""
    m = 1 << (bits // 2)
    return float(1.0 / np.sqrt(2.0 * (m * m - 1) / 3.0))


def _axis_levels(bits: int) -> np.ndarray:
    """Amplitude of natural level index g."""
    m = 1 << (bits // 2)
    return ((2 * np.arange(m) + 1 - m) * axis_scale(bits)).astype(np.float32)


def map_bits(bits: torch.Tensor, order: str) -> torch.Tensor:
    """Bits (..., n_bits) integer tensor → unit-energy symbols (..., n_syms)
    complex64; n_bits must be a multiple of the bits per symbol."""
    bps = bits_per_symbol(order)
    b = bits.to(torch.int32) & 1
    if order == "bpsk":
        re = torch.where(b == 0, 1.0, -1.0)
        return torch.complex(re, torch.zeros_like(re))
    b = b.reshape(b.shape[:-1] + (-1, bps))
    if order == "qpsk":
        s = 1.0 / np.sqrt(2.0)
        return torch.complex(torch.where(b[..., 0] == 0, s, -s),
                             torch.where(b[..., 1] == 0, s, -s))
    k = bps // 2
    m = 1 << k
    scale = axis_scale(bps)
    weights = torch.tensor([1 << (k - 1 - i) for i in range(k)],
                           dtype=torch.int32, device=bits.device)

    def amp(axis_bits):
        g = (axis_bits * weights).sum(-1, dtype=torch.int32)
        g = g ^ (g >> 1)          # Gray decode by prefix XOR (k ≤ 4 bits)
        g = g ^ (g >> 2)
        return (2 * g + 1 - m).to(torch.float32) * scale

    return torch.complex(amp(b[..., :k]), amp(b[..., k:]))


def soft_llr(symbols: torch.Tensor, order: str, gain: float = 1.0
             ) -> torch.Tensor:
    """Max-log LLRs, positive ⇒ bit 0: for each bit, the min distance² over
    bit=1 levels minus the min over bit=0 levels, scaled by ``gain``; BPSK
    is 4·re and QPSK 4√2·(re, im). Returns (..., n_syms·bps) float32."""
    bps = bits_per_symbol(order)
    z = symbols
    if order == "bpsk":
        return (4.0 * gain) * z.real.to(torch.float32)
    if order == "qpsk":
        s = 4.0 * np.sqrt(2.0)
        llr = torch.stack([(s * gain) * z.real, (s * gain) * z.imag], dim=-1)
        return llr.reshape(z.shape[:-1] + (-1,)).to(torch.float32)
    k = bps // 2
    levels = _axis_levels(bps)
    m = len(levels)
    gray = np.arange(m) ^ (np.arange(m) >> 1)
    bit_of_level = (gray[:, None] >> np.arange(k - 1, -1, -1)[None, :]) & 1
    lv = torch.as_tensor(levels, device=z.device)
    is1 = torch.as_tensor(bit_of_level.T.astype(bool), device=z.device)  # (k, m)
    big = torch.tensor(1e30, dtype=torch.float32, device=z.device)

    def axis_llr(v):
        d2 = ((v[..., None] - lv) ** 2)[..., None, :]                # (..., 1, m)
        min0 = torch.where(~is1, d2, big).amin(-1)                   # (..., k)
        min1 = torch.where(is1, d2, big).amin(-1)
        return min1 - min0

    llr = torch.cat([axis_llr(z.real), axis_llr(z.imag)], dim=-1)
    return (gain * llr.reshape(z.shape[:-1] + (-1,))).to(torch.float32)
