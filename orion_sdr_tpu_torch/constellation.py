"""Gray-coded constellations: BPSK/QPSK/QAM-16/64/256 map, hard decisions
and max-log soft LLRs (counterpart of ``orion_sdr_tpu/constellation.py``).

Per-axis independent Gray coding, unit average symbol energy
(axis scale = 1/sqrt(2(M²−1)/3)), bit layout per symbol = BITS/2 I-axis bits
MSB-first then BITS/2 Q-axis bits MSB-first. Positive LLR ⇒ bit 0.
:func:`map_bits`, :func:`soft_llr` and :func:`decide` take host data as the
JAX ones do: a tensor stays on its device, host data goes to ``device``
(None: the card), ``"cpu"`` runs the plain path.
"""

from __future__ import annotations

import numpy as np
import torch

from .dsp.device import takes_host_data

ORDERS = ("bpsk", "qpsk", "qam16", "qam64", "qam256")

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


def _axis_thresholds(bits: int) -> np.ndarray:
    """M−1 ascending decision midpoints of one QAM axis."""
    m = 1 << (bits // 2)
    return ((2 * np.arange(m - 1) - (m - 2)) * axis_scale(bits)).astype(
        np.float32)


def _axis_levels(bits: int) -> np.ndarray:
    """Amplitude of natural level index g."""
    m = 1 << (bits // 2)
    return ((2 * np.arange(m) + 1 - m) * axis_scale(bits)).astype(np.float32)


@takes_host_data("bits")
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


@takes_host_data("symbols")
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


def _unpack_msb(idx: torch.Tensor, k: int) -> torch.Tensor:
    """(...,) int32 → (..., k) uint8, MSB-first."""
    shifts = torch.arange(k - 1, -1, -1, dtype=torch.int32, device=idx.device)
    return ((idx[..., None] >> shifts) & 1).to(torch.uint8)


def _axis_nat(v: torch.Tensor, thr: np.ndarray) -> torch.Tensor:
    """Natural level index of each value: the count of thresholds it lies
    strictly above (a value on a threshold takes the lower level)."""
    t = torch.as_tensor(thr, device=v.device)
    return (v[..., None] > t).sum(-1, dtype=torch.int32)


@takes_host_data("symbols")
def decide(symbols: torch.Tensor, order: str) -> torch.Tensor:
    """Hard decision: symbols (..., n_syms) → bits (..., n_syms·bps) uint8,
    the reference deciders' Gray coding. BPSK and QPSK decide by sign
    (``re < 0`` is bit 1, so ±0 is bit 0); QAM counts the thresholds each
    axis lies strictly above."""
    bps = bits_per_symbol(order)
    z = symbols
    if order == "bpsk":
        return (z.real < 0.0).to(torch.uint8)
    if order == "qpsk":
        b = torch.stack([z.real < 0.0, z.imag < 0.0], dim=-1)
        return b.reshape(z.shape[:-1] + (-1,)).to(torch.uint8)
    k = bps // 2
    thr = _axis_thresholds(bps)

    def axis_bits(v):
        nat = _axis_nat(v, thr)
        return _unpack_msb(nat ^ (nat >> 1), k)

    b = torch.cat([axis_bits(z.real), axis_bits(z.imag)], dim=-1)
    return b.reshape(z.shape[:-1] + (-1,))


def decide_tables(order: str):
    """The nearest point ``map_bits(decide(y))`` as per-axis tables, for a
    kernel that decides one symbol at a time: (thresholds (T,) float32,
    levels (T + 1,) float32, sign). With ``sign`` an axis takes
    ``levels[1]`` where the value is below 0 and ``levels[0]`` elsewhere
    (BPSK, whose imaginary part is 0, and QPSK); without it, the level of
    the count of thresholds the value lies strictly above. The levels are
    ``map_bits``'s own amplitudes of each decision."""
    bps = bits_per_symbol(order)
    if order in ("bpsk", "qpsk"):
        probe = torch.tensor([0.5, -0.5], dtype=torch.float32)
        pts = map_bits(decide(torch.complex(probe, probe)[:, None], order),
                       order)
        return (np.zeros(1, np.float32),
                pts.real.reshape(-1).numpy().astype(np.float32), True)
    thr = _axis_thresholds(bps)
    k = bps // 2
    nat = torch.arange(1 << k, dtype=torch.int32)
    gray = _unpack_msb(nat ^ (nat >> 1), k)
    levels = map_bits(torch.cat([gray, gray], dim=-1), order).real
    return thr, levels.reshape(-1).numpy().astype(np.float32), False


def constellation_points(order: str) -> np.ndarray:
    """All 2^bps ideal points indexed by the symbol's packed bit index."""
    bps = bits_per_symbol(order)
    n = 1 << bps
    bits = ((np.arange(n)[:, None] >> np.arange(bps - 1, -1, -1)[None, :])
            & 1).astype(np.uint8)
    return map_bits(torch.as_tensor(bits.reshape(-1)), order).numpy()
