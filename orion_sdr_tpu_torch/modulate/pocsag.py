"""POCSAG transmitter (counterpart of ``orion_sdr_tpu/modulate/pocsag.py``):
preamble and batches as direct binary FSK at IQ baseband (±deviation, NRZ,
continuous phase: one phase accumulator over the burst). POCSAG convention:
a 0 bit is the high frequency."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..dsp.device import to_device
from ..dsp.osc import TAU
from .afsk import bit_index, phase_accumulate

POCSAG_PREAMBLE_BITS = 576


def _fsk_iq(bits, fs: float, sps: float, deviation_hz: float, n: int,
            device="cuda") -> torch.Tensor:
    """Per-bit values (0 = +deviation) → (n,) complex64 continuous-phase
    FSK."""
    b = to_device(bits, device)
    sel = b[..., bit_index(n, sps, b.shape[-1], b.device)].to(torch.float32)
    freq = float(np.float32(deviation_hz)) * (1.0 - 2.0 * sel)
    phase = phase_accumulate(float(np.float32(TAU / fs)) * freq)
    return torch.polar(torch.ones_like(phase), phase)


def pocsag_mod(pages, fs: float, baud: float = 1200.0,
               deviation_hz: float = 4500.0, device="cuda") -> torch.Tensor:
    """Pages (codec.pocsag.PocsagPage) → complex64 FSK capture on
    ``device``: 576-bit 1010… preamble, then sync+batch codewords
    MSB-first."""
    from ..codec.pocsag import pocsag_encode_batches
    if fs < 4.0 * deviation_hz:
        raise ValueError(f"fs must exceed {4 * deviation_hz:.0f} Hz")
    words = pocsag_encode_batches(list(pages))
    bits: List[int] = [(i + 1) & 1 for i in range(POCSAG_PREAMBLE_BITS)]
    for w in words:
        bits.extend((w >> (31 - j)) & 1 for j in range(32))
    b = np.asarray(bits, np.uint8)
    sps = fs / baud
    n = int(round(len(b) * sps))
    return _fsk_iq(b, float(fs), float(sps), float(deviation_hz), n, device)
