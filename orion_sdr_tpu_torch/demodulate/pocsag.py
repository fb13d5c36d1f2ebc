"""POCSAG receiver (counterpart of ``orion_sdr_tpu/demodulate/pocsag.py``):
FM discriminator → per-bit integration with timing from an offset search →
sync-codeword hunt (both polarities) → BCH-corrected codeword stream →
pages.

The discriminator runs on the device; the bit integration, sync and
codeword layers are host numpy (kbit/s-rate work), as in the JAX
package."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..codec.pocsag import (POCSAG_SYNC, pocsag_check, pocsag_decode_words,
                            PocsagPage)
from ..dsp.device import to_device


def _discriminate(z: torch.Tensor) -> torch.Tensor:
    """atan2 of z[i]·conj(z[i−1]) (the first sample against itself), in
    float32 real arithmetic."""
    pr = torch.cat([z.real[..., :1], z.real[..., :-1]], dim=-1)
    pi = torch.cat([z.imag[..., :1], z.imag[..., :-1]], dim=-1)
    re = z.real * pr + z.imag * pi
    im = z.imag * pr - z.real * pi
    return torch.atan2(im, re)


def pocsag_demod_bits(iq, fs: float, baud: float = 1200.0,
                      device="cuda") -> np.ndarray:
    """IQ capture → hard bit stream, host numpy (0 = high frequency, the
    POCSAG sense), bit timing by offset search."""
    disc = _discriminate(to_device(iq, device, torch.complex64)).cpu().numpy()
    sps = fs / baud
    n_bits = int(len(disc) / sps) - 1
    if n_bits < 64:
        return np.zeros(0, np.uint8)
    idx = np.arange(len(disc))
    best = None
    for off in np.arange(0.0, sps, sps / 8.0):
        k = ((idx - off) / sps).astype(np.int64)
        valid = (k >= 0) & (k < n_bits)
        sums = np.bincount(k[valid], disc[valid], minlength=n_bits)
        score = float(np.mean(np.abs(sums)))
        if best is None or score > best[0]:
            best = (score, sums)
    return (best[1] < 0).astype(np.uint8)       # 0 bit = +freq = +phase step


def pocsag_decode(iq, fs: float, baud: float = 1200.0,
                  device="cuda") -> List[PocsagPage]:
    """IQ capture → pages. Hunts the 32-bit sync codeword in both
    polarities (the discriminator's sign is receiver-dependent), walks
    batches of 16 codewords, BCH-corrects each, re-hunts sync per batch."""
    bits = pocsag_demod_bits(iq, fs, baud, device)
    pages: List[PocsagPage] = []
    for pol in (0, 1):
        b = bits ^ pol
        if len(b) < 32:
            continue
        win = np.lib.stride_tricks.sliding_window_view(b, 32)
        vals = win @ (1 << np.arange(31, -1, -1)).astype(np.int64)
        sync_pos = np.flatnonzero(vals == POCSAG_SYNC)
        if sync_pos.size == 0:
            continue
        slot_stream: List = []
        i = int(sync_pos[0])
        while i + 32 <= len(b):
            v = int(vals[i]) if i < len(vals) else None
            if v != POCSAG_SYNC:
                break
            i += 32
            for _ in range(16):
                if i + 32 > len(b):
                    break
                slot_stream.append(pocsag_check(int(vals[i])
                                                if i < len(vals) else 0))
                i += 32
        pages = pocsag_decode_words(slot_stream)
        if pages:
            break
    return pages
