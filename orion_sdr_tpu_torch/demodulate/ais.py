"""AIS receiver (counterpart of ``orion_sdr_tpu/demodulate/ais.py``): FM
discriminator → Gaussian matched lowpass → bit-rate slicing with a timing
search → NRZI decode → the shared HDLC layer → ITU-R M.1371 position
parse. The discriminator and the lowpass run on the device; slicing and
the frame layer are host numpy."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..dsp.device import to_device
from ..dsp.fir import convolve
from ..modulate.afsk import nrzi_decode
from ..modulate.ais import AIS_BAUD, _gauss_taps
from .afsk import _best_bit_values
from .pocsag import _discriminate


def ais_demod_bits(iq, fs: float, device="cuda") -> np.ndarray:
    """GMSK capture → HDLC bit stream (post-NRZI-decode), host numpy."""
    z = to_device(iq, device, torch.complex64)
    if z.shape[-1] < 64:
        return np.zeros(0, np.uint8)
    disc = _discriminate(z)[..., 1:]
    # matched lowpass: the GMSK eye (±2π·dev/fs ≈ ±0.16 rad at 10 sps) is
    # smaller than the per-sample discriminator noise at useful SNRs; the
    # receive Gaussian filter buys the √sps coherent gain back
    disc = convolve(disc, _gauss_taps(fs, AIS_BAUD, 0.5), "same")
    disc = disc.cpu().numpy()
    # one bit-time of zero tail: the slicer's floor() must not drop the
    # closing flag's final bit
    disc = np.concatenate([disc[:1], disc,
                           np.zeros(int(fs / AIS_BAUD) + 2, np.float32)])
    vals = _best_bit_values(disc, fs / AIS_BAUD)
    if vals.size == 0:
        return np.zeros(0, np.uint8)
    return nrzi_decode((vals > 0).astype(np.uint8))


def ais_decode(iq, fs: float, device="cuda") -> List:
    """Capture → [codec.ais.AisPosition] (FCS-gated)."""
    from ..codec.ais import ais_bits_to_positions
    return ais_bits_to_positions(ais_demod_bits(iq, fs, device))
