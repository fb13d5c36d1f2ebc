"""AIS transmitter (counterpart of ``orion_sdr_tpu/modulate/ais.py``): GMSK
at 9600 bps — NRZI bits → Gaussian-filtered NRZ frequency track (BT =
0.4) → FM phase accumulator (h = 0.5 ⇒ ±2400 Hz deviation), on the
device."""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.device import to_device
from ..dsp.fir import fir_filter_aligned
from ..dsp.osc import TAU
from .afsk import bit_index, nrzi_encode, phase_accumulate

AIS_BAUD = 9600.0
AIS_DEVIATION_HZ = AIS_BAUD / 4.0          # modulation index h = 0.5
AIS_BT = 0.4


def _gauss_taps(fs: float, baud: float, bt: float) -> np.ndarray:
    sps = fs / baud
    sigma = np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt) * sps
    half = int(np.ceil(3 * sigma))
    t = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-0.5 * (t / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _gmsk_iq(line, fs: float, sps: float, dev: float, taps, n: int,
             device="cuda") -> torch.Tensor:
    """Per-bit line states → (n,) complex64 GMSK: the NRZ track through
    the Gaussian taps, then the phase accumulator."""
    ln = to_device(line, device)
    nrz = 2.0 * ln[..., bit_index(n, sps, ln.shape[-1], ln.device)].to(
        torch.float32) - 1.0
    shaped = fir_filter_aligned(nrz, np.asarray(taps, np.float32))
    step = float(np.float32(np.float32(TAU / fs) * np.float32(dev)))
    phase = phase_accumulate(step * shaped)
    return torch.polar(torch.ones_like(phase), phase)


def ais_mod(positions, fs: float = 96_000.0, device="cuda") -> torch.Tensor:
    """Position reports (codec.ais.AisPosition) → one GMSK burst at ``fs``
    (≥ 4× the 9600 baud) on ``device``."""
    from ..codec.ais import ais_encode_position, ais_frames_to_bits
    if fs < 4 * AIS_BAUD:
        raise ValueError(f"fs must be ≥ {4 * AIS_BAUD:.0f} for GMSK 9600")
    bits = ais_frames_to_bits([ais_encode_position(p) for p in positions])
    line = nrzi_encode(bits)
    sps = fs / AIS_BAUD
    n = int(round(len(line) * sps))
    return _gmsk_iq(line, float(fs), float(sps), float(AIS_DEVIATION_HZ),
                    _gauss_taps(fs, AIS_BAUD, AIS_BT), n, device)
