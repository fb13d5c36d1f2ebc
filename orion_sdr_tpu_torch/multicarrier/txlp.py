"""TX baseband spectral mask (counterpart of
``orion_sdr_tpu/multicarrier/txlp.py``): a Kaiser lowpass applied
group-delay-compensated across the whole assembled stream, symbol
boundaries included, by ``dsp.fir.fir_filter_aligned`` on the stream's
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..dsp.fir import (fir_filter_aligned, kaiser_lowpass_taps,
                       kaiser_num_taps, kaiser_transition_norm)


@dataclass(frozen=True)
class TxLowpass:
    """Mask spec: cutoff (fraction of fs), tap count, Kaiser stopband
    target. Guard budget: ``roll_off + group_delay <= min(cp_len − backoff,
    backoff)``."""

    cutoff_norm: float
    num_taps: int
    stopband_db: float

    @staticmethod
    def for_null_band(n_fft: int, occupied_half: int, num_taps: int,
                      stopband_db: float) -> "TxLowpass":
        """Cutoff placed so the pass band ends at the outermost carrier and
        the stop band is reached as early as the length allows."""
        occ = occupied_half / max(n_fft, 1)
        half_tr = 0.5 * kaiser_transition_norm(num_taps, stopband_db)
        earliest = occ + half_tr
        latest = 0.5 - half_tr
        cutoff = earliest if earliest <= latest else 0.5 * (occ + 0.5)
        return TxLowpass(cutoff, num_taps, stopband_db)

    @staticmethod
    def taps_for_null_band(n_fft: int, occupied_half: int,
                           stopband_db: float) -> int:
        occ = occupied_half / max(n_fft, 1)
        return kaiser_num_taps(0.5 - occ, stopband_db)

    def group_delay(self) -> int:
        return (max(self.num_taps, 3) | 1) // 2

    def transition_norm(self) -> float:
        return kaiser_transition_norm(self.num_taps, self.stopband_db)

    def transition_fits(self, n_fft: int, occupied_half: int) -> bool:
        return self.transition_norm() <= 0.5 - occupied_half / max(n_fft, 1)

    def stopband_edge_norm(self) -> float:
        return self.cutoff_norm + 0.5 * self.transition_norm()

    def fits_guard(self, cp_len: int, roll_off: int, backoff: int) -> bool:
        slack = min(max(cp_len - backoff, 0), backoff)
        return roll_off + self.group_delay() <= slack

    def taps(self):
        return kaiser_lowpass_taps(self.num_taps, self.cutoff_norm,
                                   self.stopband_db)

    def apply(self, stream: torch.Tensor) -> torch.Tensor:
        """Same-length, time-aligned mask over the whole burst, on the
        stream's device."""
        return fir_filter_aligned(stream, self.taps())
