"""DVB-T super-frame modulator (counterpart of
``orion_sdr_tpu/modulate/dvb_t_super_frame.py``; EN 300 744 §4.4/§4.6).

Four frames 0..3 with the alternating TPS sync word; the 16-bit cell id
rides split high/low byte; the payload splits four ways, zero-padded to a
common per-frame length. Each frame is modulated on the modulator's device
by :class:`DvbTFrameMod`; the optional TX lowpass masks the concatenated
super-frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..multicarrier import TxLowpass
from ..waveform.dvb_t import (DVB_T_FRAMES_PER_SUPER_FRAME, DVB_T_N_FFT,
                               DvbTSuperFrameParams)
from .dvb_t_frame import DvbTFrameMod, _as_bytes


class DvbTSuperFrame(NamedTuple):
    iq: np.ndarray
    symbols_per_frame: int
    samples_per_symbol: int
    frame_payload_lens: tuple

    def n_symbols(self) -> int:
        return DVB_T_FRAMES_PER_SUPER_FRAME * self.symbols_per_frame


class DvbTSuperFrameMod:
    """Super-frame modulator on ``device``."""

    def __init__(self, params: DvbTSuperFrameParams, window_roll_off: int = 0,
                 tx_lowpass: Optional[TxLowpass] = None, *,
                 device="cuda") -> None:
        self.params = params
        self.window_roll_off = window_roll_off
        self.tx_lowpass = tx_lowpass
        self.device = torch.device(device)

    def with_symbol_window(self, roll_off: int) -> "DvbTSuperFrameMod":
        return DvbTSuperFrameMod(self.params, roll_off, self.tx_lowpass,
                                 device=self.device)

    def with_tx_lowpass(self, lowpass: TxLowpass) -> "DvbTSuperFrameMod":
        return DvbTSuperFrameMod(self.params, self.window_roll_off, lowpass,
                                 device=self.device)

    def modulate(self, payload) -> DvbTSuperFrame:
        payload = _as_bytes(payload)
        n = DVB_T_FRAMES_PER_SUPER_FRAME
        base, rem = divmod(len(payload), n)
        lens = tuple(base + (1 if i < rem else 0) for i in range(n))
        part_len = max(lens)
        frames, off = [], 0
        for f, ln in enumerate(lens):
            part = np.zeros(part_len, np.uint8)
            part[:ln] = payload[off:off + ln]
            off += ln
            frames.append(DvbTFrameMod(self.params.frame(f),
                                       self.window_roll_off,
                                       device=self.device).modulate(part))
        iq = np.concatenate([f.iq for f in frames])
        if self.tx_lowpass is not None:
            iq = self.tx_lowpass.apply(torch.as_tensor(
                iq, device=self.device)).cpu().numpy()
        return DvbTSuperFrame(iq=iq,
                              symbols_per_frame=frames[0].n_symbols,
                              samples_per_symbol=frames[0].samples_per_symbol,
                              frame_payload_lens=lens)
