"""DVB-T super-frame demodulator (counterpart of
``orion_sdr_tpu/demodulate/dvb_t_super_frame.py``): four frame decodes, the
frame-number sequence 0, 1, 2, 3 verified, the 16-bit cell id reassembled,
the payloads concatenated.

``decode`` acquires each frame on its own; ``decode_batch`` runs one GI
sync and one receive over the four contiguous frames on the device, then
each frame's TPS and payload chain.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constellation import BITS_PER_SYMBOL
from ..sync.dvb_t_gi_sync import dvb_t_gi_sync
from ..waveform.dvb_t import (DVB_T_FRAMES_PER_SUPER_FRAME, DVB_T_N_FFT,
                              DvbTSuperFrameParams, guard_cp_len_2k)
from .dvb_t_frame import (DvbTFrameDemod, DvbTRxError, _as_iq, _tps_word,
                          receive_frame_body)


class DvbTRxSuperFrame(NamedTuple):
    payload: np.ndarray
    cell_id: int


class DvbTRxSuperFrameError(Exception):
    def __init__(self, kind: str, frame: int = -1, got=None) -> None:
        super().__init__(kind)
        self.kind = kind
        self.frame = frame
        self.got = got


def _assemble(frames) -> DvbTRxSuperFrame:
    """Four DvbTRxFrame in order → the super-frame, checking the frame
    numbers."""
    numbers = [rx.tps.frame_number for rx in frames]
    if numbers != [0, 1, 2, 3]:
        raise DvbTRxSuperFrameError("frame numbers out of sequence",
                                    got=numbers)
    cell_hi, cell_lo = frames[2].tps.cell_id, frames[3].tps.cell_id
    return DvbTRxSuperFrame(
        payload=np.concatenate([rx.payload for rx in frames]),
        cell_id=(cell_hi << 8) | cell_lo)


class DvbTSuperFrameDemod:
    """Super-frame demodulator on ``device``."""

    def __init__(self, params: DvbTSuperFrameParams, integer_cfo: bool = False,
                 rx_window_backoff: int = 0, *,
                 device="cuda") -> None:
        self.params = params
        self.integer_cfo = integer_cfo
        self.rx_window_backoff = rx_window_backoff
        self.device = torch.device(device)

    def with_integer_cfo_correction(self, on: bool = True):
        return DvbTSuperFrameDemod(self.params, on, self.rx_window_backoff,
                                   device=self.device)

    def with_rx_window_backoff(self, backoff: int):
        return DvbTSuperFrameDemod(self.params, self.integer_cfo, backoff,
                                   device=self.device)

    def _frame_demod(self, f: int) -> DvbTFrameDemod:
        return DvbTFrameDemod(self.params.frame(f), self.integer_cfo,
                              self.rx_window_backoff, device=self.device)

    def decode(self, iq, symbols_per_frame: int,
               frame_payload_lens) -> DvbTRxSuperFrame:
        """Four frame decodes, frame f from f·frame_samples on."""
        iq = _as_iq(iq, self.device)
        cp_len = guard_cp_len_2k(self.params.link.guard)
        frame_samples = symbols_per_frame * (DVB_T_N_FFT + cp_len)
        frames = []
        for f in range(DVB_T_FRAMES_PER_SUPER_FRAME):
            start = f * frame_samples
            if start >= iq.shape[-1]:
                raise DvbTRxSuperFrameError("incomplete", frame=f)
            try:
                frames.append(self._frame_demod(f).decode(
                    iq[start:], symbols_per_frame, frame_payload_lens[f]))
            except DvbTRxError as e:
                raise DvbTRxSuperFrameError(f"frame {f} failed: {e.kind}",
                                            frame=f) from e
        return _assemble(frames)

    def decode_batch(self, iq, symbols_per_frame: int,
                     frame_payload_lens) -> DvbTRxSuperFrame:
        """One acquisition for the whole super-frame: the four frames are
        contiguous, so one GI sync aligns them all and one receive demaps
        all four on the device; then each frame's TPS and payload chain
        (the payload lengths may differ). The same result as ``decode``;
        the capture starts at the super-frame (sub-symbol timing jitter is
        absorbed by the GI sync)."""
        iq = _as_iq(iq, self.device)
        cp_len = guard_cp_len_2k(self.params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        frame_samples = symbols_per_frame * sps
        fd = self._frame_demod(0)
        corrected = fd._integer_cfo_correct(iq, cp_len)
        if corrected is not None:
            iq = corrected
        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, fd.fs, sps)
        if acq is None:
            raise DvbTRxSuperFrameError("acquisition")
        start = acq.start_sample
        total = DVB_T_FRAMES_PER_SUPER_FRAME * frame_samples
        if iq.shape[-1] < start + total:
            raise DvbTRxSuperFrameError("incomplete")
        segs = iq[start: start + total].reshape(DVB_T_FRAMES_PER_SUPER_FRAME,
                                                frame_samples)
        vbits = BITS_PER_SYMBOL[self.params.link.constellation]
        llrs, cells = receive_frame_body(segs, symbols_per_frame, cp_len,
                                         self.rx_window_backoff, vbits)
        cells = cells.cpu().numpy()
        frames = []
        for f in range(DVB_T_FRAMES_PER_SUPER_FRAME):
            tps = _tps_word(cells[f], symbols_per_frame)
            if tps is None:
                raise DvbTRxSuperFrameError(f"frame {f} failed: TPS", frame=f)
            try:
                frames.append(fd._decode_payloads(
                    llrs[f].reshape(1, -1), frame_payload_lens[f], [tps])[0])
            except DvbTRxError as e:
                raise DvbTRxSuperFrameError(f"frame {f} failed: {e.kind}",
                                            frame=f) from e
        return _assemble(frames)
