"""Streaming DVB-T receivers (counterpart of
``orion_sdr_tpu/demodulate/dvb_t_stream.py``).

Feed/flush receivers over the frame demods: front-of-buffer GI acquisition →
frame decode → drain, with a fixed geometry (n_symbols, payload lengths)
from construction. The buffer stays on the demod's device. A frame is tried
once the buffer holds it plus one symbol of look-ahead (none on flush);
a lock scoring under 0.2 counts as no lock, and a buffer with no lock is
trimmed to the last frame plus a few symbols; a failed decode first skips
one symbol, up to three times, before it skips the whole frame.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from ..dsp.channelizer import BandStreams, Channelizer
from ..dsp.device import sanitize_iq
from ..sync.dvb_t_gi_sync import dvb_t_gi_sync
from ..waveform.dvb_t import (DVB_T_KMAX, DVB_T_N_FFT, DvbTFrameParams,
                              DvbTHierFrameParams, guard_cp_len_2k)
from .dvb_t_frame import (DvbTFrameDemod, DvbTHierFrameDemod, DvbTRxError,
                          DvbTRxFrame, _as_iq)

# GI-metric score below which a lock counts as noise (≈ −6 dB SNR, far below
# any decodable operating point), so dead air consumes no samples that
# belong to a later frame
MIN_LOCK_SCORE = 0.2
# failed decodes answered by a one-symbol skip before a whole-frame skip
MAX_SHORT_SKIPS = 3


class DvbTFrameStreamDemod:
    """Feed/flush receiver for a continuous run of equal-geometry frames on
    ``device``."""

    def __init__(self, params: DvbTFrameParams, n_symbols: int,
                 payload_len: int, *, device="cuda") -> None:
        self._setup(DvbTFrameDemod(params, device=device), params, n_symbols)
        self.payload_len = payload_len

    def _setup(self, demod, params, n_symbols: int) -> None:
        self.demod = demod
        self.device = demod.device
        self.n_symbols = n_symbols
        self.sps = DVB_T_N_FFT + guard_cp_len_2k(params.link.guard)
        self._buf = torch.zeros(0, dtype=torch.complex64, device=self.device)
        self._short_skips = 0

    def with_integer_cfo_correction(self, on: bool = True):
        self.demod = self.demod.with_integer_cfo_correction(on)
        return self

    def with_rx_window_backoff(self, backoff: int):
        self.demod = self.demod.with_rx_window_backoff(backoff)
        return self

    def __len__(self) -> int:
        return self._buf.shape[0]

    def view_buf(self) -> np.ndarray:
        return self._buf.cpu().numpy()

    def clear(self) -> None:
        self._buf = self._buf[:0]

    def _frame_samples(self) -> int:
        return self.n_symbols * self.sps

    def _decode_front(self, seg: torch.Tensor):
        return self.demod.decode(seg, self.n_symbols, self.payload_len)

    def feed(self, iq) -> List[Union[DvbTRxFrame, DvbTRxError]]:
        self._buf = torch.cat([self._buf,
                               sanitize_iq(_as_iq(iq, self.device))])
        return self._drain()

    def flush(self) -> List[Union[DvbTRxFrame, DvbTRxError]]:
        """End of stream: try frames without the one-symbol look-ahead."""
        return self._drain(final=True)

    def _drain(self, final: bool = False):
        out = []
        while True:
            step = self._try_one_frame(final)
            if step is None:
                return out
            result, consume_to = step
            self._buf = self._buf[consume_to:]
            out.append(result)

    def _try_one_frame(self, final: bool = False):
        n_buf = self._buf.shape[0]
        need = self._frame_samples() + (0 if final else self.sps)
        if n_buf < need:
            return None
        acq = dvb_t_gi_sync(self._buf, DVB_T_N_FFT, self.sps - DVB_T_N_FFT,
                            self.demod.fs, self.sps)
        if acq is not None and acq.score < MIN_LOCK_SCORE:
            acq = None
        if acq is None:
            # no lock at the front (a silent gap): keep the last frame plus
            # look-ahead and a few symbols of margin, so the receiver
            # re-syncs when signal returns instead of holding dead air
            keep = need + 4 * self.sps
            if n_buf > keep:
                self._buf = self._buf[n_buf - keep:]
            return None
        start = acq.start_sample
        consume_to = start + self._frame_samples()
        if consume_to > n_buf:
            return None
        try:
            frame = self._decode_front(self._buf[start:])
            self._short_skips = 0
            return frame, consume_to
        except DvbTRxError as e:
            # a failure right after acquisition is often a symbol-misaligned
            # lock (the GI metric cannot tell frame from symbol boundaries):
            # advance one symbol and retry a few times before skipping the
            # frame whole
            if self._short_skips < MAX_SHORT_SKIPS:
                self._short_skips += 1
                return e, min(start + self.sps, n_buf)
            self._short_skips = 0
            return e, consume_to


class DvbTHierFrameStreamDemod(DvbTFrameStreamDemod):
    """Feed/flush receiver for a run of equal-geometry hierarchical frames
    on ``device``: each frame decodes into a DvbTHierRxFrame (HP payload
    always, LP or None)."""

    def __init__(self, params: DvbTHierFrameParams, n_symbols: int,
                 hp_payload_len: int, lp_payload_len: int, *,
                 device="cuda") -> None:
        params.link.validate()
        self._setup(DvbTHierFrameDemod(params, device=device), params,
                    n_symbols)
        self.hp_payload_len = hp_payload_len
        self.lp_payload_len = lp_payload_len

    def with_integer_cfo_correction(self, on: bool = True):
        raise NotImplementedError(
            "integer-CFO pre-correction is not wired for the hierarchical "
            "stream; correct CFO upstream (dsp.rotate) if needed")

    def _decode_front(self, seg: torch.Tensor):
        return self.demod.decode(seg, self.n_symbols, self.hp_payload_len,
                                 self.lp_payload_len)


class DvbTBandStreamDemod(BandStreams):
    """Multi-mux DVB-T receive: C equal-geometry multiplexes at known
    centers in one wideband capture, channelized as one batch on
    ``device``, each mux drained by its own :class:`DvbTFrameStreamDemod`
    (its decodes launch the Viterbi kernel on the card).

    ``fs`` is the per-mux sample rate (an NB-mode rate); ``fs_wide`` must
    be an integer multiple of it. Results come back as {mux_index:
    [DvbTRxFrame | DvbTRxError]}."""

    def __init__(self, params: DvbTFrameParams, n_symbols: int,
                 payload_len: int, centers_hz, fs: float, fs_wide: float,
                 stopband_db: float = 60.0, device="cuda") -> None:
        # occupied band: 1705 active carriers of 2048 → ±KMAX/2 bins
        occ_hz = (DVB_T_KMAX / 2 + 1) / DVB_T_N_FFT * fs
        chan = Channelizer(fs_wide, fs, centers_hz, passband_hz=occ_hz,
                           stopband_db=stopband_db, device=device)
        super().__init__(chan, [
            DvbTFrameStreamDemod(params, n_symbols, payload_len,
                                 device=device)
            for _ in range(chan.num_channels)])
