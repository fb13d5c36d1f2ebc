"""Multi-channel COFDM band receive (counterpart of
``orion_sdr_tpu/frame/band.py``): a wideband capture carrying several
COFDM links at known centers; one :class:`~orion_sdr_tpu_torch.dsp.
channelizer.Channelizer` extracts every channel as one batch on the
device, and one :class:`OfdmFrameStreamDemod` a channel acquires and
decodes it (its LDPC decodes launch the BP kernel on the card).
"""

from __future__ import annotations

from typing import Sequence

from ..dsp.channelizer import BandStreams, Channelizer
from ..ofdm import OfdmConfig
from ..sync.ofdm_sync import OfdmPreamble
from .demodulator import OfdmFrameStreamDemod
from .types import McsTable


class OfdmFrameBandStreamDemod(BandStreams):
    """Streaming COFDM receive of C channels from one wideband capture on
    ``device``. ``fs_wide`` must be an integer multiple of ``cfg.fs``;
    every channel runs the same link config. ``feed`` takes wideband IQ
    chunks of any size and returns {channel_index: [RxFrame | RxError]}."""

    def __init__(self, cfg: OfdmConfig, mcs_table: McsTable,
                 preamble: OfdmPreamble, centers_hz: Sequence[float],
                 fs_wide: float, score_threshold: float = 0.5,
                 stopband_db: float = 60.0, device="cuda") -> None:
        self.cfg = cfg
        plan = cfg.carrier_plan
        occ_hz = plan.occupied_half_carriers() / plan.n_fft * cfg.fs
        chan = Channelizer(fs_wide, cfg.fs, centers_hz, passband_hz=occ_hz,
                           stopband_db=stopband_db, device=device)
        super().__init__(chan, [
            OfdmFrameStreamDemod(cfg, mcs_table, preamble, score_threshold,
                                 device=device)
            for _ in range(chan.num_channels)])
