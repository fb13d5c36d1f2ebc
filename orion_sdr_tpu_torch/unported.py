"""Configurations of the JAX package that the port does not run yet. Each
raises NotImplementedError naming the ROADMAP item that brings it, so a
configuration outside the port never silently changes behaviour."""

from __future__ import annotations

DVB_T_BAND = ("ROADMAP queue 1, slice 5: the DVB-T band receive "
              "(DvbTBandStreamDemod, with dsp/channelizer.py)")
CHANNELIZER = ("ROADMAP queue 1, slice 5: dsp/channelizer.py (the AM/SSB "
               "band receivers am_band_demod and ssb_band_demod)")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not in the port yet ({item})")
