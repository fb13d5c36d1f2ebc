"""Configurations of the JAX package that the port does not run yet. Each
raises NotImplementedError naming the ROADMAP item that brings it, so a
configuration outside the port never silently changes behaviour."""

from __future__ import annotations

TX_LOWPASS = "ROADMAP queue 1, slice 1: txlp (TX lowpass)"
RX_EXTRAS = "ROADMAP queue 1, slice 1: pilot_interp / cpe / DFT precoding"
DVB_T_BAND = ("ROADMAP queue 1, slice 5: the DVB-T band receive "
              "(DvbTBandStreamDemod, with dsp/channelizer.py)")
DVB_T_PRESETS = ("ROADMAP queue 1, slice 1 item 4: the dvb_t_config / "
                 "dvb_t_scattered_config COFDM presets (per-symbol pilot "
                 "layouts)")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not in the port yet ({item})")
