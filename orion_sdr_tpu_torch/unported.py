"""Configurations of the JAX package that the port does not run yet. Each
raises NotImplementedError naming the ROADMAP item that brings it, so a
configuration outside the port never silently changes behaviour."""

from __future__ import annotations

TX_LOWPASS = "ROADMAP queue 1, slice 1: txlp (TX lowpass)"
RX_EXTRAS = "ROADMAP queue 1, slice 1: pilot_interp / cpe / DFT precoding"
DVB_T_HIER = "ROADMAP queue 1, slice 2: hierarchical DVB-T (DvbTHierFrameMod/Demod)"
DVB_T_BLIND = "ROADMAP queue 1, slice 2: dvb_t_blind_decode"
DVB_T_SUPER_FRAME = "ROADMAP queue 1, slice 2: the DVB-T super-frame"
DVB_T_STREAM = "ROADMAP queue 1, slice 2: the DVB-T stream demod"
DVB_T_BAND = "ROADMAP queue 1, slice 2: the DVB-T band receive"
DVB_T_PRESETS = ("ROADMAP queue 1, slice 2: the dvb_t_config / "
                 "dvb_t_scattered_config COFDM presets")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not in the port yet ({item})")
