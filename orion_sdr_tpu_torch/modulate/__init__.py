from .dvb_t_frame import (DvbTFrame, DvbTFrameMod, DvbTHierFrameMod,
                          assemble_frame, tx_lowpass_for_2k)
from .dvb_t_super_frame import DvbTSuperFrame, DvbTSuperFrameMod
from .css import css_mod, css_samples_per_symbol
from .wspr import wspr_mod
from .fm_stereo import (
    fm_stereo_mod, stereo_mpx, rds_manchester,
    FM_STEREO_PILOT_HZ, RDS_CARRIER_HZ, FM_STEREO_MIN_FS,
)
from .digital import (psk_qam_mod, digital_mod, burst_mod,
                      burst_preamble, rrc_taps)
from .ais import ais_mod, AIS_BAUD
from .pocsag import pocsag_mod, POCSAG_PREAMBLE_BITS
from .afsk import (afsk1200_mod, rtty_mod, fsk2_tones, ax25_beacon,
                   nrzi_encode, nrzi_decode, AFSK_BAUD, AFSK_MARK_HZ,
                   AFSK_SPACE_HZ)
from .adsb import adsb_mod, adsb_frame_chips, ADSB_CHIP_RATE
from .sstv import sstv_mod, MARTIN_M1
from .analog import (cw_mod, CwState, am_mod, ssb_mod, SsbState, fm_mod,
                     FmState, pm_mod)
from .dvb_t_super_frame import (DvbTSuperFrameParams,
                                DVB_T_FRAMES_PER_SUPER_FRAME)
from .psk31 import (PSK31_BAUD, PSK31_SPS_8000, PSK31_SPS_12000,
                    PSK31_PREAMBLE_BITS, PSK31_POSTAMBLE_BITS, psk31_sps,
                    psk31_hann, bpsk31_mod_bits, qpsk31_mod_bits,
                    bpsk31_mod_text, qpsk31_mod_text)
from .ft8 import (
    FT8_BAUD, FT8_TONE_SPACING_HZ, FT8_SAMPLES_PER_SYM, FT8_TOTAL_SYMS,
    FT8_DATA_SYMS, FT8_TONES, FT8_FRAME_LEN, FT8_COSTAS,
    FT4_BAUD, FT4_TONE_SPACING_HZ, FT4_SAMPLES_PER_SYM, FT4_TOTAL_SYMS,
    FT4_DATA_SYMS, FT4_TONES, FT4_FRAME_LEN, FT4_COSTAS,
    ft8_mod, ft4_mod, cpfsk_mod, ft8_symbol_sequence, ft4_symbol_sequence,
    ft8_mod_batch, ft4_mod_batch, cpfsk_mod_batch,
)
