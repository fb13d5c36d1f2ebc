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
