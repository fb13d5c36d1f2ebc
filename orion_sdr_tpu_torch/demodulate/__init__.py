from .dvb_t_frame import (DvbTRxError, DvbTRxFrame, DvbTFrameDemod,
                          scattered_equalize, scattered_equalize_csi,
                          receive_frame_body, dvb_t_blind_decode,
                          DvbTBlindFrame, DvbTHierFrameDemod, DvbTHierRxFrame)
from .dvb_t_super_frame import (DvbTSuperFrameDemod, DvbTRxSuperFrame,
                                DvbTRxSuperFrameError)
from .dvb_t_stream import (DvbTFrameStreamDemod, DvbTHierFrameStreamDemod,
                           DvbTBandStreamDemod)
from .analog import (am_band_demod, AmStation, ssb_band_demod,
                     SsbStation)
from .css import css_demod, CssFrame
from .wspr import wspr_demod, wspr_decode_band
from .fm_stereo import (fm_stereo_demod, FmStereoAudio,
                        fm_band_demod, FmStation)
from .digital import (estimate_cfo_mpsk, fde_equalize, burst_demod,
                      symbol_sync_gardner, symbol_sync_energy,
                      carrier_sync_dd, psk_qam_demod, digital_demod)
from .ais import ais_decode, ais_demod_bits
from .pocsag import pocsag_decode, pocsag_demod_bits
from .afsk import (afsk1200_demod, ax25_decode, rtty_decode,
                   Afsk1200Stream, fsk2_decision, rtty_decode_fsk)
from .adsb import adsb_decode_capture
from .sstv import sstv_demod, SstvImage
from .analog import (cw_demod, am_demod, ssb_demod, SsbDemodState, fm_demod,
                     pm_demod, QuadDemodState)
from .psk31 import (bpsk31_demod, qpsk31_demod, bpsk31_decide,
                    hard_decide_dbpsk, hard_decide_dqpsk)
from .ft8 import ft8_demod, ft4_demod
