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
