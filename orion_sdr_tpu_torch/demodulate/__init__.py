from .dvb_t_frame import (DvbTRxError, DvbTRxFrame, DvbTFrameDemod,
                          scattered_equalize, scattered_equalize_csi,
                          receive_frame_body, dvb_t_blind_decode,
                          DvbTBlindFrame, DvbTHierFrameDemod, DvbTHierRxFrame)
from .dvb_t_super_frame import (DvbTSuperFrameDemod, DvbTRxSuperFrame,
                                DvbTRxSuperFrameError)
from .dvb_t_stream import (DvbTFrameStreamDemod, DvbTHierFrameStreamDemod,
                           DvbTBandStreamDemod)
