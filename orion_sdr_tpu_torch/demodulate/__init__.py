from .dvb_t_frame import (DvbTRxError, DvbTRxFrame, DvbTFrameDemod,
                          scattered_equalize, scattered_equalize_csi,
                          receive_frame_body, dvb_t_blind_decode,
                          DvbTHierFrameDemod, DvbTSuperFrameDemod,
                          DvbTFrameStreamDemod, DvbTBandStreamDemod)
