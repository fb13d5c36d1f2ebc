from .dvb_t_frame import (DvbTFrame, DvbTFrameMod, DvbTHierFrameMod,
                          DvbTSuperFrameMod, assemble_frame,
                          tx_lowpass_for_2k)
