from .dvb_t_frame import (DvbTFrame, DvbTFrameMod, DvbTHierFrameMod,
                          assemble_frame, tx_lowpass_for_2k)
from .dvb_t_super_frame import DvbTSuperFrame, DvbTSuperFrameMod
