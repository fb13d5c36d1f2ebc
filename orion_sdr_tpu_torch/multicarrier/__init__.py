from .plan import CarrierPlan, CarrierPlanError, CarrierGrid
from .ops import (grid_map, map_bits_grid, grid_extract, ofdm_assemble,
                  symbol_taper, symbol_fft, max_pilot_safe_backoff)
from .txlp import TxLowpass
