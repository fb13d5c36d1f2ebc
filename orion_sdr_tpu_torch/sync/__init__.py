from .ofdm_sync import (TrainingSymbol, OfdmPreamble, OfdmSyncResult,
                        generate_ofdm_preamble, training_symbol_freq_pattern,
                        sc_metric, sc_scores, ofdm_sync, first_preamble,
                        estimate_integer_cfo_bins)
from .dvb_t_gi_sync import (GiSyncConfig, GiSyncResult, IntegerCfoResult,
                            dvb_t_gi_sync, dvb_t_gi_refine, dvb_t_integer_cfo)
from .ofdm_sync import pseudo_random_unit_sequence
from .waterfall import compute_waterfall
from .costas import Candidate, costas_score, find_candidates
# ``ft8_sync`` and ``psk31_sync`` are the functions, as in the JAX package;
# the modules of the same names stay importable through the import system.
from .psk31_sync import psk31_sync, best_sync, Psk31SyncResult
from .ft8_sync import ft8_sync, ft4_sync, FtSyncResult
