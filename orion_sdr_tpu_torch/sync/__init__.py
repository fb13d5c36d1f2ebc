from .ofdm_sync import (TrainingSymbol, OfdmPreamble, OfdmSyncResult,
                        generate_ofdm_preamble, training_symbol_freq_pattern,
                        sc_metric, sc_scores, ofdm_sync, first_preamble,
                        estimate_integer_cfo_bins)
from .dvb_t_gi_sync import (GiSyncConfig, GiSyncResult, IntegerCfoResult,
                            dvb_t_gi_sync, dvb_t_gi_refine, dvb_t_integer_cfo)
