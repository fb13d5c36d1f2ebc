from .dvb_t import (
    DVB_T_PRBS_INIT, dvb_t_prbs_bits, dvb_t_prbs_bytes, energy_disperse,
    DVB_T_AXIS, DVB_T_ALPHAS, dvb_t_axis, axis_scale,
    is_dvb_t_constellation, dvb_t_map_symbols, dvb_t_demap_symbols,
    dvb_t_soft_llrs,
    DVB_T_N_FFT, DVB_T_KMAX, DVB_T_ACTIVE_CARRIERS, DVB_T_DATA_CARRIERS,
    DVB_T_CONTINUAL_PILOTS_2K, DVB_T_TPS_CARRIERS_2K, DVB_T_SCATTERED_PHASES,
    DVB_T_SCATTERED_PILOT_SPACING, DVB_T_MAX_RX_WINDOW_BACKOFF,
    GUARD_INTERVALS, guard_cp_len_2k, guard_from_cp_len_2k,
    active_to_signed, active_to_bin, wk_prbs, boosted_pilot_value,
    scattered_pilot_indices, tps_carrier_bins, continual_pilot_bins,
    dvb_t_2k_plan, ScatteredGrid, scattered_grid, dvb_t_2k_plans,
    scattered_map_frame, scattered_extract_frame,
    dvb_t_fs_for_bandwidth, dvb_t_occupied_bw, NB_BANDWIDTHS,
    DVB_T_FS_333KHZ, DVB_T_FS_1MHZ, DVB_T_FS_2MHZ,
    dvb_t_mcs_table, dvb_t_config, dvb_t_scattered_config,
    dvb_t_frame_outer, dvb_t_frame_outer_il, DvbTLinkParams,
    DvbTFrameParams, DvbTHierLinkParams, DvbTHierFrameParams,
    DVB_T_FRAMES_PER_SUPER_FRAME, DvbTSuperFrameParams,
)
from .dvb_t_tps import (TpsWord, TpsDecoder, tps_bch_encode, tps_bch_decode,
                        tps_encode_frame, tps_decode_frame,
                        tps_reference_signs, TPS_SYMBOLS_PER_FRAME,
                        TPS_CARRIER_COUNT)
from .dvb_t_ts import (TS_PACKET_LEN, TS_PAYLOAD_LEN, TS_SYNC_BYTE,
                       ts_energy_disperse, ts_packetize, ts_null_packet,
                       ts_stuff_null_packets, ts_depacketize)
from .dvb_t import dvb_t_map_symbol
from .dvb_t_tps import (TPS_SYNC_WORD_13, TPS_SYNC_WORD_24, TPS_CODEWORD_BITS,
                        TPS_INFO_BITS)
from .dvb_t_ts import TS_SYNC_BYTE_INVERTED, TS_DISPERSAL_GROUP
