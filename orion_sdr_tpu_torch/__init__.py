"""orion_sdr_tpu_torch — the PyTorch/CUDA port of orion_sdr_tpu.

Everything the JAX package does. The coded COFDM frame link
(LDPC or convolutional inner code, BCH or RS outer code, block/Forney
interleavers, additive or DVB scramblers): frame modulation, batch and
streaming demodulation. And the conformant DVB-T 2K receive chain:
``DvbTFrameMod`` and ``DvbTFrameDemod`` (GI acquisition, scattered
pilots, TPS, K=7 Viterbi, Forney, RS(204,188)), the hierarchical link
(``DvbTHierFrameMod``/``DvbTHierFrameDemod``), blind decode, the
super-frame and the stream receivers. And FT8/FT4: CPFSK TX, message
packing, the batched many-window receive (``ft8_decode_windows``:
waterfall, Costas search, LLRs and one BP launch for every candidate of
every window, on the card), the stream, multi-frame and multi-signal
decoders. And the analog modes and PSK31: the DSP layer (parallel-scan
IIR sections, FIR, AGC, rational resampling), CW/AM/SSB/FM/PM modulators
and demodulators, BPSK31/QPSK31 modulation, the decision-feedback demod,
carrier search, the whole-band decode and the stream decoder. And
whole-band gateway receive: the streaming channelizer and the polyphase
filter bank (``dsp/channelizer.py``, ``dsp/pfb.py``) with the band
receivers on top of them (COFDM, DVB-T, AM, SSB, FM stereo), FM stereo
with RDS, chirp spread spectrum and WSPR (stack-decoded K=32 code). And
the single-carrier burst modem (RRC shaping, polyphase-energy and Gardner
timing, the decision-directed carrier PLL), GPS L1 C/A acquisition,
tracking and LNAV decode, and the 2-FSK family (AX.25 over AFSK-1200,
RTTY, POCSAG, AIS). And the capture-to-text receivers: capture file I/O,
the channel simulator (CFO, phase noise, I/Q imbalance, static and fading
multipath, Watterson), the Morse encoder and CW skimmer, blind
classification with the band survey and band decode, ADS-B and SSTV.
And the generic OFDM receive with OTFS, the drop-in Block classes
(``blocks.py``), checkpoint/resume of the streaming receivers
(``checkpoint.py``) and the JAX package's flat namespace. And the
multi-device layer (``parallel``): a mesh of shards driven by one process
(several on one card, or one a card), channel- and time-sharded paths with
their halos and gathers, the time-sharded DVB-T and COFDM decodes, and
reductions across processes through ``torch.distributed``. Eight
hand-written Hopper kernels carry them: LDPC belief propagation
(``ops/ldpc_bp.py``, ``csrc/ldpc_bp.cu``, four check rules), the Viterbi
ACS + traceback (``ops/viterbi.py``, ``csrc/viterbi.cu``, radix 2 and 4),
the BCH/RS outer decoder
(``ops/outer_fec.py``, ``csrc/outer_fec.cu``), the PSK31 PLL recurrence
(``ops/psk31_pll.py``, ``csrc/psk31_pll.cu``), the two-rate one-pole
envelope of the AGC and the CW keyer (``ops/onepole_two_rate.py``,
``csrc/onepole_two_rate.cu``), the burst modem's DD-PLL
(``ops/dd_pll.py``, ``csrc/dd_pll.cu``) and Gardner loop
(``ops/gardner.py``, ``csrc/gardner.cu``), and the GPS tracking loops
(``ops/gnss_track.py``, ``csrc/gnss_track.cu``). Every constructor and
entry point that takes host data takes ``device`` (default "cuda"; "cpu"
runs the kernels' plain versions); at the frame layer bytes go in and
numpy complex64 IQ comes out, as in the JAX package.
"""

from . import constellation
from .constellation import map_bits, decide, soft_llr, BITS_PER_SYMBOL
from .frame import (
    CodecCache,
    FramePacket, FrameMetadata, RxError,
    OuterFec, InnerFec, InterleaverKind, ScramblerKind, crc_len_bytes,
    SCRAMBLER_BEFORE_OUTER, SCRAMBLER_AFTER_INNER,
    HEADER_ORION_SDR, HEADER_NONE, HEADER_DVB_TPS, header_has_block,
    Mcs, McsTable,
    BCH_INFO_BITS, BlockPlan, block_plan, encode_chain, decode_chain,
    decode_chain_batch, bytes_to_bits, bits_to_bytes, append_crc,
    check_and_strip_crc, scramble_bytes, scramble_bits, apply_pn_to_llrs,
    interleave_bits, deinterleave_bits, deinterleave_llrs,
    outer_encode, outer_decode, inner_encode, inner_decode,
    inner_decode_batch, outer_decode_batch, shortened_bch_for, rs_for,
    CONV_TERMINATED_MAX_INFO,
    HEADER_FIELD_BYTES, HEADER_CONSTELLATION, HEADER_LDPC,
    pack_header_fields, header_block_plan, symbols_for_coded_bits,
    OfdmFrameMod,
    soft_demap, decode_frame_body, OfdmFrameDemod, OfdmFrameStreamDemod,
    RxFrame, OfdmFrameBandStreamDemod,
)
from . import multicarrier
from .multicarrier import CarrierPlan, CarrierGrid, TxLowpass
from . import ofdm as ofdm_mod_api
from .ofdm import (
    OfdmConfig, ofdm_mod, ofdm_demod, ofdm_decide, ofdm_soft_demod,
    zf_equalize, channel_estimate_training, channel_estimate_pilots,
    channel_estimate_denoise, cpe_correct, cpe_raw_phases, cpe_unwrap,
    dft_precode, dft_deprecode, mmse_equalize,
    OfdmRxFrame, build_ofdm_rx_frame,
)
from . import otfs
from .otfs import isfft, sfft, otfs_mod, otfs_demod, otfs_num_symbols
from .sync.ofdm_sync import (OfdmPreamble, TrainingSymbol, ofdm_sync,
                             generate_ofdm_preamble)
from .waveform import (DvbTLinkParams, DvbTFrameParams, DvbTSuperFrameParams,
                       DvbTHierLinkParams, DvbTHierFrameParams, TpsWord,
                       dvb_t_mcs_table, energy_disperse, dvb_t_config,
                       dvb_t_scattered_config, DVB_T_MAX_RX_WINDOW_BACKOFF)
from .modulate import (DvbTFrame, DvbTFrameMod, DvbTHierFrameMod,
                       DvbTSuperFrame, DvbTSuperFrameMod, tx_lowpass_for_2k)
from .demodulate import (DvbTFrameDemod, DvbTRxError, DvbTRxFrame,
                         DvbTHierFrameDemod, DvbTHierRxFrame,
                         dvb_t_blind_decode, DvbTBlindFrame,
                         DvbTSuperFrameDemod, DvbTRxSuperFrame,
                         DvbTRxSuperFrameError, DvbTFrameStreamDemod,
                         DvbTHierFrameStreamDemod, DvbTBandStreamDemod)

# ── FT8/FT4 (message packing, CPFSK TX, sync, the many-window receive) ───────
from .modulate.ft8 import ft8_mod, ft4_mod, ft8_mod_batch, ft4_mod_batch
from .demodulate.ft8 import ft8_demod, ft4_demod
from .codec.ft8 import (
    ft8_encode, ft4_encode, ft8_decode_soft, ft4_decode_soft,
    ft8_decode_hard, ft4_decode_hard, ft8_ap_prior, apply_ap_prior,
)
from .codec.ft8_stream import (Ft8StreamDecoder, Ft8DecodeResult,
                               ft8_decode_windows, ft4_decode_windows,
                               ft8_decode_multi_frame, ft4_decode_multi_frame,
                               ft8_decode_multi_signal,
                               ft4_decode_multi_signal)
from .sync.ft8_sync import (ft8_sync, ft4_sync, ft8_sync_batch,
                            ft4_sync_batch)
from . import message
from .message import (
    pack77, unpack77, CallsignHashTable,
    ft8_pack_standard, ft8_pack_free_text, ft8_pack_telemetry, ft8_unpack,
    Standard as Ft8Standard, FreeText as Ft8FreeText,
    NonStd as Ft8NonStd, Telemetry as Ft8Telemetry,
)

# ── analog modes and PSK31 (the DSP layer is under ``dsp``) ─────────────────
from . import util
from .util import (rms, hann, tone, gen_complex_tone, snr_db_at,
                   power_spectrum, nb_spectrum_snr_db, wb_spectrum_snr_db,
                   spectrum_bw_hz, SIGNAL_THRESHOLD, PSK31_BW_HZ, awgn,
                   atan2_approx, spectrum_scan, SpectrumSegment, measure,
                   trace)
from .modulate.analog import cw_mod, am_mod, ssb_mod, fm_mod, pm_mod
from .demodulate.analog import (cw_demod, cw_envelope_multi, am_demod,
                                ssb_demod, fm_demod, pm_demod,
                                am_band_demod, AmStation,
                                ssb_band_demod, SsbStation)
from .codec.varicode import (VaricodeEncoder, VaricodeDecoder,
                             varicode_encode, varicode_decode)
from .modulate.psk31 import (bpsk31_mod_bits, qpsk31_mod_bits,
                             bpsk31_mod_text, qpsk31_mod_text)
from .demodulate.psk31 import bpsk31_demod, qpsk31_demod, bpsk31_decide
from .sync.psk31_sync import psk31_sync, best_sync as best_psk31_sync
from .codec.psk31_stream import Psk31Stream, Psk31BandResult, \
    psk31_decode_band

# ── slice 5a: channelizers, FM stereo + RDS, CSS, WSPR ──────────────────────
from .dsp.channelizer import Channelizer, band_compose
from .dsp.pfb import pfb_channelize, pfb_channel_freqs, pfb_prototype
from .modulate.fm_stereo import (fm_stereo_mod, stereo_mpx, rds_manchester,
                                 FM_STEREO_PILOT_HZ, RDS_CARRIER_HZ)
from .demodulate.fm_stereo import (fm_stereo_demod, FmStereoAudio,
                                   fm_band_demod, FmStation)
from .codec.rds import (RDS_OFFSETS, rds_crc10, rds_block_encode,
                        rds_groups_0a, rds_groups_2a, rds_encode_groups,
                        rds_decode_bits, RdsData)
from .modulate.css import css_mod
from .demodulate.css import css_demod, CssFrame
from .fec.sequential import conv_encode_long, stack_decode
from .codec.wspr import WsprMessage, wspr_pack, wspr_unpack
from .modulate.wspr import wspr_mod
from .demodulate.wspr import wspr_demod, wspr_decode_band

# ── slice 5b: the burst modem, GNSS, the 2-FSK family ──────────────────────
from .modulate.digital import (psk_qam_mod, digital_mod, burst_mod,
                               burst_preamble, rrc_taps)
from .demodulate.digital import (psk_qam_demod, digital_demod,
                                 estimate_cfo_mpsk, fde_equalize,
                                 burst_demod, symbol_sync_gardner,
                                 symbol_sync_energy, carrier_sync_dd)
from .gnss import (GPS_NAV_PREAMBLE, GpsAcquisition, GpsTrack, gps_ca_code,
                   gps_ca_mod, gps_acquire, gps_track, gps_nav_frame_sync)
from .gnss_nav import (GpsEphemeris, GpsNavFrame, GpsSubframe,
                       GpsAlmanac, GpsIono, GpsUtc,
                       nav_word_encode, nav_word_check,
                       nav_subframes_encode, nav_subframes_decode,
                       almanac_page_words, iono_utc_page_words,
                       eph_sat_pos, alm_sat_pos, klobuchar_delay,
                       gps_fix, gps_decode_ephemeris)
from .codec.ais import AisPosition
from .modulate.ais import ais_mod
from .demodulate.ais import ais_decode
from .codec.pocsag import PocsagPage, pocsag_codeword, pocsag_check
from .modulate.pocsag import pocsag_mod
from .demodulate.pocsag import pocsag_decode
from .codec.ax25 import Ax25Frame, ax25_crc, hdlc_encode, hdlc_decode
from .modulate.afsk import (afsk1200_mod, ax25_beacon, nrzi_encode,
                            nrzi_decode, AFSK_BAUD, rtty_mod)
from .demodulate.afsk import (afsk1200_demod, ax25_decode,
                              rtty_decode, Afsk1200Stream)
from .codec.rtty import baudot_encode, baudot_decode

# ── slice 6a: capture I/O, the channel simulator, Morse, classification and
# band decode, ADS-B, SSTV ───────────────────────────────────────────────────
from . import io
from .io import (write_iq_wav, read_iq_wav, write_audio_wav, read_audio_wav,
                 write_iq_npy, read_iq_npy)
from .channel import (cfo_apply, phase_noise_apply, iq_imbalance_apply,
                      multipath_apply, fading_taps, fading_apply,
                      watterson_apply)
from .codec.morse import (MorseEncoder, MorseBandResult, morse_decode,
                          morse_decode_band)
from .classify import (classify_signal, band_survey, band_decode,
                       SignalClass, SurveyEntry, BandDecodeEntry)
from .codec.adsb import (AdsbMessage, adsb_crc24, adsb_decode_frame,
                         adsb_encode_identification, adsb_encode_position,
                         adsb_encode_velocity, cpr_encode, cpr_decode_global)
from .modulate.adsb import adsb_mod
from .demodulate.adsb import adsb_decode_capture
from .modulate.sstv import sstv_mod
from .demodulate.sstv import sstv_demod, SstvImage

# ── slice 6b: the drop-in Block classes, checkpoint/resume, the NB helpers ──
from . import blocks
from .blocks import (
    CwKeyedMod, CwEnvelopeDemod, AmDsbMod, AmEnvelopeDemod,
    SsbPhasingMod, SsbProductDemod, FmPhaseAccumMod, FmQuadratureDemod,
    PmDirectPhaseMod, PmQuadratureDemod,
    BpskMod, BpskDemod, QpskMod, QpskDemod, QamMod, QamDemod,
    Ft8Mod, Ft8Demod, Ft8Codec, Ft4Mod, Ft4Demod, Ft4Codec,
    Bpsk31Mod, Bpsk31Demod, Bpsk31Decider, Qpsk31Mod, Qpsk31Demod,
    OfdmMod, OfdmDemod,
)
from . import checkpoint
from .checkpoint import (save_checkpoint, load_checkpoint, state_dict,
                         load_state_dict)

# ── slice 7: the multi-device layer (a mesh of shards in one process) ───────
from . import parallel

# the reference's NB/bandwidth helper names
from .waveform.dvb_t import (
    dvb_t_fs_for_bandwidth as nb_bandwidth_fs,
    dvb_t_occupied_bw as nb_bandwidth_occupied_hz,
    guard_cp_len_2k as dvb_t_cp_len,
)


def dvb_t_max_rx_window_backoff() -> int:
    """The largest RX window backoff the 2K scattered pilots carry."""
    return DVB_T_MAX_RX_WINDOW_BACKOFF


def dvb_t_tx_lowpass_suggested_taps(stopband_db: float) -> int:
    """Taps of a TX lowpass centred in the 2K null band at
    ``stopband_db``."""
    from .waveform.dvb_t import DVB_T_N_FFT, DVB_T_KMAX
    return TxLowpass.taps_for_null_band(DVB_T_N_FFT, DVB_T_KMAX // 2,
                                        stopband_db)


def dvb_t_tx_lowpass_group_delay(num_taps: int) -> int:
    return (num_taps - 1) // 2


def dvb_t_tx_lowpass_fits_guard(num_taps: int, cp_len: int, roll_off: int,
                                backoff: int) -> bool:
    """Whether the TX lowpass's group delay plus the window roll-off fits
    the guard left by the RX window backoff."""
    gd = dvb_t_tx_lowpass_group_delay(num_taps)
    return roll_off + gd <= min(cp_len - backoff, backoff)
