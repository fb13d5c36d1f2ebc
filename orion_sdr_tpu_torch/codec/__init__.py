"""Channel codecs of the port: the FT8/FT4 Gray maps, CRC-14, LDPC(174,
91), frame codecs and stream / many-window decoders, PSK31's, the WSPR
message codec, the RDS block/group codec, AX.25/HDLC, Baudot/RTTY, POCSAG,
AIS, Morse and ADS-B (counterparts of ``orion_sdr_tpu/codec/``)."""
from .wspr import (WsprMessage, wspr_pack, wspr_unpack, wspr_symbols,
                   wspr_decode_symbols)
from .rds import (RDS_OFFSETS, RDS_GEN, RDS_SYMBOL_RATE, rds_crc10,
                  rds_block_encode, rds_block_classify, rds_groups_0a,
                  rds_groups_2a, rds_encode_groups, rds_decode_bits, RdsData)
from .ais import (AisPosition, ais_encode_position, ais_parse,
                  ais_frames_to_bits, ais_bits_to_positions)
from .pocsag import (PocsagPage, pocsag_codeword, pocsag_check,
                     pocsag_encode_batches, pocsag_decode_words,
                     POCSAG_SYNC, POCSAG_IDLE)
from .rtty import (BAUDOT_LETTERS, BAUDOT_FIGURES, baudot_encode,
                   baudot_decode, rtty_frame_bits, rtty_unframe_bits,
                   RTTY_BAUD, RTTY_MARK_HZ, RTTY_SPACE_HZ)
from .morse import (MorseEncoder, MORSE_TABLE, MORSE_REVERSE, char_to_morse,
                    MorseBandResult, morse_decode, morse_decode_band)
from .adsb import (AdsbMessage, adsb_crc24, adsb_decode_frame,
                   adsb_encode_identification, adsb_encode_position,
                   adsb_encode_velocity, adsb_pair_positions,
                   cpr_encode, cpr_decode_global)
from .ax25 import (Ax25Frame, ax25_crc, hdlc_encode, hdlc_decode,
                   HDLC_FLAG, AX25_CONTROL_UI, AX25_PID_NONE)
from .varicode import (VARICODE, VARICODE_MAX_BITS, varicode_encode,
                       varicode_decode, VaricodeEncoder, VaricodeDecoder,
                       encode_text, decode_bits)
from .psk31 import (DQPSK_EXP, conv_encode, viterbi_decode,
                    viterbi_decode_coherent, viterbi_decode_hard,
                    StreamingViterbi)
from .gray import (FT8_GRAY, FT4_GRAY, gray8_encode, gray8_decode,
                   gray4_encode, gray4_decode)
from .ft8_crc import (ft8_crc14, ft8_add_crc, ft8_extract_crc, ft8_check_crc,
                      CRC14_POLY)
from . import ft8_ldpc
from .ft8 import (FT4_XOR, ft8_encode, ft4_encode, ft8_decode_soft,
                  ft4_decode_soft, ft8_decode_hard, ft4_decode_hard,
                  ft8_frame_llr_hard, ft4_frame_llr_hard)
