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
