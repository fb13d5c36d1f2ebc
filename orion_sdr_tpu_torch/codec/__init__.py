"""Channel codecs of the port: the FT8/FT4 Gray maps, CRC-14, LDPC(174,
91), frame codecs and stream / many-window decoders, PSK31's, the WSPR
message codec and the RDS block/group codec (counterparts of
``orion_sdr_tpu/codec/``)."""
from .wspr import (WsprMessage, wspr_pack, wspr_unpack, wspr_symbols,
                   wspr_decode_symbols)
from .rds import (RDS_OFFSETS, RDS_GEN, RDS_SYMBOL_RATE, rds_crc10,
                  rds_block_encode, rds_block_classify, rds_groups_0a,
                  rds_groups_2a, rds_encode_groups, rds_decode_bits, RdsData)
