from .crc import crc16, crc32
from .scrambler import pn_sequence, scramble, PnScramblerStream, DVB_TAPS
from .galois import (GF_EXP, GF_LOG, gf_mul, gf_inv, gf_pow_alpha, Bch,
                     BchError, ReedSolomon, RsError)
from .ldpc import (LDPC_CODES, LdpcGraph, ldpc_graph, ldpc_encode,
                   ldpc_decode, bp_decode, ldpc_syndrome_weight)
from .conv import (CONV_CODES, PUNCTURE, tail_bits, conv_encode,
                   conv_encode_punctured, punctured_coded_len,
                   depuncture_llrs, viterbi_decode_soft,
                   viterbi_decode_soft_chunked)
from .interleave import (block_interleave, block_deinterleave,
                         conv_roundtrip_delay, ForneyState,
                         forney_interleave, forney_deinterleave, forney_flush)
from .sequential import (conv_encode_long, stack_decode, LL_POLY1,
                         LL_POLY2)
from .bch_device import bch_decode_batch_device, rs_decode_batch_device
