from .types import (
    CodecCache,
    FramePacket, FrameMetadata, RxError,
    OuterFec, InnerFec, InterleaverKind, ScramblerKind, crc_len_bytes,
    SCRAMBLER_BEFORE_OUTER, SCRAMBLER_AFTER_INNER,
    HEADER_ORION_SDR, HEADER_NONE, HEADER_DVB_TPS, header_has_block,
    Mcs, McsTable,
)
from .chain import (
    BCH_INFO_BITS, BlockPlan, block_plan, encode_chain, decode_chain,
    decode_chain_batch, bytes_to_bits, bits_to_bytes, append_crc,
    check_and_strip_crc, scramble_bytes, scramble_bits, apply_pn_to_llrs,
    interleave_bits, deinterleave_bits, deinterleave_llrs,
    outer_encode, outer_decode, inner_encode, inner_decode,
    inner_decode_batch, outer_decode_batch, shortened_bch_for, rs_for,
    CONV_TERMINATED_MAX_INFO,
)
from .modulator import (
    HEADER_FIELD_BYTES, HEADER_CONSTELLATION, HEADER_LDPC,
    pack_header_fields, header_block_plan, symbols_for_coded_bits,
    OfdmFrameMod,
)
from .demodulator import (
    soft_demap, decode_frame_body, OfdmFrameDemod, OfdmFrameStreamDemod,
    RxFrame,
)
from .band import OfdmFrameBandStreamDemod
