"""FT8/FT4 channel codecs of the port: Gray maps, CRC-14, LDPC(174, 91),
the frame codecs and the stream / many-window decoders (counterparts of
``orion_sdr_tpu/codec/{gray,ft8_crc,ft8_ldpc,ft8,ft8_stream}.py``)."""
