"""Generic frame CRCs (counterpart of ``orion_sdr_tpu/fec/crc.py``).

Host-side, through the standard library's C routines on the data's buffer
(``binascii.crc_hqx`` is CRC-16/CCITT-FALSE from init 0xFFFF, ``zlib.crc32``
is CRC-32/ISO-HDLC); known answers:
crc16(b"123456789") == 0x29B1, crc32(b"123456789") == 0xCBF43926.
"""

from __future__ import annotations

import binascii
import zlib

import numpy as np


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, np.uint8)


def crc16(data) -> int:
    """CRC-16/CCITT-FALSE: poly 0x1021, init 0xFFFF, non-reflected, no xorout."""
    return binascii.crc_hqx(_as_bytes(data), 0xFFFF)


def crc32(data) -> int:
    """CRC-32/ISO-HDLC: reflected poly 0xEDB88320, init/xorout 0xFFFFFFFF."""
    return zlib.crc32(_as_bytes(data))

