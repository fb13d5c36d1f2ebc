"""CRC-14 for FT8/FT4, polynomial 0x2757 (counterpart of
``orion_sdr_tpu/codec/ft8_crc.py``; behavioral spec: codec/crc.rs;
algorithm from the public ft8_lib protocol definition).

The CRC covers the 77-bit payload zero-extended to 82 bits (the 14 CRC bits
are never fed back in). a91 layout (12 bytes): bits 0-76 payload,
bits 77-90 CRC, bits 91-95 zero.

Single frames are checked on the host as in the JAX package. Batches of
decoded rows are checked where they lie with :func:`ft8_check_crc_batch`:
the CRC starts from a zero remainder and has no final XOR, so it is linear
over GF(2) in the payload bits, and a row's 14 check bits are one product
mod 2 with :func:`crc14_check_matrix` — the same function, exact.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

CRC14_POLY = 0x2757
_WIDTH = 14
_TOP = 1 << (_WIDTH - 1)


def ft8_crc14(message: np.ndarray, num_bits: int) -> int:
    """Bitwise CRC-14 over the first ``num_bits`` bits (MSB first)."""
    msg = np.asarray(message, dtype=np.uint8)
    rem = 0
    idx_byte = 0
    for idx_bit in range(num_bits):
        if idx_bit % 8 == 0:
            rem ^= int(msg[idx_byte]) << (_WIDTH - 8)
            idx_byte += 1
        if rem & _TOP:
            rem = ((rem << 1) ^ CRC14_POLY) & 0x3FFF
        else:
            rem = (rem << 1) & 0x3FFF
    return rem


def ft8_add_crc(payload: np.ndarray) -> np.ndarray:
    """77-bit payload (10 bytes) → 91-bit a91 block (12 bytes)."""
    a91 = np.zeros(12, np.uint8)
    a91[:10] = np.asarray(payload, dtype=np.uint8)
    a91[9] &= 0xF8           # slack bits 77-79 must be zero
    checksum = ft8_crc14(a91, 96 - 14)   # bits 0..81
    a91[9] |= (checksum >> 11) & 0x07
    a91[10] = (checksum >> 3) & 0xFF
    a91[11] = (checksum << 5) & 0xFF
    return a91


def ft8_extract_crc(a91: np.ndarray) -> int:
    """CRC from bits 77..90 of a packed a91 block."""
    a = np.asarray(a91, dtype=np.uint8)
    return ((int(a[9]) & 0x07) << 11) | (int(a[10]) << 3) | (int(a[11]) >> 5)


def ft8_check_crc(a91: np.ndarray) -> bool:
    """True iff the embedded CRC matches the payload's CRC."""
    a = np.array(a91, dtype=np.uint8, copy=True)
    extracted = ft8_extract_crc(a)
    a[9] &= 0xF8
    a[10] = 0
    a[11] = 0
    return extracted == ft8_crc14(a, 82)


@lru_cache(maxsize=1)
def crc14_check_matrix() -> np.ndarray:
    """(91, 14) uint8 H over GF(2): row i < 77 holds the CRC bits of the
    unit payload e_i (bit 77 + j of an a91 block is CRC bit 13 - j), rows
    77..90 the identity, so a row of bits 0..90 passes the CRC iff its
    product with H is zero mod 2."""
    h = np.zeros((91, _WIDTH), np.uint8)
    for i in range(77):
        a = np.zeros(12, np.uint8)
        a[i // 8] = 0x80 >> (i % 8)
        crc = ft8_crc14(a, 82)
        h[i] = [(crc >> (_WIDTH - 1 - j)) & 1 for j in range(_WIDTH)]
    h[77:] = np.eye(_WIDTH, dtype=np.uint8)
    return h


_H: dict = {}


def ft8_check_crc_batch(bits: torch.Tensor) -> torch.Tensor:
    """(R, 91) bit rows (a91's bits 0..90) → (R,) bool on their device: True
    where the embedded CRC matches, as :func:`ft8_check_crc` decides for
    each row. One float32 product (sums of at most 91 ones are exact) and a
    reduction mod 2; no loop over rows."""
    h = _H.get(bits.device)
    if h is None:
        h = _H[bits.device] = torch.as_tensor(
            crc14_check_matrix(), dtype=torch.float32, device=bits.device)
    syn = (bits.to(torch.float32) @ h).to(torch.int32) & 1
    return ~syn.bool().any(-1)
