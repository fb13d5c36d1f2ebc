"""Base-42 free-text packing, ≤13 chars → 71 bits (counterpart of
``orion_sdr_tpu/message/free_text.py``; spec: message/free_text.rs).
Python big ints replace the reference's byte-wise multiply-add."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .tables import nchar, charn, FULL


def encode_free_text(text: str) -> Optional[np.ndarray]:
    """Text → 9 bytes (71 bits, big-endian); None if unencodable."""
    if len(text) > 13:
        return None
    v = 0
    for c in text.ljust(13):
        cid = nchar(c, FULL)
        if cid is None:
            return None
        v = v * 42 + cid
    return np.frombuffer(v.to_bytes(9, "big"), np.uint8).copy()


def decode_free_text(b71) -> str:
    """9 bytes → text (leading/trailing spaces trimmed)."""
    v = int.from_bytes(bytes(np.asarray(b71, np.uint8)), "big")
    chars = []
    for _ in range(13):
        chars.append(charn(v % 42, FULL))
        v //= 42
    return "".join(reversed(chars)).strip(" ")
