"""Gray code maps for FT8 (8-FSK) / FT4 (4-FSK) tones (counterpart of
``orion_sdr_tpu/codec/gray.py``; spec: codec/gray.rs; tables from ft8_lib
kFT8_Gray_map / kFT4_Gray_map)."""

import numpy as np

FT8_GRAY = np.array([0, 1, 3, 2, 5, 6, 4, 7], np.uint8)   # binary → tone
FT4_GRAY = np.array([0, 1, 3, 2], np.uint8)

FT8_GRAY_INV = np.argsort(FT8_GRAY).astype(np.uint8)       # tone → binary
FT4_GRAY_INV = np.argsort(FT4_GRAY).astype(np.uint8)


def gray8_encode(bin_idx):
    return FT8_GRAY[np.asarray(bin_idx, np.uint8) & 0x7]


def gray8_decode(tone):
    return FT8_GRAY_INV[np.asarray(tone, np.uint8) & 0x7]


def gray4_encode(bin_idx):
    return FT4_GRAY[np.asarray(bin_idx, np.uint8) & 0x3]


def gray4_decode(tone):
    return FT4_GRAY_INV[np.asarray(tone, np.uint8) & 0x3]
