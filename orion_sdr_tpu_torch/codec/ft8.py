"""FT8/FT4 channel codecs (counterpart of ``orion_sdr_tpu/codec/ft8.py``;
behavioral spec: codec/ft8.rs, codec/ft4.rs).

Encode: 77-bit payload → CRC-14 → LDPC(174,91) → Gray → tone indices
(58 × 3-bit for FT8, 87 × 2-bit for FT4; FT4 additionally XOR-scrambles the
payload before the CRC). Decode: LLRs → LDPC BP → CRC check → payload.

A frame's bit↔byte plumbing is numpy on the host; the LDPC encode and
decode run on the device. Decodes batch over rows: :func:`decode_soft_batch`
gives what :func:`ft8_decode_soft` gives for each row of an (R, 174) LLR
tensor, under one or more a-priori priors, from one BP launch, with each
row's CRC and prior checked on the device; only the rows that pass are
packed on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .ft8_crc import ft8_add_crc, ft8_check_crc_batch
from .gray import gray8_encode, gray8_decode, gray4_encode, gray4_decode
from . import ft8_ldpc

FT8_DATA_SYMS = 58
FT4_DATA_SYMS = 87

# FT4 payload XOR scramble (ft8_lib kFT4_XOR_sequence).
FT4_XOR = np.array([0x4A, 0x5E, 0x89, 0xB4, 0xB0, 0x8A, 0x79, 0x55, 0xBE,
                    0x28], np.uint8)


def _payload_to_codeword_bits(payload: np.ndarray, device) -> np.ndarray:
    """payload (10 bytes) → (174,) codeword bits via CRC + LDPC (the
    product on ``device``)."""
    a91 = ft8_add_crc(payload)
    msg_bits = torch.as_tensor(np.unpackbits(a91)[:ft8_ldpc.K], device=device)
    return ft8_ldpc.ldpc_encode(msg_bits).cpu().numpy()


def ft8_encode(payload, *, device="cuda") -> np.ndarray:
    """77-bit payload (10 bytes) → 58 Gray-coded tone indices (0-7)."""
    cw = _payload_to_codeword_bits(np.asarray(payload, np.uint8), device)
    bins = cw.reshape(FT8_DATA_SYMS, 3) @ np.array([4, 2, 1], np.uint8)
    return gray8_encode(bins)


def ft4_encode(payload, *, device="cuda") -> np.ndarray:
    """77-bit payload (10 bytes) → 87 Gray-coded tone indices (0-3)."""
    scrambled = (np.asarray(payload, np.uint8) ^ FT4_XOR).astype(np.uint8)
    cw = _payload_to_codeword_bits(scrambled, device)
    bins = cw.reshape(FT4_DATA_SYMS, 2) @ np.array([2, 1], np.uint8)
    return gray4_encode(bins)


def _payload(bits: np.ndarray, ft4: bool) -> np.ndarray:
    """91 decoded bits → 10-byte payload (bits 77-79 cleared; FT4
    descrambled)."""
    payload = np.packbits(np.concatenate([bits.astype(np.uint8),
                                          np.zeros(5, np.uint8)]))[:10]
    payload[9] &= 0xF8
    if ft4:
        payload = (payload ^ FT4_XOR).astype(np.uint8)
        payload[9] &= 0xF8
    return payload


def _ap_tensors(ap, device):
    idx, bits = ap
    return (torch.as_tensor(np.asarray(idx, np.int64), device=device),
            torch.as_tensor(np.asarray(bits, np.uint8), device=device))


def ft8_ap_prior(call_a: Optional[str] = None, call_b: Optional[str] = None,
                 hash_table=None, ft4: bool = False):
    """A-priori decoding prior (WSJT-X "AP" — beyond the reference).

    A caller usually knows part of the message it is listening for: "CQ"
    in the first callsign slot, or its own call in either slot. The
    standard-message layout (message/message.py) is c28a r1a c28b r1b R1
    g15 i3, so fixing a slot pins 29 systematic codeword bits. Returns
    ``(positions, bits)`` over the 174-bit codeword, suitable for
    :func:`ft8_decode_soft`'s ``ap=`` argument (``ft4=True`` applies the
    FT4 payload scrambling so the bits are in codeword domain).
    """
    from ..message.callsign import pack28
    from ..message import CallsignHashTable
    ht = hash_table if hash_table is not None else CallsignHashTable()
    xor_bits = np.unpackbits(FT4_XOR)[:77] if ft4 else np.zeros(77, np.uint8)
    idx: list = []
    val: list = []
    for call, base in ((call_a, 0), (call_b, 29)):
        if call is None:
            continue
        packed = pack28(call, ht)
        if packed is None:
            raise ValueError(f"cannot pack callsign {call!r} for AP")
        n28, ip = packed
        b = np.unpackbits(np.array([(n28 >> 24) & 255, (n28 >> 16) & 255,
                                    (n28 >> 8) & 255, n28 & 255],
                                   np.uint8))[4:]
        bits29 = np.concatenate([b, [np.uint8(ip)]])
        pos = np.arange(base, base + 29)
        idx.append(pos)
        val.append(bits29 ^ xor_bits[pos])
    if not idx:
        raise ValueError("ft8_ap_prior needs at least one callsign")
    return (np.concatenate(idx).astype(np.int64),
            np.concatenate(val).astype(np.uint8))


def _clamp(llr: torch.Tensor, ap, amp: torch.Tensor) -> torch.Tensor:
    idx, bits = _ap_tensors(ap, llr.device)
    out = llr.to(torch.float32).clone()
    amp = amp.to(torch.float32)
    out[..., idx] = torch.where(bits == 0, amp, -amp)
    return out


def apply_ap_prior(llr, ap, amp: Optional[float] = None) -> torch.Tensor:
    """Clamp the known-bit positions of (..., 174) LLRs (a tensor, or host
    data) to ±``amp`` (default 4·rms + 8 over all of ``llr`` — dominant but
    finite, mirroring WSJT-X); a new float32 tensor on ``llr``'s device."""
    x = torch.as_tensor(llr).to(torch.float32)
    if amp is None:
        a = 4.0 * torch.sqrt(torch.mean(x ** 2)) + 8.0
    else:
        a = torch.tensor(float(amp), device=x.device)
    return _clamp(x, ap, a)


def _apply_ap_rows(llr: torch.Tensor, ap) -> torch.Tensor:
    """Each row of (R, 174) ``llr`` clamped as :func:`apply_ap_prior`
    clamps that row alone (its own default amplitude)."""
    amp = 4.0 * torch.sqrt(torch.mean(llr ** 2, dim=-1, keepdim=True)) + 8.0
    return _clamp(llr, ap, amp)


def _decode_rows(llr: torch.Tensor, max_iter: int, priors: Sequence,
                 per_row: bool = True):
    """The rows of (R, 174) ``llr`` under each prior of ``priors`` in turn
    (None: as they are; else clamped by :func:`_apply_ap_rows`, or by
    :func:`apply_ap_prior` over all of ``llr`` when not ``per_row``) →
    ((P·R, 91) uint8 bits, (P·R,) bool ok) on ``llr``'s device, from one BP
    launch: ok where BP reached a codeword, the CRC matches and the decoded
    bits reproduce the row's prior."""
    x = llr.to(torch.float32)
    clamp = _apply_ap_rows if per_row else apply_ap_prior
    rows = torch.cat([x if p is None else clamp(x, p)
                      for p in priors]).contiguous()
    bits, errs = ft8_ldpc.ldpc_decode_soft(rows, max_iter)
    ok = (errs == 0) & ft8_check_crc_batch(bits)
    R = x.shape[0]
    for i, p in enumerate(priors):
        if p is not None:
            idx, want = _ap_tensors(p, bits.device)
            rows_i = slice(i * R, (i + 1) * R)
            ok[rows_i] &= (bits[rows_i][:, idx] == want).all(-1)
    return bits, ok


def decode_soft_batch(llr: torch.Tensor, max_iter: int = 20,
                      priors: Sequence = (None,), ft4: bool = False
                      ) -> List[List[Optional[np.ndarray]]]:
    """For each prior ``p`` of ``priors`` (None: no prior) and each row
    ``r`` of the (R, 174) LLR tensor: what ``ft8_decode_soft(llr[r],
    max_iter, ap=p)`` (``ft4_decode_soft`` with ``ft4``) returns — the
    payload, or None. One BP launch over every row of every prior, on
    ``llr``'s device; the CRC and prior checks run there too."""
    R = llr.shape[0]
    bits, ok = _decode_rows(llr, max_iter, priors)
    bits, ok = bits.cpu().numpy(), ok.cpu().numpy()
    return [[_payload(bits[i * R + r], ft4) if ok[i * R + r] else None
             for r in range(R)] for i in range(len(priors))]


def _soft(llr, max_iter, ap, ft4, device):
    x = torch.as_tensor(llr, device=device).to(torch.float32).reshape(1, -1)
    return decode_soft_batch(x, max_iter, (ap,), ft4)[0][0]


def _decode_llr(llr, max_iter: int = 20, *, device="cuda"
                ) -> Optional[np.ndarray]:
    """174 LLRs → 10-byte payload (still scrambled for FT4) or None."""
    return _soft(llr, max_iter, None, False, device)


def ft8_decode_soft(llr, max_iter: int = 20, ap=None, *, device="cuda"
                    ) -> Optional[np.ndarray]:
    """174 soft LLRs (positive ⇒ bit 0) → 77-bit payload or None, decoded
    on ``device``.

    ``ap``: optional ``(positions, bits)`` a-priori prior from
    :func:`ft8_ap_prior`; the known bits are clamped before BP and the
    decode is rejected unless the result reproduces them (guards the
    CRC-14 against prior-seeded false converges).
    """
    return _soft(llr, max_iter, ap, False, device)


def ft4_decode_soft(llr, max_iter: int = 20, ap=None, *, device="cuda"
                    ) -> Optional[np.ndarray]:
    """``ap``: prior from ``ft8_ap_prior(..., ft4=True)`` — bits are in the
    scrambled codeword domain, verified there before descrambling."""
    return _soft(llr, max_iter, ap, True, device)


def ft8_frame_llr_hard(tones) -> np.ndarray:
    """Hard tone decisions → ±10 LLRs (ref frame_to_llr_hard)."""
    bins = gray8_decode(np.asarray(tones, np.uint8))
    bits = np.unpackbits(bins[:, None], axis=1)[:, 5:8].reshape(-1)
    return np.where(bits == 0, 10.0, -10.0).astype(np.float32)


def ft4_frame_llr_hard(tones) -> np.ndarray:
    bins = gray4_decode(np.asarray(tones, np.uint8))
    bits = np.unpackbits(bins[:, None], axis=1)[:, 6:8].reshape(-1)
    return np.where(bits == 0, 10.0, -10.0).astype(np.float32)


def ft8_decode_hard(tones, max_iter: int = 20, *, device="cuda"
                    ) -> Optional[np.ndarray]:
    return ft8_decode_soft(ft8_frame_llr_hard(tones), max_iter, device=device)


def ft4_decode_hard(tones, max_iter: int = 20, *, device="cuda"
                    ) -> Optional[np.ndarray]:
    return ft4_decode_soft(ft4_frame_llr_hard(tones), max_iter, device=device)
