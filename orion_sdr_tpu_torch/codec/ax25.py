"""AX.25 packet radio framing, the HDLC bit layer and UI frames (the
port's own copy of ``orion_sdr_tpu/codec/ax25.py``, numpy, bit-exact with
it). The AFSK-1200 physical layer lives in modulate/afsk.py /
demodulate/afsk.py.

Bit layer (host numpy):
* HDLC: 0x7E flags, bit stuffing (a 0 inserted after five consecutive 1s),
  LSB-first byte serialization, frame check sequence appended little-endian.
* FCS: CRC-16/X.25 (poly 0x1021 reflected = 0x8408, init 0xFFFF, final
  XOR 0xFFFF).
* AX.25 v2 UI frames: callsign-shifted address fields (chars << 1, SSID
  byte with extension bit on the last address), control 0x03, PID 0xF0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

HDLC_FLAG = 0x7E
AX25_CONTROL_UI = 0x03
AX25_PID_NONE = 0xF0


def ax25_crc(data: bytes) -> int:
    """CRC-16/X.25 over ``data`` (reflected 0x1021, init/xorout 0xFFFF)."""
    crc = 0xFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return crc ^ 0xFFFF


def _encode_address(call: str, last: bool) -> bytes:
    """'CALL-SSID' → 7 shifted bytes; extension bit set on the last field."""
    call = call.strip().upper()
    ssid = 0
    if "-" in call:
        call, s = call.rsplit("-", 1)
        ssid = int(s)
    if not (0 <= ssid <= 15):
        raise ValueError(f"SSID must be 0..15, got {ssid}")
    if not (1 <= len(call) <= 6) or not call.isalnum():
        raise ValueError(f"callsign must be 1-6 alphanumerics, got {call!r}")
    addr = bytes((ord(c) << 1) & 0xFF for c in call.ljust(6))
    ssid_byte = 0x60 | (ssid << 1) | (1 if last else 0)
    return addr + bytes([ssid_byte])


def _decode_address(b: bytes) -> Tuple[str, bool]:
    call = "".join(chr(x >> 1) for x in b[:6]).rstrip()
    ssid = (b[6] >> 1) & 0x0F
    last = bool(b[6] & 1)
    return (f"{call}-{ssid}" if ssid else call), last


@dataclass
class Ax25Frame:
    """One UI frame (the APRS/beacon workhorse)."""
    dest: str = "CQ"
    src: str = "N0CALL"
    payload: bytes = b""
    digis: Tuple[str, ...] = ()
    pid: int = AX25_PID_NONE

    def encode(self) -> bytes:
        addrs = [_encode_address(self.dest, False),
                 _encode_address(self.src, not self.digis)]
        for i, d in enumerate(self.digis):
            addrs.append(_encode_address(d, i == len(self.digis) - 1))
        body = b"".join(addrs) + bytes([AX25_CONTROL_UI, self.pid]) \
            + bytes(self.payload)
        fcs = ax25_crc(body)
        return body + bytes([fcs & 0xFF, (fcs >> 8) & 0xFF])

    @classmethod
    def parse(cls, frame: bytes) -> Optional["Ax25Frame"]:
        """Validated frame bytes (FCS included) → Ax25Frame | None."""
        if len(frame) < 7 * 2 + 2 + 2:
            return None
        body, fcs_lo, fcs_hi = frame[:-2], frame[-2], frame[-1]
        if ax25_crc(body) != (fcs_hi << 8) | fcs_lo:
            return None
        dest, last = _decode_address(body[0:7])
        if last:
            return None
        addrs, i = [dest], 7
        while True:
            if i + 7 > len(body):
                return None
            a, last = _decode_address(body[i:i + 7])
            addrs.append(a)
            i += 7
            if last:
                break
            if len(addrs) > 10:
                return None
        if i + 2 > len(body) or body[i] != AX25_CONTROL_UI:
            return None
        return cls(dest=addrs[0], src=addrs[1], digis=tuple(addrs[2:]),
                   pid=body[i + 1], payload=bytes(body[i + 2:]))


def hdlc_encode(frames, lead_flags: int = 8, tail_flags: int = 2,
                inter_flags: int = 4) -> np.ndarray:
    """Frame byte strings → one HDLC bit stream (uint8 bits): lead-in
    flags, per-frame LSB-first serialization with bit stuffing, flag
    separators."""
    out: List[np.ndarray] = []
    flag_bits = np.unpackbits(np.uint8([HDLC_FLAG]), bitorder="little")

    def flags(n):
        return np.tile(flag_bits, n)

    out.append(flags(lead_flags))
    for j, f in enumerate(frames):
        raw = np.unpackbits(np.frombuffer(bytes(f), np.uint8),
                            bitorder="little")
        stuffed: List[int] = []
        run = 0
        for b in raw:
            stuffed.append(int(b))
            if b:
                run += 1
                if run == 5:
                    stuffed.append(0)
                    run = 0
            else:
                run = 0
        out.append(np.asarray(stuffed, np.uint8))
        out.append(flags(tail_flags if j == len(frames) - 1 else inter_flags))
    return np.concatenate(out)


def hdlc_decode(bits) -> List[Ax25Frame]:
    """Bit stream → validated AX.25 frames: split on flags, destuff,
    re-pack LSB-first, FCS-check via Ax25Frame.parse."""
    return [f for f, _ in hdlc_decode_with_pos(bits)]


def hdlc_decode_with_pos(bits) -> List[Tuple[Ax25Frame, int]]:
    """Like hdlc_decode but returns (frame, start_bit_index) pairs — the
    streaming TNC uses the positions to commit/dedup across chunk
    boundaries."""
    out = []
    for raw, pos in hdlc_frames_raw(bits):
        got = Ax25Frame.parse(raw)
        if got is not None:
            out.append((got, pos))
    return out


def hdlc_frames_raw(bits, check_fcs: bool = True
                    ) -> List[Tuple[bytes, int]]:
    """Bit stream → (frame_bytes, start_bit_index) for every flag-delimited,
    destuffed, FCS-valid frame (FCS included in the returned bytes) —
    the protocol-agnostic layer AX.25 and AIS share."""
    b = np.asarray(bits, np.uint8) & 1
    # locate flag positions (8-bit pattern 01111110)
    flag_bits = np.unpackbits(np.uint8([HDLC_FLAG]), bitorder="little")
    if len(b) < 8:
        return []
    win = np.lib.stride_tricks.sliding_window_view(b, 8)
    is_flag = np.all(win == flag_bits, axis=-1)
    idx = np.flatnonzero(is_flag)
    frames: List[Tuple[Ax25Frame, int]] = []
    prev_end = None
    for p in idx:
        if prev_end is not None and p - prev_end >= 8 * 10:
            seg = b[prev_end:p]
            # destuff: drop the 0 after five consecutive 1s
            keep = np.ones(len(seg), bool)
            run = 0
            for i, v in enumerate(seg):
                if not keep[i]:
                    continue
                if v:
                    run += 1
                    if run == 5:
                        if i + 1 < len(seg):
                            if seg[i + 1]:      # six 1s: abort/invalid
                                run = -1
                                break
                            keep[i + 1] = False
                        run = 0
                else:
                    run = 0
            if run >= 0:
                d = seg[keep]
                if len(d) % 8 == 0 and len(d) >= 4 * 8:
                    frame = np.packbits(d, bitorder="little").tobytes()
                    if not check_fcs or (
                            len(frame) > 2 and ax25_crc(frame[:-2])
                            == (frame[-1] << 8) | frame[-2]):
                        frames.append((frame, int(prev_end)))
        prev_end = p + 8
    return frames
