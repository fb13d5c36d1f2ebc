"""OFDM frame modulator (counterpart of ``orion_sdr_tpu/frame/modulator.py``).

Assembles [preamble+training][header][payload] as one IQ stream on the
modulator's device. The header is a fixed BPSK + rate-1/2 LDPC block (wire
layout: mcs 1B, payload_len 4B, seq 4B, flags 1B, seed 4B, big-endian +
CRC); the payload is coded per the frame's MCS. Symbol windowing tapers
every CP-bearing symbol (training onward) but never the raw S&C repeats;
the config's TX lowpass runs last, over the whole burst.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..constellation import bits_per_symbol
from ..multicarrier import symbol_taper
from ..ofdm import OfdmConfig, ofdm_mod
from ..sync.ofdm_sync import OfdmPreamble, generate_ofdm_preamble
from .chain import block_plan, encode_chain
from .types import (FramePacket, InnerFec, InterleaverKind, McsTable,
                    OuterFec, ScramblerKind, SCRAMBLER_BEFORE_OUTER,
                    header_has_block)

HEADER_FIELD_BYTES = 14
HEADER_CONSTELLATION = "bpsk"
HEADER_LDPC = "N512R12"


def pack_header_fields(mcs_index: int, payload_len: int, sequence_num: int,
                       flags: int, scrambler_seed: int) -> np.ndarray:
    """14 header bytes, big-endian."""
    out = np.zeros(HEADER_FIELD_BYTES, np.uint8)
    out[0] = mcs_index & 0xFF
    out[1:5] = np.frombuffer(int(payload_len).to_bytes(4, "big"), np.uint8)
    out[5:9] = np.frombuffer(int(sequence_num).to_bytes(4, "big"), np.uint8)
    out[9] = flags & 0xFF
    out[10:14] = np.frombuffer(int(scrambler_seed).to_bytes(4, "big"), np.uint8)
    return out


def header_block_plan(cfg: OfdmConfig):
    return block_plan(HEADER_FIELD_BYTES, cfg.header_crc, OuterFec.none(),
                      InnerFec.ldpc(HEADER_LDPC), InterleaverKind.none(),
                      InterleaverKind.none())


def symbols_for_coded_bits(cfg: OfdmConfig, constellation: str,
                           bits: int) -> int:
    bps = cfg.carrier_plan.num_data_carriers() * bits_per_symbol(constellation)
    return -(-bits // bps)


def _map_bits(cfg: OfdmConfig, constellation: str, bits: torch.Tensor
              ) -> torch.Tensor:
    iq, _ = ofdm_mod(replace(cfg, constellation=constellation,
                             tx_lowpass=None), bits)
    return iq


class OfdmFrameMod:
    """Frame modulator over a config, MCS table and acquisition preamble;
    coding and modulation run on ``device``. ``cache`` is accepted for the
    JAX package's signature and does nothing: codes and tables memoize
    process-wide here (:class:`~orion_sdr_tpu_torch.frame.CodecCache` is
    inert)."""

    def __init__(self, cfg: OfdmConfig, mcs_table: McsTable,
                 preamble: OfdmPreamble, cache=None, *,
                 device="cuda") -> None:
        self.cfg = cfg
        self.mcs_table = mcs_table
        self.preamble = preamble
        self.device = torch.device(device)
        pre = generate_ofdm_preamble(preamble) * cfg.gain
        self._preamble_iq = torch.as_tensor(pre.astype(np.complex64),
                                            device=self.device)

    def modulate_frame(self, frame: FramePacket,
                       per_frame_seed: int = 0) -> np.ndarray:
        """One frame's IQ as a numpy complex64 array."""
        cfg = self.cfg
        parts = [self._preamble_iq]
        if header_has_block(cfg.header_format):
            fields = pack_header_fields(
                frame.metadata.mcs_index, len(frame.payload),
                frame.metadata.sequence_num, frame.metadata.flags,
                per_frame_seed)
            header_bits = encode_chain(
                fields, cfg.header_crc, OuterFec.none(),
                InnerFec.ldpc(HEADER_LDPC), InterleaverKind.none(),
                InterleaverKind.none(), ScramblerKind.none(),
                SCRAMBLER_BEFORE_OUTER, 0, device=self.device)
            parts.append(_map_bits(cfg, HEADER_CONSTELLATION, header_bits))
        mcs = self.mcs_table.get(frame.metadata.mcs_index)
        if mcs is None:
            raise ValueError("mcs_index must be in the MCS table")
        payload_bits = encode_chain(
            frame.payload, cfg.payload_crc, mcs.outer_fec, mcs.inner_fec,
            cfg.outer_interleaver, cfg.inner_interleaver, cfg.scrambler,
            cfg.scrambler_pos, per_frame_seed, device=self.device)
        parts.append(_map_bits(cfg, mcs.constellation, payload_bits))
        out = torch.cat(parts)
        # ofdm_mod tapered the header/payload symbols already; only the
        # training symbol still needs its taper
        t = self.preamble.training_symbol
        taper = symbol_taper(t.n_fft + t.cp_len,
                             cfg.carrier_plan.window_roll_off) \
            if t is not None else None
        if taper is not None:
            start = self.preamble.num_repeats * self.preamble.repeat_len
            out[start:start + len(taper)] *= torch.as_tensor(taper,
                                                             device=out.device)
        # the spectral mask covers the entire burst, S&C repeats included
        if cfg.tx_lowpass is not None:
            out = cfg.tx_lowpass.apply(out)
        return out.to(torch.complex64).cpu().numpy()
