"""``DvbTFrameDemod.decode_batch`` of the port on aligned 68-symbol frames."""

from __future__ import annotations

import numpy as np
import torch

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.fec import conv
from orion_sdr_tpu_torch.frame import chain
from orion_sdr_tpu_torch.waveform import dvb_t

from ..checks.dvbt_frames import Layers
from ..reference import dvbt


class Entry:
    def __init__(self, cfg: dict, params: dict, device) -> None:
        link, vit = cfg["link"], cfg["viterbi"]
        self.ref = dvbt.Link.of(cfg)
        code = link["inner_code"]
        mother = conv.CONV_CODES[code["name"]]
        rs, il = dvb_t.dvb_t_frame_outer(), dvb_t.dvb_t_frame_outer_il()
        if (dvb_t.DVB_T_N_FFT != link["n_fft"]
                or dvb_t.DVB_T_ACTIVE_CARRIERS != link["active_carriers"]
                or dvb_t.DVB_T_DATA_CARRIERS != link["data_carriers"]
                or dvb_t.guard_cp_len_2k(link["guard"]) != link["cp_len"]
                or (mother["K"], mother["g0"], mother["g1"])
                != (code["K"], int(code["g1_octal"], 8),
                    int(code["g2_octal"], 8))
                or conv.PUNCTURE[link["code_rate"]]
                != (code["puncture_x"], code["puncture_y"])
                or (il.branches, il.depth)
                != (link["outer_interleaver"]["branches"],
                    link["outer_interleaver"]["depth"])
                or (rs.n, rs.n - rs.n_parity)
                != (link["rs"]["n"], link["rs"]["k"])
                or (conv.CHUNK_STEPS, conv.CHUNK_OVERLAP)
                != (vit["chunk_steps"], vit["chunk_overlap"])
                or chain.CONV_TERMINATED_MAX_INFO
                != vit["terminated_max_info"]):
            raise ValueError("the program's DVB-T link differs from the "
                             "configuration")
        self.payload_len = self.ref.payload_bytes
        if self.ref.info_bits(self.ref.payload_packets) \
                <= vit["terminated_max_info"]:
            raise ValueError("the frame's trellis would decode terminated, "
                             "not over the chunk plan")
        self.n_symbols = link["symbols_per_frame"]
        self.demod = P.DvbTFrameDemod(P.DvbTFrameParams(P.DvbTLinkParams(
            link["guard"], link["constellation"], link["code_rate"])),
            device=device)

    def install(self, hooks, rec, spans) -> None:
        def recorded_as(key):
            def wrap(real):
                def w(*a, **k):
                    out = real(*a, **k)
                    rec.add(key, out)
                    return out
                return w
            return wrap
        hooks.wrap(conv, "chunk_llrs", recorded_as("chunks"))
        hooks.wrap(chain, "viterbi_decode_soft_chunked",
                   recorded_as("viterbi"))
        hooks.wrap(chain, "outer_decode_batch", recorded_as("outer"))

    def call(self, iq):
        return self.demod.decode_batch(iq, self.n_symbols, self.payload_len)

    @staticmethod
    def final(out) -> list:
        return [("ok", f.tps.frame_number, f.tps.constellation,
                 f.tps.code_rate_hp, f.tps.guard, f.tps.cell_id,
                 bytes(f.payload.tobytes())) for f in out]

    @staticmethod
    def observe(r) -> Layers:
        """Each frame's TPS fields; every chunked Viterbi call's lanes (the
        chunk LLRs and start metrics handed to the kernel, the chunks a row)
        with the decoded rows it returned, in call order; every frame's RS
        output row (message bytes) with its flag."""
        (out,) = r["out"]
        lanes = [(c0, c1, pm0, nchunk, bits)
                 for (c0, c1, pm0, nchunk), bits in zip(r["chunks"],
                                                        r["viterbi"])]
        return Layers([(f.tps.frame_number, f.tps.constellation,
                        f.tps.code_rate_hp, f.tps.guard, f.tps.cell_id)
                       for f in out], lanes,
                      [(m, bool(ok)) for msg, flags in r["outer"]
                       for m, ok in zip(np.packbits(msg, axis=1), flags)])

    def release(self) -> None:
        self.demod = None
        torch.cuda.empty_cache()
