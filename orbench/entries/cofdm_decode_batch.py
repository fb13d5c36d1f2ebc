"""``OfdmFrameDemod.decode_batch`` of the port on aligned frame bodies."""

from __future__ import annotations

import numpy as np
import torch

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.frame import chain, demodulator, modulator

from ..reference import cofdm


class Entry:
    def __init__(self, cfg: dict, params: dict, device) -> None:
        link = cfg["link"]
        plan = P.CarrierPlan(link["n_fft"], link["cp_len"]) \
            .with_contiguous_data(edge_guard=link["edge_guard"])
        self.cfg = P.OfdmConfig(plan, fs=cfg["fs_hz"]) \
            .with_ldpc_decode_rule(link["ldpc_rule"])
        self.table = P.McsTable.default_ladder()
        stated = [(m["constellation"], m["ldpc"], m["bch_t"])
                  for m in link["mcs"]]
        have = [(m.constellation, m.inner_fec.code, m.outer_fec.t)
                for m in self.table.entries]
        h = link["header"]
        if (have != stated or self.cfg.header_crc != h["crc"]
                or self.cfg.payload_crc != link["payload_crc"]
                or modulator.HEADER_FIELD_BYTES != h["field_bytes"]
                or modulator.HEADER_CONSTELLATION != h["constellation"]
                or modulator.HEADER_LDPC != link["ldpc"]
                or chain.BCH_INFO_BITS != link["bch_info_bits"]):
            raise ValueError("the program's COFDM link differs from the "
                             "configuration")
        self.demod = P.OfdmFrameDemod(self.cfg, self.table, device=device)

    def install(self, hooks, rec, spans) -> None:
        def demap(real):
            def w(*a, **k):
                with spans.label("soft_demap"):
                    return real(*a, **k)
            return w

        def chain_batch(real):
            def w(*a, **k):
                out = real(*a, **k)
                rec.add("chain", out)
                return out
            return w

        def ldpc(real):
            def w(name, llr, *a, **k):
                bits, unsat = spans.host("ldpc", real, name, llr, *a, **k)
                rec.add("ldpc", (name, llr, a[0] if a else 50, bits, unsat))
                return bits, unsat
            return w

        def outer(real):
            def w(*a, **k):
                out = spans.host("outer", real, *a, **k)
                rec.add("outer", out)
                return out
            return w
        hooks.wrap(demodulator, "soft_demap", demap)
        hooks.wrap(demodulator, "decode_chain_batch", chain_batch)
        hooks.wrap(chain, "ldpc_decode", ldpc)
        hooks.wrap(chain, "outer_decode_batch", outer)

    def call(self, iq):
        return self.demod.decode_batch(iq)

    @staticmethod
    def final(out) -> list:
        return [("ok", p.metadata.sequence_num, p.metadata.mcs_index,
                 p.metadata.flags, bytes(np.asarray(p.payload, np.uint8)))
                if isinstance(p, P.FramePacket) else ("err", p.kind)
                for p in out]

    @staticmethod
    def observe(r) -> cofdm.Layers:
        """The batch's header fields (the first chain call, the header's),
        and every BP row and BCH output row of all calls, in call order."""
        fields, hok = r["chain"][0]
        headers = [cofdm.parse_header(bytes(np.asarray(f, np.uint8)))
                   if ok and f is not None and len(f) >= 14 else None
                   for f, ok in zip(fields, hok)]
        calls = r["ldpc"]
        dev = calls[0][1].device if calls else "cpu"

        def cat(i, dtype):
            return torch.cat([c[i].to(dev) for c in calls]) if calls \
                else torch.zeros((0,), dtype=dtype)
        return cofdm.Layers(headers, cat(1, torch.float32),
                            cat(3, torch.uint8), cat(4, torch.int32),
                            [(m, bool(ok)) for msg, flags in r["outer"]
                             for m, ok in zip(np.asarray(msg),
                                              np.asarray(flags))])

    @staticmethod
    def bp_calls(r) -> list:
        return [(name, llr, max_iter)
                for name, llr, max_iter, _, _ in r["ldpc"]]

    def release(self) -> None:
        self.demod = None
        torch.cuda.empty_cache()
