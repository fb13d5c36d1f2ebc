"""``ft8_decode_windows`` of the port on a batch of 15 s windows."""

from __future__ import annotations

import importlib

import numpy as np
import torch

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.codec import ft8_ldpc, ft8_stream
from orion_sdr_tpu_torch.modulate import ft8 as ft8_mod

from ..reference import ft8

_sync = importlib.import_module("orion_sdr_tpu_torch.sync.ft8_sync")


def text(msg) -> str:
    """A message's text as the reference writes it."""
    if isinstance(msg, P.Ft8Standard):
        return " ".join(s for s in (msg.call_to, msg.call_de, msg.extra) if s)
    return "<other>"


class Entry:
    def __init__(self, cfg: dict, params: dict, device) -> None:
        m = cfg["mode"]
        if (ft8_mod.FT8_SAMPLES_PER_SYM != m["samples_per_symbol"]
                or ft8_mod.FT8_TONE_SPACING_HZ != m["tone_spacing_hz"]
                or ft8_mod.FT8_TOTAL_SYMS != m["symbols"]
                or list(ft8_mod.FT8_COSTAS) != m["costas"]):
            raise ValueError("the program's FT8 mode differs from the "
                             "configuration")
        r = cfg["receiver"]
        self.args = (cfg["fs_hz"], r["base_hz"], r["max_hz"], r["max_cand"])
        self.device = device

    def install(self, hooks, rec, spans) -> None:
        def sync(real):
            def w(*a, **k):
                out = spans.cuda("sync", real, *a, **k)
                rec.add("sync", out)
                return out
            return w

        def rows(real):
            def w(*a, **k):
                with spans.label("bp_crc"):
                    out = real(*a, **k)
                rec.add("rows", out)
                return out
            return w

        def bp(real):
            def w(g, llr, *a, **k):
                rec.add("bp", (g.name, llr, a[0] if a else 50))
                return real(g, llr, *a, **k)
            return w

        def unpack(real):
            def w(*a, **k):
                return spans.host("unpack", real, *a, sync=False, **k)
            return w
        hooks.wrap(_sync, "_sync_batch_llrs", sync)
        hooks.wrap(ft8_stream, "_decode_rows", rows)
        hooks.wrap(ft8_ldpc, "bp_decode", bp)
        hooks.wrap(ft8_stream, "unpack77", unpack)

    def call(self, iq):
        return ft8_stream.ft8_decode_windows(iq, *self.args,
                                             device=self.device)

    @staticmethod
    def final(out) -> list:
        return [None if o is None else (text(o.message), float(o.carrier_hz),
                                        float(o.snr_db)) for o in out]

    def observe(self, r) -> ft8.RxRecord:
        """The candidates, LLRs and decisions of every sync and row call,
        concatenated in call order (windows in order), and each window's
        result."""
        f_count = r["sync"][0][0]
        vals, idx, llr = (torch.cat([c[i] for c in r["sync"]])
                          for i in (1, 2, 3))
        bits = torch.cat([c[0] for c in r["rows"]])
        k = vals.shape[1]
        obs = ft8.RxRecord(scores=vals, bins=idx % f_count, llr=llr,
                           bits=bits)
        bins = obs.bins.cpu().numpy()
        host_bits = bits.cpu().numpy()
        base = self.args[1]
        for w, o in enumerate(r["out"][0]):
            if o is None:
                obs.results.append(None)
                continue
            b = int(round((o.carrier_hz - base) / ft8.SPACING))
            c = np.flatnonzero(bins[w] == b) if w < len(bins) else []
            payload = b""
            if len(c):
                p = np.packbits(np.concatenate([host_bits[w * k + c[0]],
                                                np.zeros(5, np.uint8)]))[:10]
                p[9] &= 0xF8
                payload = bytes(p)
            obs.results.append((b, payload, text(o.message),
                                float(o.carrier_hz), float(o.snr_db)))
        return obs

    @staticmethod
    def bp_calls(r) -> list:
        return list(r["bp"])

    def release(self) -> None:
        torch.cuda.empty_cache()
