"""Blind receive on the card: classify and decode a mystery band, then a
DVB-T transmission whose parameters are withheld.

The torch port's counterpart of examples/11_blind_receive.py, on the same
seed and sizes.

Run: python3 examples/torch/11_blind_receive.py         (on the CUDA card)
     python3 examples/torch/11_blind_receive.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr
from orion_sdr_tpu_torch.dsp.osc import rotate


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    rng = np.random.default_rng(7)

    # ── 1. a mystery band ────────────────────────────────────────────────────
    fs = 500_000.0
    n = 1 << 19
    t = np.arange(n) / fs

    def at(z, center, gain=1.0):
        z = z.cpu().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)
        zz = np.ascontiguousarray(z[:n], np.complex64)
        if len(zz) < n:
            zz = np.concatenate([zz, np.zeros(n - len(zz), np.complex64)])
        return gain * rotate(zz, center, fs, device=device)[0].cpu().numpy()

    am = sdr.am_mod((0.6 * np.sin(2 * np.pi * 800 * t)).astype(np.float32),
                    fs, device=device)[0]
    pager = sdr.pocsag_mod([sdr.PocsagPage(address=0xB41, function=3,
                                           text="MEET AT 0900")] * 4, fs,
                           device=device)
    band = (at(am, -150e3) + at(pager, 100e3, 0.8)).astype(np.complex64)
    band += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64) * 0.004

    print("band_decode over a blind 500 kHz capture:")
    entries = []
    for e in sdr.band_decode(band, fs, device=device):
        extra = f"text={e.text!r}" if e.text else \
            (f"audio {len(e.audio)} samples @ {e.fs_audio:.0f} Hz"
             if e.audio is not None else "")
        print(f"  {e.segment.center_hz / 1e3:+9.1f} kHz  "
              f"{e.signal.label:10s} ({e.signal.confidence:.2f})  {extra}")
        entries.append({"center_hz": float(e.segment.center_hz),
                        "label": e.signal.label,
                        "confidence": float(e.signal.confidence),
                        "text": e.text,
                        "audio": None if e.audio is None else len(e.audio)})

    # ── 2. a mystery DVB-T transmission ──────────────────────────────────────
    payload = rng.integers(0, 256, 700).astype(np.uint8)
    secret_params = sdr.DvbTFrameParams(
        sdr.DvbTLinkParams("1/16", "qam16", "3/4"), 1, 42)
    frame = sdr.DvbTFrameMod(secret_params, device=device).modulate(payload)
    capture = np.concatenate([np.zeros(2000, np.complex64),
                              np.asarray(frame.iq)])

    out = sdr.dvb_t_blind_decode(capture, device=device)
    recovered = bool(np.array_equal(out.payload[:len(payload)], payload))
    print("\ndvb_t_blind_decode (TX parameters withheld):")
    print(f"  guard={out.guard}  constellation={out.tps.constellation}  "
          f"rate={out.tps.code_rate_hp}  cell_id={out.tps.cell_id}")
    print(f"  payload recovered: {recovered} ({len(payload)} bytes)")
    return {"band": entries,
            "dvb_t": {"guard": out.guard,
                      "constellation": out.tps.constellation,
                      "rate": out.tps.code_rate_hp,
                      "cell_id": out.tps.cell_id,
                      "payload_recovered": recovered}}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
