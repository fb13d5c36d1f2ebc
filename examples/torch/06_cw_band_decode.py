"""CW skimmer on the card: three operators on one band, every carrier's
keying envelope from one batched pass, each decoded to text.

The torch port's counterpart of examples/06_cw_band_decode.py, on the same
seed and sizes.

Run: python3 examples/torch/06_cw_band_decode.py         (on the CUDA card)
     python3 examples/torch/06_cw_band_decode.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr

FS = 8000.0

# three operators on the band: different speeds, tones, signal strengths
SIGNALS = [
    ("CQ CQ DE W1AW", 18.0, 550.0, 1.0),
    ("HELLO WORLD", 28.0, 950.0, 0.3),
    ("73 GL SK", 35.0, 1350.0, 0.12),
]


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    rng = np.random.default_rng(42)
    n = int(FS * 14)
    buf = (rng.normal(0, 0.02, n) + 1j * rng.normal(0, 0.02, n)).astype(
        np.complex64)
    for text, wpm, tone, amp in SIGNALS:
        enc = sdr.MorseEncoder(FS, wpm).with_jitter(12.0)   # a human fist
        iq, _ = sdr.cw_mod(enc.encode_text(text), FS, tone, device=device)
        start = int(rng.integers(0, FS))
        buf[start:start + len(iq)] += amp * iq.cpu().numpy()[: n - start]

    # one batched pass extracts every carrier's keying envelope
    found = []
    for r in sdr.morse_decode_band(buf, FS, 400.0, 1500.0, device=device):
        print(f"{r.tone_hz:7.1f} Hz  {r.score_db:5.1f} dB  {r.wpm:4.1f} wpm  "
              f"{r.text!r}")
        found.append({"tone_hz": float(r.tone_hz),
                      "score_db": float(r.score_db), "wpm": float(r.wpm),
                      "text": r.text})
    return {"decodes": found}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
