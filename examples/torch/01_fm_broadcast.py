"""FM broadcast receive on the card: synthesize → demodulate → measure.

The torch port's counterpart of examples/01_fm_broadcast.py, on the same
seed and sizes.

Run: python3 examples/torch/01_fm_broadcast.py         (on the CUDA card)
     python3 examples/torch/01_fm_broadcast.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    fs = 480_000.0
    deviation = 75_000.0
    n = 1 << 18

    # a 1 kHz test tone, FM modulated, with 20 dB of channel noise
    t = np.arange(n) / fs
    audio_in = 0.5 * np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    iq, _ = sdr.fm_mod(audio_in, fs, deviation, device=device)
    iq = iq.cpu().numpy() + sdr.awgn(np.random.default_rng(0), n, 0.01)

    audio, _ = sdr.fm_demod(iq, fs, deviation, audio_bw_hz=5_000.0,
                            device=device)
    audio = audio.cpu().numpy().astype(np.float64)[4096:]

    # scale-invariant tone check: projection onto 1 kHz vs an off-tone bin
    def proj(f):
        t = 2 * np.pi * f / fs * np.arange(len(audio))
        return np.hypot(np.sum(audio * np.cos(t)), np.sum(audio * np.sin(t)))

    snr = 20 * np.log10(proj(1000.0) / max(proj(730.0), 1e-30))
    print(f"recovered 1 kHz tone: {snr:.1f} dB above off-tone floor")
    assert snr > 20.0
    return {"tone_snr_db": float(snr)}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
