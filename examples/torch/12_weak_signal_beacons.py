"""WSPR on the card: three beacons, the weakest about −24 dB in the
2.5 kHz reference bandwidth, decoded from one two-minute capture.

The torch port's counterpart of examples/12_weak_signal_beacons.py, on the
same seed and sizes.

Run: python3 examples/torch/12_weak_signal_beacons.py         (on the CUDA card)
     python3 examples/torch/12_weak_signal_beacons.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr
from orion_sdr_tpu_torch.demodulate.wspr import wspr_decode_band


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    rng = np.random.default_rng(11)

    def beacon(call, grid, dbm, base_hz):
        return sdr.wspr_mod(call, grid, dbm, base_hz=base_hz,
                            device=device).cpu().numpy()

    b1 = beacon("K1ABC", "FN42", 37, 1420.0)
    b2 = beacon("W1AW", "FN31", 30, 1500.0) * 0.4
    b3 = beacon("DL2XYZ", "JO62", 23, 1565.0) * 0.15

    n = len(b1) + 40_000
    band = np.zeros(n, np.complex64)
    band[:len(b1)] += b1
    band[9_000:9_000 + len(b2)] += b2
    band[22_000:22_000 + len(b3)] += b3

    # complex noise with per-sample variance 0.02: the 0.15-amplitude beacon
    # sits ≈ −24 dB in the 2.5 kHz reference bandwidth
    band += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64) * np.sqrt(0.02 / 2)

    decodes = []
    for m in wspr_decode_band(band, device=device):
        print(f"  {m.callsign:8s} {m.grid}  {m.dbm} dBm")
        decodes.append({"callsign": m.callsign, "grid": m.grid,
                        "dbm": m.dbm})
    return {"decodes": decodes}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
