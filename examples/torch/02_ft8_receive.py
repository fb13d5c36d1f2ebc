"""FT8 on the card: pack a message, modulate, receive many noisy windows in
one batch.

The torch port's counterpart of examples/02_ft8_receive.py, on the same
seed and sizes.

Run: python3 examples/torch/02_ft8_receive.py         (on the CUDA card)
     python3 examples/torch/02_ft8_receive.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr

FS = 12_000.0


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    ht = sdr.CallsignHashTable()
    rng = np.random.default_rng(0)
    calls = ["KA1ABC", "W9XYZ", "K5TPU"]
    windows = []
    for i, call in enumerate(calls):
        payload = sdr.pack77(sdr.Ft8Standard("CQ", call, "FN42"), ht)
        iq = sdr.ft8_mod(sdr.ft8_encode(payload, device=device), FS,
                         base_hz=1000.0 + i * 25, device=device)
        iq = iq.cpu().numpy()
        # −12 dB SNR in the 2.5 kHz reference bandwidth
        power = FS / (2500.0 * 10 ** (-12.0 / 10.0))
        iq = iq + ((rng.standard_normal(len(iq)) +
                    1j * rng.standard_normal(len(iq)))
                   * np.sqrt(power / 2)).astype(np.complex64)
        windows.append(iq)

    # one batched sync over every window; one BP launch decodes them all
    results = sdr.ft8_decode_windows(np.stack(windows), FS, 950.0, 1150.0,
                                     hash_table=ht, device=device)
    decodes = []
    for i, r in enumerate(results):
        if r is None:
            print(f"window {i}: no decode")
            decodes.append(None)
        else:
            m = r.message
            print(f"window {i}: {m.call_to} {m.call_de} {m.extra} "
                  f"@ {r.carrier_hz:.1f} Hz (score {r.snr_db:.1f})")
            decodes.append({"text": f"{m.call_to} {m.call_de} {m.extra}",
                            "carrier_hz": float(r.carrier_hz),
                            "score": float(r.snr_db)})
    return {"decodes": decodes}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
