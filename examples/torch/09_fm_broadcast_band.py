"""FM broadcast band on the card: three stereo stations with RDS in one
2.4 Msps capture, found by a blind scan and received with their PI, PS and
radiotext.

The torch port's counterpart of examples/09_fm_broadcast_band.py, on the
same seed and sizes.

Run: python3 examples/torch/09_fm_broadcast_band.py         (on the CUDA card)
     python3 examples/torch/09_fm_broadcast_band.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr
from orion_sdr_tpu_torch.dsp.osc import rotate

FS_WIDE = 2_400_000.0          # one SDR front-end capture of the band
N = (1 << 18) * 10             # ~1.1 s


def station(t, f_left, f_right, pi, ps, rt, center_hz, gain, device):
    """One broadcaster: distinct L/R program + RDS PS/radiotext."""
    left = (0.8 * np.sin(2 * np.pi * f_left * t)).astype(np.float32)
    right = (0.8 * np.sin(2 * np.pi * f_right * t)).astype(np.float32)
    groups = sdr.rds_groups_0a(pi, pty=10, ps_name=ps) \
        + sdr.rds_groups_2a(pi, pty=10, radiotext=rt)
    iq, _ = sdr.fm_stereo_mod(left, right, FS_WIDE,
                              rds_bits=sdr.rds_encode_groups(groups),
                              device=device)
    return gain * rotate(iq, center_hz, FS_WIDE)[0].cpu().numpy()


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    t = np.arange(N) / FS_WIDE
    rng = np.random.default_rng(7)
    band = (station(t, 1000, 2500, 0x1111, "ALPHA FM", "MORNING SHOW",
                    -800e3, 1.0, device)
            + station(t, 600, 1800, 0x2222, "BETA  FM", "ALL NEWS ALL DAY",
                      0.0, 0.7, device)
            + station(t, 400, 3000, 0x3333, "GAMMAFM ", "CLASSIC HITS",
                      650e3, 0.4, device)).astype(np.complex64)
    band += ((rng.standard_normal(N) + 1j * rng.standard_normal(N))
             .astype(np.complex64) * 0.02)

    # scan-then-receive: no prior channel plan
    stations = sdr.fm_band_demod(band, FS_WIDE, decode_rds=True,
                                 de_emphasis_us=50.0, device=device)

    print(f"found {len(stations)} stations:")
    found = []
    for s in stations:
        a = s.audio
        left = a.left.cpu().numpy() if isinstance(a.left, torch.Tensor) \
            else np.asarray(a.left)
        rms_l = float(np.sqrt(np.mean(left[20000:] ** 2)))
        print(f"  {s.center_hz / 1e3:+9.1f} kHz  pilot={a.pilot_level:.3f}  "
              f"audio rms={rms_l:.2f}  PI=0x{a.rds.pi:04X}  "
              f"PS={a.rds.ps_name!r}  RT={a.rds.radiotext!r}")
        found.append({"center_hz": float(s.center_hz),
                      "pilot": float(a.pilot_level), "audio_rms": rms_l,
                      "pi": a.rds.pi, "ps": a.rds.ps_name,
                      "rt": a.rds.radiotext})
    return {"stations": found}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
