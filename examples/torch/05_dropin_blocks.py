"""Drop-in block classes on the card: construct once, stream through
``process()``.

The torch port's counterpart of examples/05_dropin_blocks.py, on the same
seed and sizes. The blocks take host chunks and return tensors on their
device.

Run: python3 examples/torch/05_dropin_blocks.py         (on the CUDA card)
     python3 examples/torch/05_dropin_blocks.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    fs = 48_000.0

    # 1. FM, reference-style: construct once, stream chunks through process()
    t = np.arange(1 << 15) / fs
    audio = 0.4 * np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    mod = sdr.FmPhaseAccumMod(fs, 5000.0, device=device)
    demod = sdr.FmQuadratureDemod(fs, 5000.0, 3000.0, device=device)
    iq = _host(mod.process(audio))
    out = np.concatenate([_host(demod.process(c))
                          for c in np.array_split(iq, 7)])
    # the reference's demod gain convention recovers the tone scaled by
    # 2π/fs; measure the tone projection SNR like its tests do
    n = len(out) - 4000
    tt = np.arange(n) / fs
    proj = abs(np.mean(out[4000:] * np.exp(-2j * np.pi * 1000.0 * tt)))
    off = abs(np.mean(out[4000:] * np.exp(-2j * np.pi * 730.0 * tt)))
    fm_snr = 20 * np.log10(proj / (off + 1e-20))
    print(f"1. FM blocks: {len(out)} audio samples, tone SNR {fm_snr:.0f} dB")

    # 2. FT8, reference-style: Codec + Mod/Demod classes
    payload = sdr.ft8_pack_standard("CQ", "KA1ABC", "FN42")
    codec = sdr.Ft8Codec(device=device)
    tones = codec.encode(payload)
    iq8 = sdr.Ft8Mod(12000.0, 1000.0, device=device).modulate(tones)
    got = sdr.Ft8Demod(12000.0, 1000.0, device=device).demodulate(iq8)
    decoded = codec.decode_hard(got)
    ft8 = sdr.ft8_unpack(decoded)
    print(f"2. FT8 blocks: {ft8}")

    # 3. PSK31 streaming demod class with carried AFC/mixer state
    iq31 = _host(sdr.Bpsk31Mod(8000.0, rf_hz=1000.0,
                               device=device).modulate_text("via blocks"))
    d31 = sdr.Bpsk31Demod(8000.0, rf_hz=1000.0, device=device)
    soft = np.concatenate([_host(d31.process(c))
                           for c in np.array_split(iq31, 5)])
    bits = _host(sdr.Bpsk31Decider(device=device).process(soft))
    text = sdr.VaricodeDecoder().push_bits(bits)
    print(f"3. PSK31 blocks: {text!r}")

    # 4. QAM at an RF carrier
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 64 * 6).astype(np.uint8)
    iqq = sdr.QamMod(64, fs, rf_hz=12_000.0, device=device).process(bits)
    back = _host(sdr.QamDemod(64, 1.0, fs, rf_hz=12_000.0,
                              device=device).process(iqq))
    exact = bool(np.array_equal(back[:len(bits)], bits))
    print(f"4. QAM-64 blocks bit-exact: {exact}")
    return {"fm_samples": len(out), "fm_snr_db": float(fm_snr), "ft8": ft8,
            "psk31_text": text, "qam64_exact": exact}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
