"""Robust COFDM link on the card: a frame through multipath, phase noise
and noise, found in a stream and decoded with CPE tracking.

The torch port's counterpart of examples/07_robust_cofdm_link.py, on the
same seed and sizes.

Run: python3 examples/torch/07_robust_cofdm_link.py         (on the CUDA card)
     python3 examples/torch/07_robust_cofdm_link.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr
from orion_sdr_tpu_torch.frame import RxFrame


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    fs = 1e6
    plan = sdr.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = sdr.OfdmConfig(plan, fs=fs).with_phase_tracking("cpe")
    pre = sdr.OfdmPreamble(repeat_len=128, num_repeats=4
                           ).with_training_symbol(256, 64)
    table = sdr.McsTable.default_ladder()

    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, 400).astype(np.uint8)
    packet = sdr.FramePacket(sdr.FrameMetadata(sequence_num=1, mcs_index=1),
                             payload)
    iq = np.asarray(sdr.OfdmFrameMod(cfg, table, pre, device=device
                                     ).modulate_frame(packet, 0x1234))

    # channel: unknown start + in-guard 2-ray multipath + 12 Hz-linewidth
    # oscillator + 8 dB AWGN
    buf = np.concatenate([np.zeros(5000, np.complex64), iq,
                          np.zeros(2000, np.complex64)])
    buf = sdr.multipath_apply(buf, [0, 24], [1.0, 0.45 * np.exp(0.9j)],
                              device=device)
    buf = sdr.phase_noise_apply(rng, buf, 12.0, fs,
                                device=device).cpu().numpy()
    body = iq[pre.total_len():]
    sig = float(np.mean(np.abs(body) ** 2))
    snr_db = 8.0
    sigma = np.sqrt(sig / (2 * 10 ** (snr_db / 10)))
    buf = buf + (rng.standard_normal(len(buf)) +
                 1j * rng.standard_normal(len(buf))
                 ).astype(np.complex64) * sigma

    rx = sdr.OfdmFrameStreamDemod(cfg, table, pre, device=device)
    results = []
    for i in range(0, len(buf), 20000):        # stream in arbitrary chunks
        results += rx.feed(buf[i:i + 20000])
    results += rx.flush()

    frames = [r for r in results if isinstance(r, RxFrame)]
    print(f"channel: 2-ray multipath, 12 Hz phase noise, {snr_db:.0f} dB SNR")
    if not frames:
        print("no frame decoded:", results)
        return {"frames": 0}
    f = frames[0]
    intact = bool(np.array_equal(f.packet.payload, payload))
    print(f"decoded frame seq={f.packet.metadata.sequence_num} "
          f"mcs={f.packet.metadata.mcs_index} "
          f"({len(f.packet.payload)} bytes), "
          f"payload intact: {intact}")
    print(f"estimated CFO {f.diagnostics.cfo_hz:+.2f} Hz, "
          f"timing offset {f.diagnostics.timing_offset_samples} samples")
    return {"frames": len(frames), "seq": f.packet.metadata.sequence_num,
            "mcs": f.packet.metadata.mcs_index,
            "bytes": len(f.packet.payload), "payload_intact": intact,
            "cfo_hz": float(f.diagnostics.cfo_hz),
            "timing_offset": int(f.diagnostics.timing_offset_samples)}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
