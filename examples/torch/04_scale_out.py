"""Scale-out: shard SDR pipelines over a mesh of shards.

The torch port's counterpart of examples/04_scale_out.py. A port mesh is
one process driving many shards (``parallel.Mesh``); here the eight shards
are eight slices of one card (``["cuda:0"] * 8``), or of the host with
``--cpu``:

1. channel-parallel — many independent receivers, no collectives;
2. time-parallel streaming state — one fast PSK31 stream whose AFC/PLL
   recurrence carries across shards;
3. a bit-error rate reduced over the mesh.

The scaling table of part 4 is a timing (eight shards of one card share
its SMs), not a result.

Run: python3 examples/torch/04_scale_out.py         (on the CUDA card)
     python3 examples/torch/04_scale_out.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr
from orion_sdr_tpu_torch.parallel import (
    make_mesh, fm_demod_sharded, psk31_stream_decode_sharded, ber_sharded,
    make_process_mesh, measure_scaling, format_scaling_table, shard_channels,
)


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devices = [dev] * 8
    pmesh = make_process_mesh(devices=devices)
    print(f"mesh: {len(devices)} devices "
          f"(process mesh {pmesh.devices.shape})")

    # 1. channel + time parallel FM demod with halo exchange
    mesh = make_mesh(8, shape=(2, 4), devices=devices)   # 2 ch × 4 time
    rng = np.random.default_rng(0)
    fs = 48_000.0
    iq = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))
          ).astype(np.complex64)
    taps = sdr.dsp.kaiser_lowpass_taps(31, 0.2, 50.0)
    audio = fm_demod_sharded(iq, taps, mesh, fs, 2500.0)
    print(f"1. sharded FM demod: {tuple(audio.shape)} across 8 devices")

    # 2. time-sharded PSK31 text decode (AFC/PLL state exact across shards)
    text = "sharded psk31 stream decode"
    iq31 = sdr.bpsk31_mod_text(text, 8000.0, device=device).cpu().numpy()
    decoded = psk31_stream_decode_sharded(iq31, mesh, 8000.0)
    print(f"2. time-sharded PSK31 decode: {decoded.strip()!r}")
    assert text in decoded

    # 3. BER reduced across the mesh
    flat = make_mesh(8, ("ch",), (8,), devices=devices)
    ref = rng.integers(0, 2, (8, 4096)).astype(np.uint8)
    hat = ref.copy()
    hat[2, :41] ^= 1
    ber, errs, n = ber_sharded(ref, hat, flat)
    print(f"3. psum BER over the mesh: {errs}/{n} = {ber:.2e}")

    # 4. the scaling-efficiency harness (weak scaling; eight shards of one
    #    card share it, so this shows the sharding's overhead, not a speedup)
    def make_fn(mesh_n):
        return shard_channels(lambda x: sdr.dsp.fir_apply(x, taps)[0],
                              mesh_n)

    def make_input(nd):
        return (np.random.default_rng(nd).standard_normal(
            (2 * nd, 1 << 14)).astype(np.float32),)

    rows = measure_scaling(make_fn, make_input, device_counts=[1, 2, 4, 8],
                           reps=2, devices=devices)
    print("4. scaling harness:")
    print(format_scaling_table(rows))
    return {"mesh_devices": len(devices),
            "process_mesh": tuple(pmesh.devices.shape),
            "fm_shape": tuple(audio.shape), "psk31_text": decoded.strip(),
            "ber_errors": int(errs), "ber_bits": int(n), "ber": float(ber),
            "scaling": rows}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
