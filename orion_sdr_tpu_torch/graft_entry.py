"""Entry points: one step of the flagship receiver on one device, and a dry
run of the whole sharded processing step over a mesh (counterpart of the
repository's ``__graft_entry__.py``).

The flagship pipeline is the OFDM coded-link receiver front end: symbol FFT
→ ZF equalize → grid extract → max-log soft LLRs, batched over channels.
``entry``'s step keeps the float32 (re, im) signature of the JAX one; inside
the port tensors are complex.

Run ``python -m orion_sdr_tpu_torch.graft_entry`` on a card for the step's
output shape.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): ``fn(z_re, z_im, h_re, h_im)`` → (batch,
    n_sym·n_data·4) LLRs of a 16-QAM OFDM receive, its float32 arguments
    on ``device``."""
    from .constellation import soft_llr
    from .multicarrier import CarrierGrid, CarrierPlan, grid_extract, \
        symbol_fft
    from .ofdm import OfdmConfig, zf_equalize

    plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = OfdmConfig(plan, fs=1e6, constellation="qam16")
    grid = CarrierGrid(plan)
    n_sym = 8
    batch = 4

    rng = np.random.default_rng(0)
    n = n_sym * cfg.samples_per_ofdm_symbol()
    iq = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
          ).astype(np.complex64)
    est = np.ones(plan.n_fft, np.complex64)

    def fn(z_re, z_im, h_re, h_im):
        z = torch.complex(z_re, z_im)
        h = torch.complex(h_re, h_im)
        freq = symbol_fft(z, plan.n_fft, plan.cp_len, n_symbols=n_sym)
        soft = grid_extract(grid, zf_equalize(freq, h))
        return soft_llr(soft.reshape(soft.shape[:-2] + (-1,)), "qam16")

    args = tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (iq.real, iq.imag, est.real, est.imag))
    return fn, args


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run every sharded path once on small shapes over an ``n_devices``
    mesh (channel × time) of ``devices`` (default every CUDA device), each
    checked for its shape or against the single-device path: the FIR and
    FM discriminator with halos, the OFDM soft demap (and with CPE), the
    service-parallel DVB-T receive, the PSK31 demod, Viterbi, Forney and
    DVB-T receive in time shards, the station-sharded FM stereo program,
    the COFDM and DVB-T capstones (payload-equal to the single-device
    decodes), ``ber_sharded`` and the process mesh."""
    from .demodulate.dvb_t_frame import DvbTFrameDemod
    from .demodulate.fm_stereo import _stereo_device
    from .dsp.fir import kaiser_lowpass_taps
    from .frame import (FrameMetadata, FramePacket, McsTable, OfdmFrameMod,
                        OfdmFrameStreamDemod)
    from .modulate.dvb_t_frame import DvbTFrameMod
    from .multicarrier import CarrierPlan
    from .ofdm import OfdmConfig
    from .parallel import (
        Mesh, ber_sharded, dvb_t_decode_time_sharded, dvb_t_receive_sharded,
        dvb_t_receive_time_sharded, fir_overlap_save_sharded,
        fm_demod_sharded, forney_deinterleave_sharded, make_mesh,
        make_process_mesh, ofdm_frame_decode_time_sharded,
        ofdm_soft_demap_sharded, psk31_demod_sharded, shard_channels,
        viterbi_decode_sharded)
    from .sync.ofdm_sync import OfdmPreamble
    from .waveform.dvb_t import DvbTFrameParams, DvbTLinkParams

    t_dim = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            t_dim = cand
            break
    ch_dim = n_devices // t_dim
    mesh = make_mesh(n_devices, shape=(ch_dim, t_dim), devices=devices)
    dev0 = mesh.first_device

    rng = np.random.default_rng(0)
    n = 256 * t_dim
    iq = (rng.standard_normal((ch_dim * 2, n))
          + 1j * rng.standard_normal((ch_dim * 2, n))).astype(np.complex64)
    taps = kaiser_lowpass_taps(31, 0.2, 50.0)
    audio = fm_demod_sharded(iq, taps, mesh, 48e3, 2500.0)
    y = fir_overlap_save_sharded(iq, taps, mesh)
    assert audio.shape == iq.shape and y.shape == iq.shape

    # symbol-aligned sharded OFDM soft demap over the same mesh
    plan = CarrierPlan(64, 16).with_contiguous_data(edge_guard=4)
    cfg = OfdmConfig(plan, fs=1e6)
    n_sym = 4 * t_dim
    iq2 = (rng.standard_normal((ch_dim, n_sym * 80))
           + 1j * rng.standard_normal((ch_dim, n_sym * 80))
           ).astype(np.complex64)
    llr = ofdm_soft_demap_sharded(cfg, "qpsk", iq2, n_sym, mesh)
    assert llr.shape[0] == ch_dim
    # CPE shards too: the per-symbol phases are all-gathered over 't'
    est2 = (np.ones(64) + 0.1j * np.ones(64)).astype(np.complex64)
    llr_cpe = ofdm_soft_demap_sharded(cfg.with_phase_tracking("cpe"), "qpsk",
                                      iq2, n_sym, mesh, estimate=est2)
    assert llr_cpe.shape == llr.shape

    # service-parallel DVB-T receive over the whole mesh
    segs = (rng.standard_normal((n_devices, 4 * 2112))
            + 1j * rng.standard_normal((n_devices, 4 * 2112))
            ).astype(np.complex64)
    llrs_d, cells_d = dvb_t_receive_sharded(segs, 4, 64, 0, 2, mesh)
    assert llrs_d.shape[0] == n_devices and cells_d.shape[1] == 4

    # streaming state in time shards: PLL phase, trellis, Forney lines
    sps = 256
    iq3 = (rng.standard_normal(n_devices * 8 * sps)
           + 1j * rng.standard_normal(n_devices * 8 * sps)
           ).astype(np.complex64)
    assert psk31_demod_sharded(iq3, mesh, 8000.0).shape == (n_devices * 8,)
    n_info = 1024 * n_devices - 6
    llr_stream = rng.standard_normal(2 * (n_info + 6)).astype(np.float32)
    bits = viterbi_decode_sharded(llr_stream, n_info, mesh, "1/2", "dvb_k7")
    assert bits.shape == (n_info,)
    byts = rng.integers(0, 256, max(3000 * n_devices, 2244 * 2)
                        ).astype(np.uint8)
    assert forney_deinterleave_sharded(byts, mesh).shape == byts.shape
    lls, _ = dvb_t_receive_time_sharded(
        (rng.standard_normal(4 * n_devices * 2112)
         + 1j * rng.standard_normal(4 * n_devices * 2112)
         ).astype(np.complex64), 4 * n_devices, 64, 0, 2, mesh)
    assert lls.shape[0] == 4 * n_devices

    # station-sharded FM broadcast stereo (the band gateway's demod stage)
    nb_bc = 4096
    stations = torch.as_tensor(
        rng.standard_normal((ch_dim * 2, 2, nb_bc)).astype(np.float32))
    lr_bc, pm_bc = shard_channels(
        lambda x: _stereo_pair(_stereo_device(x[:, 0], x[:, 1], 240_000.0,
                                              75e3, 15e3, 0.9, False)),
        mesh)(stations)
    assert lr_bc.shape == (ch_dim * 2, nb_bc) and pm_bc.shape == (ch_dim * 2,)

    # the COFDM frame capstone, payload-equal to the single-device stream
    # demod on the same capture
    fplan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    fcfg = OfdmConfig(fplan, fs=1e6)
    ftable = McsTable.default_ladder()
    fpre = OfdmPreamble(repeat_len=128, num_repeats=4
                        ).with_training_symbol(256, 64)
    payload = rng.integers(0, 256, 96).astype(np.uint8)
    fiq = OfdmFrameMod(fcfg, ftable, fpre, device=dev0).modulate_frame(
        FramePacket(FrameMetadata(11, 2), payload), 2)
    fbuf = np.concatenate([np.zeros(700, np.complex64), fiq,
                           np.zeros(300, np.complex64)])
    sdemod = OfdmFrameStreamDemod(fcfg, ftable, fpre, device=dev0)
    res = sdemod.feed(fbuf) + sdemod.flush()
    single_pkt = [r.packet for r in res if hasattr(r, "packet")][0]
    pkt = ofdm_frame_decode_time_sharded(fcfg, ftable, fpre, fbuf, mesh)
    assert np.array_equal(pkt.payload, single_pkt.payload)
    assert np.array_equal(pkt.payload, payload)
    assert pkt.metadata.sequence_num == 11

    # the composed DVB-T capstone: GI acquire, time-sharded receive, TPS,
    # sharded Viterbi and Forney, RS; payload-equal to the one-device decode
    params = DvbTFrameParams(DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0)
    dpay = rng.integers(0, 256, 1000).astype(np.uint8)
    frame = DvbTFrameMod(params, device=dev0).modulate(dpay)
    diq = np.concatenate([np.zeros(700, np.complex64), frame.iq])
    single = DvbTFrameDemod(params, device=dev0).decode(
        diq, frame.n_symbols, len(dpay))
    sharded = dvb_t_decode_time_sharded(diq, frame.n_symbols, len(dpay),
                                        params, mesh)
    assert np.array_equal(sharded.payload, single.payload)
    assert np.array_equal(sharded.payload, dpay)
    assert sharded.tps == single.tps

    # a link metric summed over the mesh, and the process-aware mesh
    flat = Mesh(mesh.devices.reshape(-1), ("ch",))
    ref_bits = rng.integers(0, 2, (n_devices, 64)).astype(np.uint8)
    _, errs, nb = ber_sharded(ref_bits, ref_bits ^ 1, flat)
    assert errs == nb == ref_bits.size
    pm = make_process_mesh(devices=devices)
    n_local = (torch.cuda.device_count() if devices is None
               else len(devices))
    assert pm.devices.shape == (pm.process_count, n_local)


def _stereo_pair(out):
    mono, sub, pilot_mag, _ = out
    return mono + sub, pilot_mag


if __name__ == "__main__":
    step, example = entry()
    print("entry:", tuple(step(*example).shape))
