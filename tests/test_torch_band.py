"""Torch port, the band receivers (frame/band.py's OfdmFrameBandStreamDemod,
demodulate/dvb_t_stream.py's DvbTBandStreamDemod) against the JAX package
on the CPU, on the wideband captures of tests/test_frame.py:487 (three
COFDM links at 8 MS/s) and tests/test_dvb_t.py:377 (two DVB-T muxes at
4x rate), built by the card-only tests' helpers. A file of its own, so
that ``--dist loadfile`` places its full DVB-T frames alone.

Tolerances: the channelized streams within 1e-5 of their largest
magnitude (the two channelizers' FIRs round apart; measured at most 1e-6);
decoded payloads, sequence numbers and cell ids exact, and equal to the
JAX receivers'; the port's results equal under two chunkings."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import torch

from test_torch_dsp_iir import close
from test_torch_gpu import _band_run, _upsample, _wideband

import orion_sdr_tpu as J
from orion_sdr_tpu.dsp.channelizer import Channelizer as JChannelizer
from orion_sdr_tpu.frame import OfdmFrameMod as JMod

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import convert

torch.set_num_threads(1)
CPU = "cpu"
FS = 1e6


def _channelized(jax_rx, port_rx, wide):
    """The capture through fresh copies of both receivers' channelizers."""
    jc = jax_rx.channelizer
    ref = JChannelizer(jc.fs_wide, jc.fs_out, jc.centers_hz)
    ref.taps = jc.taps
    pc = convert.channelizer_from_jax(vars(ref), device=CPU)
    pc.taps = port_rx.channelizer.taps
    assert np.array_equal(pc.taps, jc.taps)
    want = np.concatenate([np.asarray(ref.push(wide)),
                           np.asarray(ref.flush())], axis=-1)
    got = torch.cat([pc.push(wide), pc.flush()], dim=-1)
    return want, got


def test_cofdm_band_three_links():
    plan = J.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    jcfg = J.OfdmConfig(plan, fs=FS)
    jpre = J.OfdmPreamble(repeat_len=128, num_repeats=4
                          ).with_training_symbol(256, 64)
    jtable = J.McsTable.default_ladder()
    cfg = convert.ofdm_config_from_fields(dataclasses.asdict(jcfg))
    pre = convert.preamble_from_fields(dataclasses.asdict(jpre))
    table = P.McsTable.default_ladder()
    fs_wide = 8.0 * FS
    centers = [-2.1e6, 0.3e6, 1.5e6]
    payloads = [np.random.default_rng(40 + i).integers(0, 256, 120).astype(
        np.uint8) for i in range(3)]
    frames = [JMod(jcfg, jtable, jpre).modulate_frame(
        J.FramePacket(J.FrameMetadata(i, 1), p), i)
        for i, p in enumerate(payloads)]
    wide = _wideband([f / 8.0 for f in frames], centers,
                     [3000 + 9000 * i for i in range(3)], 120_000, fs_wide, 8,
                     50, 0.001)

    jrx = J.OfdmFrameBandStreamDemod(jcfg, jtable, jpre, centers, fs_wide)
    want = _band_run(jrx, wide, 37_003)
    for chunk in (37_003, 50_000):
        rx = P.OfdmFrameBandStreamDemod(cfg, table, pre, centers, fs_wide,
                                        device=CPU)
        got = _band_run(rx, wide, chunk)
        for c, p in enumerate(payloads):
            mine = [r for r in got.get(c, []) if isinstance(r, P.RxFrame)]
            ref = [r for r in want.get(c, []) if hasattr(r, "packet")]
            assert mine and np.array_equal(mine[0].packet.payload, p), c
            assert mine[0].packet.metadata.sequence_num == c
            assert [r.packet.payload.tolist() for r in mine] == \
                [r.packet.payload.tolist() for r in ref]
    close(*_channelized(jrx, rx, wide))


def test_dvb_t_band_two_muxes():
    jparams = J.DvbTFrameParams(J.DvbTLinkParams("1/32", "qpsk", "1/2"), 0,
                                5)
    params = convert.dvb_t_frame_params_from_fields(
        dataclasses.asdict(jparams))
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, 300).astype(np.uint8) for _ in range(2)]
    frames = [J.DvbTFrameMod(jparams).modulate(p) for p in payloads]
    n_sym = frames[0].n_symbols
    fs = J.nb_bandwidth_fs(1_000_000.0)
    fs_wide = 4.0 * fs
    centers = [-1.4e6, 1.1e6]
    n_wide = max(len(_upsample(f.iq, 4)) for f in frames) + 40_000
    wide = _wideband([f.iq for f in frames], centers, [8_000, 12_000], n_wide,
                     fs_wide, 4, 3, 0.002)

    jrx = J.DvbTBandStreamDemod(jparams, n_sym, 300, centers, fs, fs_wide)
    want = _band_run(jrx, wide, 120_000)
    for chunk in (120_000, 77_777):
        rx = P.DvbTBandStreamDemod(params, n_sym, 300, centers, fs, fs_wide,
                                   device=CPU)
        got = _band_run(rx, wide, chunk)
        for c, p in enumerate(payloads):
            mine = [r for r in got.get(c, []) if isinstance(r, P.DvbTRxFrame)]
            ref = [r for r in want.get(c, []) if hasattr(r, "payload")]
            assert mine and np.array_equal(mine[0].payload, p), c
            assert mine[0].tps.cell_id == 5
            assert [r.payload.tolist() for r in mine] == \
                [r.payload.tolist() for r in ref]
    close(*_channelized(jrx, rx, wide))
