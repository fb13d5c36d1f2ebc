"""Torch port: the RX extras of the COFDM link and the rest of slice 1
against the JAX package: DFT precoding, common-phase-error tracking,
per-symbol pilot interpolation, soft_demap's pilot_interp / precoding / cpe
branches, QAM-256, per-symbol grid layouts and the DVB-T COFDM presets.
IQ, estimates and phases within 1e-5 (FFT and transcendental rounding
differ between the libraries), LLRs within rtol 1e-4 / atol 1e-4, maps and
layouts exact; frames modulated by the JAX package decode in the port."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu.frame as J
from orion_sdr_tpu import constellation as JC
from orion_sdr_tpu import ofdm as JO
from orion_sdr_tpu.multicarrier import CarrierGrid as JaxGrid
from orion_sdr_tpu.multicarrier import CarrierPlan as JaxPlan
from orion_sdr_tpu.multicarrier import grid_map as jax_grid_map
from orion_sdr_tpu.ofdm import OfdmConfig as JaxOfdmConfig
from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble as JaxPreamble
from orion_sdr_tpu.waveform import dvb_t as JD

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import constellation as PC
from orion_sdr_tpu_torch import convert
from orion_sdr_tpu_torch import ofdm as PO
from orion_sdr_tpu_torch.multicarrier import grid_map
from orion_sdr_tpu_torch.waveform import dvb_t as PD

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

FS = 1e6
PILOTS = [(k, 1.0 + 0j) for k in range(-104, 105, 8) if k]


def _cplx(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _configs(pilots=False, **opts):
    jplan, pplan = JaxPlan(256, 64), P.CarrierPlan(256, 64)
    if pilots:
        jplan = jplan.with_pilot_carriers(PILOTS)
        pplan = pplan.with_pilot_carriers(PILOTS)
    jc = JaxOfdmConfig(jplan.with_contiguous_data(edge_guard=16), fs=FS)
    pc = P.OfdmConfig(pplan.with_contiguous_data(edge_guard=16), fs=FS)
    for name, value in opts.items():
        jc = getattr(jc, f"with_{name}")(value)
        pc = getattr(pc, f"with_{name}")(value)
    assert convert.ofdm_config_from_fields(dataclasses.asdict(jc)) == pc
    return jc, pc


def test_dft_precode_and_deprecode_match():
    z = _cplx((3, 5, 160), 1)
    for jf, pf in ((JO.dft_precode, PO.dft_precode),
                   (JO.dft_deprecode, PO.dft_deprecode)):
        np.testing.assert_allclose(pf(torch.as_tensor(z)).numpy(),
                                   np.asarray(jf(z)), rtol=0, atol=1e-5)
    back = PO.dft_deprecode(PO.dft_precode(torch.as_tensor(z))).numpy()
    np.testing.assert_allclose(back, z, rtol=0, atol=1e-5)


@pytest.mark.parametrize("order", ["bpsk", "qpsk", "qam16"])
def test_cpe_matches(order):
    # a constellation's points under a drifting common phase, with noise
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 12 * 40 * PC.BITS_PER_SYMBOL[order])
    pts = PC.map_bits(torch.as_tensor(bits), order).numpy().reshape(12, 40)
    drift = np.exp(1j * np.linspace(0.0, 2.5, 12))[:, None]
    z = (pts * drift + _cplx(pts.shape, 3, 0.05)).astype(np.complex64)
    for jf, pf in ((JO.cpe_raw_phases, PO.cpe_raw_phases),):
        np.testing.assert_allclose(pf(torch.as_tensor(z), order).numpy(),
                                   np.asarray(jf(z, order)), rtol=0,
                                   atol=1e-5)
    raw = np.array(JO.cpe_raw_phases(z, order))
    np.testing.assert_allclose(
        PO.cpe_unwrap(torch.as_tensor(raw), order).numpy(),
        np.asarray(JO.cpe_unwrap(raw, order)), rtol=0, atol=1e-5)
    ours, ph = PO.cpe_correct(torch.as_tensor(z), order)
    ref, jph = JO.cpe_correct(z, order)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), rtol=0,
                               atol=1e-5)
    if order != "qam16":   # 40 QAM-16 cells give a noisy 4th-power estimate
        # the drift is taken out up to the constellation's symmetry
        np.testing.assert_allclose(np.diff(ph.numpy()),
                                   np.diff(np.linspace(0.0, 2.5, 12)),
                                   atol=0.05)


def test_per_symbol_channel_estimate_matches():
    rng = np.random.default_rng(4)
    freq = _cplx((2, 6, 128), 5)
    bins = np.stack([rng.choice(np.arange(4, 124), 11, replace=False)
                     for _ in range(6)])
    bins[2, :2] = [60, 60]                      # a repeated bin in a symbol
    vals = _cplx((6, 11), 6) + 1.5
    ours = PO.channel_estimate_pilots(torch.as_tensor(freq), bins, vals, 128)
    ref = np.asarray(JO.channel_estimate_pilots(freq, bins, vals, 128))
    assert ours.shape == ref.shape and ours.dtype == torch.complex64
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    # 1-D bins that are not a numpy array take the same per-symbol path
    bins1 = [5, 40, 41, 90, 120]
    vals1 = np.ones(5, np.complex64)
    ours = PO.channel_estimate_pilots(torch.as_tensor(freq), bins1, vals1,
                                      128)
    ref = np.asarray(JO.channel_estimate_pilots(
        freq, jax.numpy.asarray(bins1), vals1, 128))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


SOFT_DEMAP_CASES = {
    "pilot_interp": dict(pilots=True, equalizer_method="pilot_interp"),
    "pilot_interp_cpe": dict(pilots=True, equalizer_method="pilot_interp",
                             phase_tracking="cpe"),
    "precoding": dict(transform_precoding=True),
    "cpe": dict(phase_tracking="cpe"),
    "pilot_interp_no_pilots": dict(equalizer_method="pilot_interp"),
}


@pytest.mark.parametrize("case", sorted(SOFT_DEMAP_CASES))
@pytest.mark.parametrize("order", ["qpsk", "qam16"])
def test_soft_demap_branches_match(case, order):
    jc, pc = _configs(**SOFT_DEMAP_CASES[case])
    iq = _cplx((2, 4 * 320 + 50), 7, 0.1)
    ref = np.asarray(J.soft_demap(jc, order, iq, 4))
    ours = P.soft_demap(pc, order, torch.as_tensor(iq), 4)
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["precoding", "cpe"])
def test_soft_demap_with_an_estimate_matches(case):
    # a held estimate: CSI-weighted, except after DFT despreading
    jc, pc = _configs(**SOFT_DEMAP_CASES[case])
    iq = _cplx((4 * 320,), 8, 0.1)
    est = _cplx((256,), 9) + 2.0
    ref = np.asarray(J.soft_demap(jc, "qpsk", iq, 4, est))
    ours = P.soft_demap(pc, "qpsk", torch.as_tensor(iq), 4,
                        torch.as_tensor(est))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pilots", [False, True])
def test_ofdm_mod_with_precoding_matches(pilots):
    jc, pc = _configs(pilots=pilots, transform_precoding=True)
    n_data = P.CarrierGrid(pc.carrier_plan).num_data_carriers
    bits = np.random.default_rng(10).integers(0, 2, 3 * 2 * n_data - 5
                                              ).astype(np.uint8)
    ref, _ = JO.ofdm_mod(jc, bits)
    ours, _ = PO.ofdm_mod(pc, torch.as_tensor(bits))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_qam256_map_and_llrs_match():
    bits = np.random.default_rng(13).integers(0, 2, 8 * 600).astype(np.uint8)
    ours = PC.map_bits(torch.as_tensor(bits), "qam256").numpy()
    assert np.array_equal(ours, np.asarray(JC.map_bits(bits, "qam256")))
    assert np.isclose(np.mean(np.abs(ours) ** 2), 1.0, atol=0.05)
    z = _cplx((3, 200), 14, 0.7)
    np.testing.assert_allclose(
        PC.soft_llr(torch.as_tensor(z), "qam256").numpy(),
        np.asarray(JC.soft_llr(z, "qam256")), rtol=1e-4, atol=1e-4)
    # hard decisions of the LLRs give back the bits on the points
    llr = PC.soft_llr(torch.as_tensor(ours), "qam256").numpy()
    assert np.array_equal((llr < 0).astype(np.uint8), bits)


def test_per_symbol_grid_map_matches():
    jc, pc = _configs(pilots=True)
    grid, jgrid = P.CarrierGrid(pc.carrier_plan), JaxGrid(jc.carrier_plan)
    syms = _cplx((2, 5, grid.num_data_carriers), 15)
    rng = np.random.default_rng(16)
    bins = np.stack([rng.choice(grid.pilot_bins, 6, replace=False)
                     for _ in range(5)])
    vals = _cplx((5, 6), 17)
    ours = grid_map(grid, torch.as_tensor(syms), bins, vals)
    assert np.array_equal(ours.numpy(), np.asarray(jax_grid_map(
        jgrid, syms, bins, vals)))
    # one value row for every symbol broadcasts, as in the JAX package
    ours = grid_map(grid, torch.as_tensor(syms), bins, vals[0])
    assert np.array_equal(ours.numpy(), np.asarray(jax_grid_map(
        jgrid, syms, bins, vals[0])))


@pytest.mark.parametrize("name", ["dvb_t_config", "dvb_t_scattered_config"])
def test_dvb_t_presets_match(name):
    for guard, bw in (("1/4", 333_000.0), ("1/16", 1e6)):
        ref = getattr(JD, name)(guard, bw)
        ours = getattr(PD, name)(guard, bw)
        assert convert.ofdm_config_from_fields(dataclasses.asdict(ref)) == ours
        assert ours.dvb_t_scattered == (name == "dvb_t_scattered_config")


def _jax_frames(jc, table, jp, frames, channel):
    mod = J.OfdmFrameMod(jc, table, jp)
    return [channel(mod.modulate_frame(J.FramePacket(meta, data), 30 + i)
                    [jp.total_len():], i)
            for i, (meta, data) in enumerate(frames)]


def test_jax_frames_decode_in_the_port_with_pilot_interp_and_cpe():
    """Frames modulated by the JAX package through a two-path channel and a
    slow phase drift decode in the port with per-symbol pilot equalization
    and CPE tracking."""
    jc, pc = _configs(pilots=True, equalizer_method="pilot_interp",
                      phase_tracking="cpe")
    jp = JaxPreamble(repeat_len=128, num_repeats=4).with_training_symbol(256,
                                                                         64)
    rng = np.random.default_rng(18)
    frames = [(J.FrameMetadata(40 + i, i % 3), rng.integers(
        0, 256, 250).astype(np.uint8)) for i in range(3)]

    def channel(x, i):
        y = x + 0.4 * np.concatenate([np.zeros(5, np.complex64), x[:-5]])
        y = y * np.exp(1j * 2e-4 * (i + 1) * np.arange(len(y)))
        return (y + _cplx(y.shape, 19 + i, 0.003)).astype(np.complex64)

    iqs = _jax_frames(jc, J.McsTable.default_ladder(), jp, frames, channel)
    demod = P.OfdmFrameDemod(pc, P.McsTable.default_ladder(), device="cpu")
    for (meta, data), iq in zip(frames, iqs):
        got = demod.decode(iq)
        assert got.metadata.sequence_num == meta.sequence_num
        assert np.array_equal(got.payload, data)


def test_qam256_and_precoded_frames_decode_across_packages():
    jc, pc = _configs(transform_precoding=True)
    jp = JaxPreamble(repeat_len=128, num_repeats=4).with_training_symbol(256,
                                                                         64)
    pp = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    jt = J.McsTable([J.Mcs("qam256", J.InnerFec.ldpc("N512R12"),
                           J.OuterFec.bch(8))])
    pt = P.McsTable([P.Mcs("qam256", P.InnerFec.ldpc("N512R12"),
                           P.OuterFec.bch(8))])
    data = np.random.default_rng(20).integers(0, 256, 300).astype(np.uint8)
    ref = J.OfdmFrameMod(jc, jt, jp).modulate_frame(
        J.FramePacket(J.FrameMetadata(3, 0), data), 8)
    ours = P.OfdmFrameMod(pc, pt, pp, device="cpu").modulate_frame(
        P.FramePacket(P.FrameMetadata(3, 0), data), 8)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    got = P.OfdmFrameDemod(pc, pt, device="cpu").decode(ref[jp.total_len():])
    assert np.array_equal(got.payload, data)


def test_dvb_t_config_link_round_trips_in_the_port():
    cfg = PD.dvb_t_config("1/8", 1e6)
    pre = P.OfdmPreamble(repeat_len=1024, num_repeats=2).with_training_symbol(
        2048, 256)
    table = PD.dvb_t_mcs_table()
    data = np.random.default_rng(21).integers(0, 256, 400).astype(np.uint8)
    iq = P.OfdmFrameMod(cfg, table, pre, device="cpu").modulate_frame(
        P.FramePacket(P.FrameMetadata(6, 2), data), 0)
    got = P.OfdmFrameDemod(cfg, table, device="cpu").decode(
        iq[pre.total_len():])
    assert got.metadata.mcs_index == 2
    assert np.array_equal(got.payload, data)
