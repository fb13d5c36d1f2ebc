"""Torch port: the generic OFDM receive (``ofdm_demod``, ``ofdm_decide``,
``ofdm_soft_demod``, ``zf_equalize``/``mmse_equalize``,
``channel_estimate_training``, ``build_ofdm_rx_frame``), ``ofdm_mod``'s
caller pilots, ``OfdmConfig.validate`` and the window helpers,
``max_pilot_safe_backoff`` and ``CarrierPlan.validate_edge_guard`` against
the JAX package on the same numpy inputs, mirroring tests/test_ofdm.py and
tests/test_ofdm_matrix.py at their sizes.

Tolerances: hard bits and LLR signs bit-exact; IQ and soft symbols within
1e-5 of the peak (XLA and torch differ in FFT summation order, as in
tests/test_torch_ofdm.py); LLRs within 1e-4 of the peak; EVM within 1e-3
dB."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as J
from orion_sdr_tpu.multicarrier import CarrierPlan as JaxPlan, \
    symbol_fft as j_symbol_fft, grid_extract as j_grid_extract, \
    max_pilot_safe_backoff as j_max_backoff
from orion_sdr_tpu.ofdm import OfdmConfig as JaxCfg, ofdm_mod as j_mod, \
    ofdm_demod as j_demod, ofdm_decide as j_decide, \
    ofdm_soft_demod as j_soft, zf_equalize as j_zf, mmse_equalize as j_mmse, \
    channel_estimate_training as j_training, \
    channel_estimate_pilots as j_pilots, build_ofdm_rx_frame as j_rx_frame
from orion_sdr_tpu.sync import training_symbol_freq_pattern as j_train_pat

from orion_sdr_tpu_torch.multicarrier import CarrierPlan, CarrierPlanError, \
    symbol_fft, grid_extract, max_pilot_safe_backoff
from orion_sdr_tpu_torch.ofdm import OfdmConfig, ofdm_mod, ofdm_demod, \
    ofdm_decide, ofdm_soft_demod, zf_equalize, mmse_equalize, \
    channel_estimate_training, channel_estimate_pilots, build_ofdm_rx_frame
from orion_sdr_tpu_torch.sync.ofdm_sync import training_symbol_freq_pattern
from orion_sdr_tpu_torch.frame.types import InterleaverKind, OuterFec, \
    ScramblerKind
from orion_sdr_tpu.frame.types import InterleaverKind as JIl, \
    OuterFec as JOuter, ScramblerKind as JScr

torch.set_num_threads(1)

FS = 48_000.0
CPU = "cpu"
ORDERS = ["bpsk", "qpsk", "qam16", "qam64", "qam256"]


def cfgs(order="qpsk", n_fft=64, cp=16, pilots=None, data=None, **kw):
    def plan(cls):
        p = cls(n_fft, cp)
        if pilots:
            p = p.with_pilot_carriers(pilots)
        return p.with_data_carriers(data) if data else \
            p.with_contiguous_data()
    return (JaxCfg(plan(JaxPlan), FS, constellation=order, **kw),
            OfdmConfig(plan(CarrierPlan), FS, constellation=order, **kw))


def close(ours, ref, tol=1e-5):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1.0))


def bits_for(cfg, n_sym, seed, extra=0):
    return np.random.default_rng(seed).integers(
        0, 2, cfg.bits_per_ofdm_symbol() * n_sym + extra).astype(np.uint8)


def both_demod(jc, pc, iq, **kw):
    est = kw.pop("estimate", None)
    ours, ph = ofdm_demod(pc, iq, estimate=est, device=CPU, **kw)
    ref, jph = j_demod(jc, iq, estimate=est, **kw)
    close(ours, ref)
    assert abs(float(ph) - float(jph)) < 1e-4
    hard = ofdm_decide(pc, ours)
    assert np.array_equal(hard.numpy(), np.asarray(j_decide(jc, ref)))
    return ours, ref, hard.numpy()


@pytest.mark.parametrize("order", ORDERS)
def test_noiseless_roundtrip_matches(order):
    jc, pc = cfgs(order)
    bits = bits_for(pc, 6, 0)
    iq, _ = ofdm_mod(pc, bits, device=CPU)
    close(iq, j_mod(jc, bits)[0])
    _, _, hard = both_demod(jc, pc, iq.numpy())
    assert np.array_equal(hard, bits)


def test_rf_carrier_roundtrip_and_phase_carry():
    jc, pc = cfgs("qam16", rf_hz=6000.0)
    bits = bits_for(pc, 4, 1)
    iq, ph = ofdm_mod(pc, bits, phase0=0.4, device=CPU)
    j_iq, j_ph = j_mod(jc, bits, phase0=0.4)
    close(iq, j_iq)
    assert abs(ph - float(j_ph)) < 1e-5
    _, _, hard = both_demod(jc, pc, iq.numpy(), phase0=-0.4)
    assert np.array_equal(hard, bits)


@pytest.mark.parametrize("order", ORDERS)
def test_soft_llrs_match_and_sign_is_the_decision(order):
    jc, pc = cfgs(order, cp=8)
    bits = bits_for(pc, 4, 21)
    rng = np.random.default_rng(22)
    iq = ofdm_mod(pc, bits, device=CPU)[0].numpy()
    iq = (iq + 0.05 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))
          ).astype(np.complex64)
    soft, ref, hard = both_demod(jc, pc, iq)
    llr = ofdm_soft_demod(pc, soft)
    close(llr, j_soft(jc, ref), tol=1e-4)
    assert np.array_equal((llr.numpy() < 0).astype(np.uint8), hard)


def test_batched_leading_dims_match():
    jc, pc = cfgs("qpsk")
    rng = np.random.default_rng(30)
    bits = rng.integers(0, 2, (3, 2, 5 * pc.bits_per_ofdm_symbol())
                        ).astype(np.uint8)
    iq, _ = ofdm_mod(pc, bits, device=CPU)
    assert iq.shape == (3, 2, 5 * 80)
    close(iq, j_mod(jc, bits)[0])
    soft, _, hard = both_demod(jc, pc, iq.numpy(), n_symbols=5)
    assert soft.shape == (3, 2, 5, pc.carrier_plan.num_data_carriers())
    assert np.array_equal(hard, bits)


def test_evm_diagnostics_match():
    jc, pc = cfgs("qpsk")
    bits = bits_for(pc, 2, 3)
    rng = np.random.default_rng(3)
    iq = ofdm_mod(pc, bits, device=CPU)[0].numpy()
    iq = iq + J.awgn(rng, iq.shape, 0.02)
    soft, ref, hard = both_demod(jc, pc, iq)
    ours = build_ofdm_rx_frame(pc, soft, torch.as_tensor(hard))
    theirs = j_rx_frame(jc, ref, j_decide(jc, ref))
    assert ours.num_symbols == theirs.num_symbols == 2
    assert abs(ours.evm_db - theirs.evm_db) < 1e-3
    assert -60 < ours.evm_db < -10
    assert np.array_equal(ours.bits, hard)


def test_evm_matches_known_error_magnitude():
    jc, pc = cfgs("qpsk", cp=8)
    bits = bits_for(pc, 4, 11)
    soft, _ = ofdm_demod(pc, ofdm_mod(pc, bits, device=CPU)[0])
    err = soft.numpy() + 0.05
    ours = build_ofdm_rx_frame(pc, err, ofdm_decide(pc, err, device=CPU))
    theirs = j_rx_frame(jc, err, np.asarray(j_decide(jc, err)))
    assert abs(ours.evm_db - theirs.evm_db) < 1e-3
    assert abs(ours.evm_db - 20.0 * np.log10(0.05)) < 1.0
    assert build_ofdm_rx_frame(pc, np.zeros(0, np.complex64),
                               np.zeros(0, np.uint8)).evm_db is None


def test_training_hold_flat_gain_phase():
    jc, pc = cfgs("qam16")
    known = training_symbol_freq_pattern(64)
    assert np.array_equal(known, j_train_pat(64))
    h = 0.7 * np.exp(1j * 0.8)
    rx_train = (known * h).astype(np.complex64)
    est = channel_estimate_training(rx_train, known, device=CPU)
    close(est, j_training(rx_train, known))
    bits = bits_for(pc, 3, 4)
    iq = (ofdm_mod(pc, bits, device=CPU)[0].numpy() * h).astype(np.complex64)
    _, _, hard = both_demod(jc, pc, iq, estimate=est.numpy())
    assert np.array_equal(hard, bits)


def _bin_channel(pc, iq, h):
    g = pc.grid()
    freq = symbol_fft(torch.as_tensor(iq), g.n_fft, g.cp_len)
    from orion_sdr_tpu_torch.multicarrier import ofdm_assemble
    return ofdm_assemble(freq * torch.as_tensor(h), g.cp_len).numpy()


def test_training_hold_corrects_static_multipath():
    jc, pc = cfgs("qam16", cp=8)
    bits = bits_for(pc, 8, 7)
    n = np.arange(64)
    h = (0.5 + 0.4 * np.cos(2 * np.pi * n / 64)
         + 0.3j * np.sin(2 * np.pi * 3 * n / 64)).astype(np.complex64) + 0.4
    rx = _bin_channel(pc, ofdm_mod(pc, bits, device=CPU)[0].numpy(), h)
    known = np.ones(64, np.complex64)
    est = channel_estimate_training(h * known, known, device=CPU).numpy()
    _, _, hard = both_demod(jc, pc, rx, estimate=est)
    assert np.array_equal(hard, bits)


@pytest.mark.parametrize("noise_var", [0.0, 0.01, 0.3])
def test_zf_and_mmse_equalizers_match(noise_var):
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((4, 64)) + 1j * rng.standard_normal((4, 64))
         ).astype(np.complex64)
    h = (rng.standard_normal(64) + 1j * rng.standard_normal(64)
         ).astype(np.complex64)
    h[5] = 0.0
    ours = (mmse_equalize(torch.as_tensor(x), torch.as_tensor(h), noise_var)
            if noise_var else zf_equalize(torch.as_tensor(x),
                                          torch.as_tensor(h)))
    ref = j_mmse(x, h, noise_var) if noise_var else j_zf(x, h)
    close(ours, ref)


def test_pilot_interp_multipath_matches():
    pilots = [(i, 1.0 + 0j) for i in range(-28, 29, 7)]
    jc, pc = cfgs("qpsk", pilots=pilots)
    bits = bits_for(pc, 4, 5)
    iq = ofdm_mod(pc, bits, device=CPU)[0].numpy()
    chan = np.array([1.0, 0.35 * np.exp(1j * 1.1)], np.complex64)
    rx = np.convolve(iq, chan)[:len(iq)].astype(np.complex64)
    g, jg = pc.grid(), jc.grid()
    freq = symbol_fft(torch.as_tensor(rx), 64, 16)
    est = channel_estimate_pilots(freq, g.pilot_bins, g.pilot_values, 64)
    soft = grid_extract(g, zf_equalize(freq, est))
    j_freq = j_symbol_fft(rx, 64, 16)
    ref = j_grid_extract(jg, j_zf(j_freq, j_pilots(
        j_freq, jg.pilot_bins, jg.pilot_values, 64)))
    close(soft, ref)
    assert np.array_equal(ofdm_decide(pc, soft).numpy(), bits)


def test_caller_pilots_in_ofdm_mod():
    """``pilot_bins``/``pilot_values`` replace the plan's pilots, constant
    and per symbol, against the JAX package's ``grid_map`` route."""
    jc, pc = cfgs("qpsk", n_fft=64, cp=16, data=list(range(-20, 0)) +
                  list(range(1, 21)))
    bits = bits_for(pc, 3, 40, extra=-9)
    pb = np.array([23, 40, 60])
    pv = np.array([1, -1, 1j], np.complex64)
    ours, _ = ofdm_mod(pc, bits, pilot_bins=pb, pilot_values=pv, device=CPU)
    close(ours, j_mod(jc, bits, pilot_bins=pb, pilot_values=pv)[0])
    pb2 = np.array([[23, 40], [24, 41], [25, 42]])
    pv2 = np.full((3, 2), 0.5 - 0.5j, np.complex64)
    ours, _ = ofdm_mod(pc, bits, pilot_bins=pb2, pilot_values=pv2,
                       device=CPU)
    close(ours, j_mod(jc, bits, pilot_bins=pb2, pilot_values=pv2)[0])
    _, _, hard = both_demod(jc, pc, ours.numpy())
    assert np.array_equal(hard[:len(bits)], bits)


@pytest.mark.parametrize("order", ["bpsk", "qpsk", "qam16", "qam64"])
def test_dft_s_ofdm_roundtrip_and_multipath(order):
    jc, pc = cfgs(order)
    jc, pc = jc.with_transform_precoding(), pc.with_transform_precoding()
    bits = bits_for(pc, 5, 10)
    iq, _ = ofdm_mod(pc, bits, device=CPU)
    close(iq, j_mod(jc, bits)[0])
    chan = np.array([1.0, 0.4 * np.exp(1j * 0.7), 0.15j], np.complex64)
    rx = np.convolve(iq.numpy(), chan)[:iq.shape[0]].astype(np.complex64)
    est = np.fft.fft(chan, 64).astype(np.complex64)
    _, _, hard = both_demod(jc, pc, rx, estimate=est)
    assert np.array_equal(hard, bits)


def test_tx_gain_and_rx_gain_match():
    jc, pc = cfgs("qpsk", cp=8, gain=3.0)
    bits = bits_for(pc, 2, 5)
    iq, _ = ofdm_mod(pc, bits, device=CPU)
    close(iq, j_mod(jc, bits)[0])
    both_demod(jc, pc, iq.numpy(), gain=1.0 / 3.0)


def test_partial_bits_pad_and_decode_as_zero():
    jc, pc = cfgs("qpsk", cp=8)
    bps = pc.bits_per_ofdm_symbol()
    bits = bits_for(pc, 1, 0, extra=bps // 2)
    iq, _ = ofdm_mod(pc, bits, device=CPU)
    assert iq.shape[0] == 2 * pc.samples_per_ofdm_symbol()
    _, _, hard = both_demod(jc, pc, iq.numpy())
    assert np.array_equal(hard[:len(bits)], bits)
    assert not hard[len(bits):].any()


@pytest.mark.parametrize("backoff", [0, 2])
@pytest.mark.parametrize("equalizer", ["training_symbol", "pilot_interp"])
def test_backoff_by_equalizer_permutation(backoff, equalizer):
    """tests/test_ofdm_matrix.py's window backoff × equalizer grid: the
    backoff's phase ramp learnt by a training symbol through the same
    window, or by pilots spaced within ``max_pilot_safe_backoff``."""
    pilots = ([(b, 1.0 + 0j) for b in range(-28, 29, 4) if b]
              if equalizer == "pilot_interp" else None)
    jc, pc = cfgs("qpsk", pilots=pilots, rx_window_backoff=backoff)
    bps = pc.bits_per_ofdm_symbol()
    rng = np.random.default_rng(10 + backoff)
    bits = rng.integers(0, 2, 6 * bps).astype(np.uint8)
    iq = ofdm_mod(pc, bits, device=CPU)[0].numpy()
    iq = (iq + J.awgn(rng, len(iq), 1e-3)).astype(np.complex64)
    if equalizer == "training_symbol":
        t = ofdm_mod(pc, (np.arange(bps) & 1).astype(np.uint8),
                     device=CPU)[0]
        est = channel_estimate_training(
            symbol_fft(t, 64, 16, backoff=backoff, n_symbols=1)[0],
            symbol_fft(t, 64, 16, n_symbols=1)[0])
        soft, ref, hard = both_demod(jc, pc, iq, estimate=est.numpy())
    else:
        assert backoff <= max_pilot_safe_backoff(64, 4)
        g, jg = pc.grid(), jc.grid()
        freq = symbol_fft(torch.as_tensor(iq), 64, 16, backoff=backoff)
        soft = grid_extract(g, zf_equalize(freq, channel_estimate_pilots(
            freq, g.pilot_bins, g.pilot_values, 64)))
        j_freq = j_symbol_fft(iq, 64, 16, backoff=backoff)
        ref = j_grid_extract(jg, j_zf(j_freq, j_pilots(
            j_freq, jg.pilot_bins, jg.pilot_values, 64)))
        close(soft, ref)
        hard = ofdm_decide(pc, soft).numpy()
    close(ofdm_soft_demod(pc, soft), j_soft(jc, ref), tol=1e-4)
    assert np.array_equal(hard, bits)


def test_validate_matches_the_reference():
    """Every rejection of the JAX ``OfdmConfig.validate`` rejects here, and
    the valid configs pass."""
    jc, pc = cfgs("qpsk")
    jc.validate()
    pc.validate()
    bad = [
        lambda c, m: c.with_transform_precoding().with_dvb_t_scattered(),
        lambda c, m: c.with_equalizer_method("nope"),
        lambda c, m: c.with_phase_tracking("pll"),
        lambda c, m: c.with_rx_window_backoff(17),
        lambda c, m: c.with_fs(0.0),
        lambda c, m: c.with_outer_fec(m[1].bch(0)),
        lambda c, m: c.with_outer_fec(m[1].reed_solomon(10, 3)),
        lambda c, m: c.with_outer_interleaver(m[0].block(0, 4)),
        lambda c, m: c.with_scrambler(m[2].additive(0x4A80, 15, 0x7FFF,
                                                    per_frame=True))
        .with_header_format("no_header"),
    ]
    for make in bad:
        j = make(jc, (JIl, JOuter, JScr))
        p = make(pc, (InterleaverKind, OuterFec, ScramblerKind))
        with pytest.raises(ValueError):
            j.validate()
        with pytest.raises(ValueError):
            p.validate()


@pytest.mark.parametrize("beta", [-0.1, 0.0, 0.125, 0.3, 0.5, 0.9])
def test_symbol_window_beta_helpers(beta):
    jc, pc = cfgs("qpsk", n_fft=256, cp=64)
    for name in ("with_symbol_window_beta_guard",
                 "with_symbol_window_beta_tu"):
        assert getattr(pc, name)(beta).carrier_plan.window_roll_off == \
            getattr(jc, name)(beta).carrier_plan.window_roll_off


def test_backoff_limit_and_edge_guard():
    for n_fft, spacing in ((2048, 12), (64, 7), (256, 0), (16, 3)):
        assert max_pilot_safe_backoff(n_fft, spacing) == \
            j_max_backoff(n_fft, spacing)
    for guard in (0, 4, 16, 17):
        jp = JaxPlan(64, 16).with_contiguous_data(edge_guard=16)
        pp = CarrierPlan(64, 16).with_contiguous_data(edge_guard=16)
        try:
            jp.validate_edge_guard(guard)
            ok = True
        except ValueError:
            ok = False
        if ok:
            pp.validate_edge_guard(guard)
        else:
            with pytest.raises(CarrierPlanError):
                pp.validate_edge_guard(guard)
