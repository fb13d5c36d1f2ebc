"""Torch port: OTFS (ISFFT/SFFT, ``otfs_mod``/``otfs_demod`` under ZF,
LMMSE and per-symbol pilot interpolation) against the JAX package on the
same numpy inputs, mirroring tests/test_otfs.py's cases at its sizes.

Tolerances: hard bits bit-exact; IQ and soft delay-Doppler symbols within
1e-5 of the peak (the FFT pair's float32 summation order differs between
XLA and torch, as in tests/test_torch_ofdm.py); bit error rates equal."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.multicarrier import CarrierPlan as JaxPlan
from orion_sdr_tpu.ofdm import OfdmConfig as JaxCfg, ofdm_decide as j_decide, \
    ofdm_mod as j_ofdm_mod, mmse_equalize as j_mmse
from orion_sdr_tpu.multicarrier import symbol_fft as j_symbol_fft, \
    grid_extract as j_grid_extract
from orion_sdr_tpu.otfs import isfft as j_isfft, sfft as j_sfft, \
    otfs_mod as j_otfs_mod, otfs_demod as j_otfs_demod, \
    otfs_num_symbols as j_num_symbols

from orion_sdr_tpu_torch.multicarrier import CarrierPlan, symbol_fft, \
    grid_extract
from orion_sdr_tpu_torch.ofdm import OfdmConfig, ofdm_decide, ofdm_mod, \
    mmse_equalize
from orion_sdr_tpu_torch.otfs import isfft, sfft, otfs_mod, otfs_demod, \
    otfs_num_symbols

torch.set_num_threads(1)

FS = 1e6
CPU = "cpu"


def cfgs(order="qpsk", n_fft=64, cp=16, pilots=(), **kw):
    j = JaxCfg(JaxPlan(n_fft, cp).with_pilot_carriers(pilots)
               .with_contiguous_data(), FS, constellation=order, **kw)
    p = OfdmConfig(CarrierPlan(n_fft, cp).with_pilot_carriers(pilots)
                   .with_contiguous_data(), FS, constellation=order, **kw)
    return j, p


def close(ours, ref, tol=1e-5):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1.0))


def test_isfft_sfft_match_and_invert():
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((3, 8, 24))
         + 1j * rng.standard_normal((3, 8, 24))).astype(np.complex64)
    tf = isfft(torch.as_tensor(z))
    close(tf, j_isfft(z))
    close(sfft(tf), j_sfft(np.asarray(j_isfft(z))))
    np.testing.assert_allclose(sfft(tf).numpy(), z, atol=1e-5)


@pytest.mark.parametrize("order", ["bpsk", "qpsk", "qam16"])
def test_roundtrip_matches(order):
    rng = np.random.default_rng(1)
    jc, pc = cfgs(order)
    n_dopp = 8
    bits = rng.integers(0, 2, pc.bits_per_ofdm_symbol() * 2 * n_dopp - 5
                        ).astype(np.uint8)
    assert otfs_num_symbols(pc, len(bits), n_dopp) == \
        j_num_symbols(jc, len(bits), n_dopp) == 2 * n_dopp
    iq, _ = otfs_mod(pc, bits, n_dopp, device=CPU)
    close(iq, j_otfs_mod(jc, bits, n_dopp)[0])
    dd, _ = otfs_demod(pc, iq, n_dopp)
    close(dd, j_otfs_demod(jc, iq.numpy(), n_dopp)[0])
    out = ofdm_decide(pc, dd).numpy()
    assert np.array_equal(out[:len(bits)], bits)
    assert np.array_equal(out, np.asarray(j_decide(jc, np.asarray(
        j_otfs_demod(jc, iq.numpy(), n_dopp)[0]))))


def test_rf_carrier_and_static_multipath():
    rng = np.random.default_rng(2)
    jc, pc = cfgs("qpsk", rf_hz=5000.0)
    n_dopp = 4
    bits = rng.integers(0, 2, pc.bits_per_ofdm_symbol() * n_dopp
                        ).astype(np.uint8)
    iq, phase = otfs_mod(pc, bits, n_dopp, phase0=0.3, device=CPU)
    j_iq, j_phase = j_otfs_mod(jc, bits, n_dopp, phase0=0.3)
    close(iq, j_iq)
    assert abs(phase - float(j_phase)) < 1e-5
    chan = np.array([1.0, 0.3 * np.exp(1j * 0.5)], np.complex64)
    rx = np.convolve(iq.numpy(), chan)[:iq.shape[0]].astype(np.complex64)
    est = np.fft.fft(chan, 64).astype(np.complex64)
    dd, _ = otfs_demod(pc, rx, n_dopp, estimate=est, device=CPU)
    close(dd, j_otfs_demod(jc, rx, n_dopp, estimate=est)[0])
    assert np.array_equal(ofdm_decide(pc, dd).numpy(), bits)


def test_pilot_interp_per_symbol_estimate():
    """The pilot_interp branch: each symbol's channel from the plan's
    pilots, under a channel that changes from symbol to symbol."""
    rng = np.random.default_rng(5)
    pilots = tuple((k, 1 + 0j) for k in (-24, -12, 0, 12, 24))
    jc, pc = cfgs("qpsk", pilots=pilots,
                  equalizer_method="pilot_interp")
    n_dopp = 8
    bits = rng.integers(0, 2, pc.bits_per_ofdm_symbol() * n_dopp
                        ).astype(np.uint8)
    iq = otfs_mod(pc, bits, n_dopp, device=CPU)[0].numpy()
    g = np.repeat(np.exp(1j * 0.2 * np.arange(n_dopp)), 80)
    rx = (iq * g).astype(np.complex64)
    for nv in (0.0, 0.05):
        dd, _ = otfs_demod(pc, rx, n_dopp, noise_var=nv, device=CPU)
        close(dd, j_otfs_demod(jc, rx, n_dopp, noise_var=nv)[0])
        assert np.array_equal(ofdm_decide(pc, dd).numpy(), bits)


def _noise(rng, n, sigma):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * sigma).astype(np.complex64)


def test_frequency_diversity_vs_ofdm_matches():
    """tests/test_otfs.py's notch channel: both packages give the same
    bits (hence the same BER) for OFDM + MMSE and for OTFS + LMMSE, and
    OTFS beats OFDM as there."""
    rng = np.random.default_rng(3)
    jc, pc = cfgs("qpsk")
    n_dopp = 16
    bits = rng.integers(0, 2, pc.bits_per_ofdm_symbol() * n_dopp
                        ).astype(np.uint8)
    chan = np.array([1.0, -0.98], np.complex64)
    est = np.fft.fft(chan, 64).astype(np.complex64)
    sigma = 0.02
    nv = 64 * 2 * sigma ** 2

    def through(iq):
        rx = np.convolve(iq, chan)[:len(iq)]
        return (rx + _noise(rng, len(rx), sigma)).astype(np.complex64)

    rx = through(np.asarray(j_ofdm_mod(jc, bits)[0]))
    g = pc.grid()
    ours = grid_extract(g, mmse_equalize(symbol_fft(
        torch.as_tensor(rx), 64, 16, n_symbols=n_dopp),
        torch.as_tensor(est), nv))
    jg = jc.grid()
    ref = j_grid_extract(jg, j_mmse(j_symbol_fft(rx, 64, 16,
                                                 n_symbols=n_dopp), est, nv))
    close(ours, ref)
    ofdm_bits = ofdm_decide(pc, ours).numpy()
    assert np.array_equal(ofdm_bits, np.asarray(j_decide(jc, ref)))
    rx = through(otfs_mod(pc, bits, n_dopp, device=CPU)[0].numpy())
    dd, _ = otfs_demod(pc, rx, n_dopp, estimate=est, noise_var=nv,
                       device=CPU)
    j_dd = j_otfs_demod(jc, rx, n_dopp, estimate=est, noise_var=nv)[0]
    close(dd, j_dd)
    otfs_bits = ofdm_decide(pc, dd).numpy()
    assert np.array_equal(otfs_bits, np.asarray(j_decide(jc, j_dd)))
    ber_ofdm = float(np.mean(ofdm_bits != bits))
    ber_otfs = float(np.mean(otfs_bits != bits))
    assert ber_ofdm > 0.01 and ber_otfs < 0.3 * ber_ofdm


def test_time_diversity_per_symbol_estimate_matches():
    """tests/test_otfs.py's time-selective fade with a per-symbol (n_sym,
    n_fft) estimate under LMMSE."""
    rng = np.random.default_rng(4)
    jc, pc = cfgs("qpsk")
    n_dopp, sps = 16, 80
    bits = rng.integers(0, 2, pc.bits_per_ofdm_symbol() * n_dopp
                        ).astype(np.uint8)
    gains = np.ones(n_dopp, np.float32)
    gains[[5, 11]] = 0.03
    sigma = 0.02
    nv = 64 * 2 * sigma ** 2
    est = np.repeat(gains[:, None], 64, axis=1).astype(np.complex64)
    iq = otfs_mod(pc, bits, n_dopp, device=CPU)[0].numpy()
    rx = (iq[:n_dopp * sps] * np.repeat(gains, sps)
          + _noise(rng, n_dopp * sps, sigma)).astype(np.complex64)
    dd, _ = otfs_demod(pc, rx, n_dopp, estimate=est, noise_var=nv,
                       device=CPU)
    j_dd = j_otfs_demod(jc, rx, n_dopp, estimate=est, noise_var=nv)[0]
    close(dd, j_dd)
    assert np.array_equal(ofdm_decide(pc, dd).numpy(),
                          np.asarray(j_decide(jc, j_dd)))
