"""Torch port: constellation mapping, soft LLRs, OFDM modulation, soft demap,
rotation, channel-estimate denoising and S&C acquisition against the JAX
package on the same numpy inputs.

Tolerances: Gray mapping is exact arithmetic, so bit-exact. Everything that
passes through an FFT, a transcendental or a mean differs by float32
summation order and library rounding between XLA and torch: IQ within 1e-5
absolute (unit-power samples), LLRs within 1e-5 (symbol domain) or 1e-4
(through the FFT), sync within one sample (none here) and 0.5 Hz.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.constellation import map_bits as jax_map_bits, \
    soft_llr as jax_soft_llr
from orion_sdr_tpu.dsp.osc import rotate as jax_rotate
from orion_sdr_tpu.frame.demodulator import soft_demap as jax_soft_demap
from orion_sdr_tpu.multicarrier import CarrierPlan as JaxPlan
from orion_sdr_tpu.ofdm import OfdmConfig as JaxOfdmConfig, \
    ofdm_mod as jax_ofdm_mod, \
    channel_estimate_denoise as jax_channel_estimate_denoise
from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble as JaxPreamble, \
    ofdm_sync as jax_ofdm_sync, generate_ofdm_preamble as jax_preamble_iq

from orion_sdr_tpu_torch.constellation import map_bits, soft_llr, \
    BITS_PER_SYMBOL
from orion_sdr_tpu_torch.dsp.osc import rotate
from orion_sdr_tpu_torch.frame.demodulator import soft_demap
from orion_sdr_tpu_torch.multicarrier import CarrierPlan
from orion_sdr_tpu_torch.ofdm import OfdmConfig, ofdm_mod, \
    channel_estimate_denoise
from orion_sdr_tpu_torch.sync.ofdm_sync import OfdmPreamble, ofdm_sync

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

ORDERS = sorted(BITS_PER_SYMBOL)
FS = 1e6


def _cfgs(roll_off=0, pilots=(), **kw):
    jc = JaxOfdmConfig(JaxPlan(256, 64).with_pilot_carriers(pilots)
                       .with_contiguous_data(edge_guard=16),
                       fs=FS, **kw).with_symbol_window(roll_off)
    pc = OfdmConfig(CarrierPlan(256, 64).with_pilot_carriers(pilots)
                    .with_contiguous_data(edge_guard=16),
                    fs=FS, **kw).with_symbol_window(roll_off)
    return jc, pc


@pytest.mark.parametrize("order", ORDERS)
def test_map_bits_bit_exact(order):
    bits = np.random.default_rng(0).integers(
        0, 2, (3, 60 * BITS_PER_SYMBOL[order])).astype(np.uint8)
    ours = map_bits(torch.as_tensor(bits), order)
    assert ours.dtype == torch.complex64
    assert np.array_equal(ours.numpy(), np.asarray(jax_map_bits(bits, order)))


@pytest.mark.parametrize("order", ORDERS)
def test_soft_llr_matches(order):
    rng = np.random.default_rng(1)
    z = (rng.standard_normal((2, 300)) + 1j * rng.standard_normal((2, 300))
         ).astype(np.complex64) * 0.8
    ours = soft_llr(torch.as_tensor(z), order).numpy()
    ref = np.asarray(jax_soft_llr(z, order))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("order,roll_off,pilots", [
    ("bpsk", 0, ()), ("qpsk", 8, ((-40, 1 + 0j), (40, -1 + 0j))),
    ("qam16", 0, ()), ("qam64", 16, ((7, 0.7 + 0.7j),))])
def test_ofdm_mod_matches(order, roll_off, pilots):
    jc, pc = _cfgs(roll_off, pilots, constellation=order)
    bits = np.random.default_rng(2).integers(
        0, 2, 5 * pc.bits_per_ofdm_symbol() - 7).astype(np.uint8)
    ref, _ = jax_ofdm_mod(jc, bits)
    ours, _ = ofdm_mod(pc, torch.as_tensor(bits))
    assert ours.dtype == torch.complex64
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("order", ORDERS)
def test_soft_demap_matches(order):
    jc, pc = _cfgs(constellation=order)
    rng = np.random.default_rng(3)
    n_sym = 3
    bits = rng.integers(0, 2, (2, n_sym * pc.bits_per_ofdm_symbol())
                        ).astype(np.uint8)
    iq = np.asarray(jax_ofdm_mod(jc, bits)[0])
    iq = iq + 0.01 * (rng.standard_normal(iq.shape)
                      + 1j * rng.standard_normal(iq.shape)).astype(np.complex64)
    iq = iq.astype(np.complex64)
    est = (1 + 0.3 * rng.standard_normal(256)
           + 0.3j * rng.standard_normal(256)).astype(np.complex64)
    for e in (None, est):
        ref = np.asarray(jax_soft_demap(jc, order, iq, n_sym, e))
        ours = soft_demap(pc, order, torch.as_tensor(iq), n_sym,
                          None if e is None else torch.as_tensor(e)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    assert soft_demap(pc, order, torch.as_tensor(iq[:, :100]), n_sym) is None


def test_rotate_and_denoise_match():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)
         ).astype(np.complex64)
    ref, ref_phase = jax_rotate(x, 37.0, FS, 0.25)
    ours, phase = rotate(torch.as_tensor(x), 37.0, FS, 0.25)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert abs(phase - float(ref_phase)) < 1e-6
    h = (rng.standard_normal(256) + 1j * rng.standard_normal(256)
         ).astype(np.complex64)
    np.testing.assert_allclose(
        channel_estimate_denoise(torch.as_tensor(h), 64, 8).numpy(),
        jax_channel_estimate_denoise(h, 64, 8), rtol=0, atol=1e-5)


def test_ofdm_sync_matches():
    rng = np.random.default_rng(5)
    jpre = JaxPreamble(4, 128).with_training_symbol(256, 64)
    ppre = OfdmPreamble(4, 128).with_training_symbol(256, 64)
    jc, _ = _cfgs(constellation="qpsk")
    body = np.asarray(jax_ofdm_mod(jc, rng.integers(0, 2, 4 * 444))[0])
    frame = np.concatenate([jax_preamble_iq(jpre), body])
    buf = np.concatenate([np.zeros(1234, np.complex64), frame,
                          np.zeros(500, np.complex64)])
    buf = np.asarray(jax_rotate(buf, 37.0, FS)[0])
    buf = (buf + 0.05 * (rng.standard_normal(len(buf))
                         + 1j * rng.standard_normal(len(buf)))
           ).astype(np.complex64)
    ref = jax_ofdm_sync(buf, FS, jpre)
    ours = ofdm_sync(torch.as_tensor(buf), FS, ppre)
    assert ours[0].start_sample == ref[0].start_sample == 1234
    assert ours[0].integer_cfo_bins == ref[0].integer_cfo_bins == 0
    assert abs(ours[0].cfo_hz - ref[0].cfo_hz) < 0.5
    assert abs(ours[0].cfo_hz - 37.0) < 5.0
    assert abs(ours[0].score - ref[0].score) < 1e-3
