"""Torch port, the channel simulator (channel.py) against the JAX package
on the CPU, with the same numpy inputs and the same ``np.random.Generator``
seeds.

Tolerances: ``fading_taps`` bit-equal (host numpy in both); every
impairment's output within 1e-5 of the output's peak magnitude (float32
rotations, products and interpolations; measured ≤ 1.5e-6 relative); the
validation errors of tests/test_channel.py:80,138,157 raised alike."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as J

import orion_sdr_tpu_torch as P

torch.set_num_threads(1)
CPU = "cpu"
FS = 8000.0
TOL = 1e-5


def _tone(n=20000, f=500.0, fs=FS):
    t = np.arange(n) / fs
    return np.exp(2j * np.pi * f * t).astype(np.complex64)


def _batch(n=6000, seed=0):
    """(2, 3, n) noisy tones: batched leading dimensions."""
    rng = np.random.default_rng(seed)
    x = np.stack([_tone(n, f) for f in (300.0, 450.0, 700.0, -650.0,
                                         1200.0, 25.0)]).reshape(2, 3, n)
    return (x + 0.1 * J.awgn(rng, x.shape, 1.0)).astype(np.complex64)


def close(got, ref):
    ref = np.asarray(ref)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.complex64
    got = got.numpy()
    assert got.shape == ref.shape
    if ref.size:
        assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("cfo,phase0", [(37.5, 0.0), (-1234.5, 0.3),
                                        (0.01, 2.1)])
def test_cfo_apply_matches(cfo, phase0):
    x = _batch()
    close(P.cfo_apply(x, cfo, FS, phase0, device=CPU),
          J.cfo_apply(x, cfo, FS, phase0))


@pytest.mark.parametrize("lw", [0.0, 2.0, 150.0])
def test_phase_noise_apply_same_draws(lw):
    x = _batch()
    ref = J.phase_noise_apply(np.random.default_rng(3), x, lw, FS)
    close(P.phase_noise_apply(np.random.default_rng(3), x, lw, FS,
                              device=CPU), ref)
    # the same number of draws: the generators stay in step
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    J.phase_noise_apply(r1, x, lw, FS)
    P.phase_noise_apply(r2, x, lw, FS, device=CPU)
    assert r1.standard_normal() == r2.standard_normal()


@pytest.mark.parametrize("amp,ph", [(0.0, 0.0), (1.0, 5.0), (-0.5, -12.0)])
def test_iq_imbalance_matches(amp, ph):
    x = _batch()
    close(P.iq_imbalance_apply(x, amp, ph, device=CPU),
          J.iq_imbalance_apply(x, amp, ph))


@pytest.mark.parametrize("delays,gains,norm", [
    ([0, 7], [1.0, 0.5j], False),
    ([0, 11, 23], [1.0, 0.6, 0.3j], True),
    ([3], [0.2 - 0.7j], True),
    ([0, 4], [1.0, 0.35 * np.exp(0.7j)], True),
])
def test_multipath_matches(delays, gains, norm):
    x = _batch()
    close(P.multipath_apply(x, delays, gains, norm, device=CPU),
          J.multipath_apply(x, delays, gains, norm))


@pytest.mark.parametrize("kw", [
    dict(n_out=8192, rate_hz=100.0, doppler_hz=2.0, spectrum="jakes",
         n_paths=2),
    dict(n_out=300, rate_hz=64.0, doppler_hz=1.0, spectrum="gaussian",
         n_paths=4),
    dict(n_out=4096, rate_hz=100.0, doppler_hz=2.0, spectrum="jakes",
         rice_k_db=20.0),
    dict(n_out=0, rate_hz=10.0, doppler_hz=1.0),
])
def test_fading_taps_bit_equal(kw):
    ref = J.fading_taps(np.random.default_rng(7), **kw)
    got = P.fading_taps(np.random.default_rng(7), **kw)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_fading_apply_matches():
    x = _batch()
    taps = J.fading_taps(np.random.default_rng(9), 64, 16.0, 2.0,
                         n_paths=3)
    for gains, norm in ((None, True), ([0.0, -3.0, -9.0], True),
                        ([1.0, 2.0, 3.0], False)):
        close(P.fading_apply(x, FS, taps, 16.0, [0, 7, 40], gains, norm,
                             device=CPU),
              J.fading_apply(x, FS, taps, 16.0, [0, 7, 40], gains, norm))
    ramp = np.linspace(1.0, 2.0, 80).astype(np.complex64)   # 1-D taps
    close(P.fading_apply(x, FS, ramp, 100.0, [0], normalize=False,
                         device=CPU),
          J.fading_apply(x, FS, ramp, 100.0, [0], normalize=False))


@pytest.mark.parametrize("delay,spread", [(1e-3, 0.5), (2e-3, 1.0)])
def test_watterson_same_draws(delay, spread):
    x = _batch()
    close(P.watterson_apply(np.random.default_rng(21), x, FS, delay, spread,
                            device=CPU),
          J.watterson_apply(np.random.default_rng(21), x, FS, delay, spread))
    empty = np.zeros(0, np.complex64)
    assert P.watterson_apply(np.random.default_rng(0), empty, FS,
                             device=CPU).numel() == 0


def test_validation_errors_alike():
    x = _tone(100)
    rng = np.random.default_rng(0)
    cases = [
        lambda m, **k: m.multipath_apply(x, [0, 5], [1.0], **k),
        lambda m, **k: m.multipath_apply(x, [-1], [1.0], **k),
        lambda m, **k: m.fading_taps(rng, 100, 10.0, 0.0),
        lambda m, **k: m.fading_taps(rng, 100, 10.0, 1.0, "unknown"),
        lambda m, **k: m.fading_apply(_tone(8000), FS,
                                      np.ones((1, 4), np.complex64), 16.0,
                                      [0], **k),
        lambda m, **k: m.fading_apply(x, FS, np.ones((2, 64), np.complex64),
                                      16.0, [0], **k),
        lambda m, **k: m.fading_apply(x, FS, np.ones((1, 64), np.complex64),
                                      16.0, [0], [0.0, 1.0], **k),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case(J)
        with pytest.raises(ValueError):
            case(P, device=CPU)
