"""Torch port, FT8/FT4 CPFSK modulators and tone demodulators against the
JAX package, on full frames (151 680 / 60 480 samples). Tolerances:
``cpfsk_mod`` (``ft8_mod``/``ft4_mod``) 1e-4 absolute on the IQ — the port
rounds each sample phase to float32 once, as XLA's fused multiply-add does,
so the two agree to the last bits of cos/sin; ``cpfsk_mod_batch``
(``ft8_mod_batch``/``ft4_mod_batch``) 2e-3 absolute, the batch recipe's own
tolerance against the scalar one (its float32 phase carries one rounding
more than XLA's at up to ~1000 rad, 1.2e-4 rad an ulp); tone decisions
exact."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.demodulate import ft8 as JD
from orion_sdr_tpu.modulate import ft8 as JM

from orion_sdr_tpu_torch.demodulate import ft8 as TD
from orion_sdr_tpu_torch.modulate import ft8 as TM

torch.set_num_threads(1)
CPU = "cpu"
FS = 12000.0


def test_constants_and_sequences_equal():
    for name in ("FT8_TONE_SPACING_HZ", "FT8_SAMPLES_PER_SYM",
                 "FT8_TOTAL_SYMS", "FT8_FRAME_LEN", "FT8_SYNC_POS",
                 "FT4_TONE_SPACING_HZ", "FT4_SAMPLES_PER_SYM",
                 "FT4_TOTAL_SYMS", "FT4_FRAME_LEN", "FT4_SYNC_POS"):
        assert getattr(TM, name) == getattr(JM, name), name
    assert np.array_equal(TM.FT8_COSTAS, JM.FT8_COSTAS)
    assert np.array_equal(TM.FT4_COSTAS, JM.FT4_COSTAS)
    rng = np.random.default_rng(0)
    t8 = rng.integers(0, 8, 58).astype(np.uint8)
    t4 = rng.integers(0, 4, 87).astype(np.uint8)
    assert np.array_equal(TM.ft8_symbol_sequence(t8),
                          JM.ft8_symbol_sequence(t8))
    assert np.array_equal(TM.ft4_symbol_sequence(t4),
                          JM.ft4_symbol_sequence(t4))
    assert np.array_equal(TM.ft8_data_positions(), JM.ft8_data_positions())
    assert np.array_equal(TM.ft4_data_positions(), JM.ft4_data_positions())


@pytest.mark.parametrize("base,rf,gain", [(1000.0, 0.0, 1.0),
                                          (1012.5, 150.0, 0.5)])
def test_ft8_mod_matches(base, rf, gain):
    t = np.random.default_rng(1).integers(0, 8, 58).astype(np.uint8)
    ours = TM.ft8_mod(t, FS, base, rf_hz=rf, gain=gain, device=CPU)
    assert ours.dtype == torch.complex64 and ours.shape == (151_680,)
    ref = np.asarray(JM.ft8_mod(t, FS, base, rf_hz=rf, gain=gain))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)


def test_ft4_mod_and_cpfsk_mod_match():
    t = np.random.default_rng(2).integers(0, 4, 87).astype(np.uint8)
    ours = TM.ft4_mod(t, FS, 1012.5, device=CPU)
    ref = np.asarray(JM.ft4_mod(t, FS, 1012.5))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)
    syms = np.arange(20) % 5
    ours = TM.cpfsk_mod(torch.as_tensor(syms), 100, 8000.0, 300.0, 50.0)
    ref = np.asarray(JM.cpfsk_mod(tuple(int(s) for s in syms), 100, 8000.0,
                                  300.0, 50.0))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)


def test_mod_batch_matches():
    rng = np.random.default_rng(3)
    t8 = rng.integers(0, 8, (3, 58)).astype(np.uint8)
    t4 = rng.integers(0, 4, (2, 87)).astype(np.uint8)
    for ours, ref in (
            (TM.ft8_mod_batch(t8, base_hz=1012.5, device=CPU),
             JM.ft8_mod_batch(t8, base_hz=1012.5)),
            (TM.ft4_mod_batch(t4, gain=0.7, device=CPU),
             JM.ft4_mod_batch(t4, gain=0.7))):
        assert ours.dtype == torch.complex64
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=2e-3)
    # the batch recipe against the port's own scalar one
    np.testing.assert_allclose(
        TM.ft8_mod_batch(t8, device=CPU)[1].numpy(),
        TM.ft8_mod(t8[1], device=CPU).numpy(), rtol=0, atol=2e-3)
    syms = torch.as_tensor(rng.integers(0, 8, (2, 79)))
    np.testing.assert_allclose(
        TM.cpfsk_mod_batch(syms, 1920, FS, 950.0, 6.25).numpy(),
        np.asarray(JM.cpfsk_mod_batch(syms.numpy(), 1920, FS, 950.0, 6.25)),
        rtol=0, atol=2e-3)


def test_demod_tones_equal_and_exact():
    rng = np.random.default_rng(4)
    t8 = rng.integers(0, 8, (2, 58)).astype(np.uint8)
    iq = np.asarray(JM.ft8_mod_batch(t8))
    got = TD.ft8_demod(iq, device=CPU)
    assert got.dtype == np.uint8 and got.shape == (2, 58)
    assert np.array_equal(got, JD.ft8_demod(iq))
    assert np.array_equal(got, t8)
    # a frame the port modulated, the JAX demod, and back
    ours = TM.ft8_mod(t8[0], device=CPU).numpy()
    assert np.array_equal(JD.ft8_demod(ours), t8[0])
    t4 = rng.integers(0, 4, 87).astype(np.uint8)
    iq4 = TM.ft4_mod(t4, FS, 1000.0, device=CPU)
    assert np.array_equal(TD.ft4_demod(iq4, device=CPU), t4)
    assert np.array_equal(TD.ft4_demod(iq4, device=CPU),
                          JD.ft4_demod(iq4.numpy()))
    assert TD.ft8_demod(np.zeros(100, np.complex64), device=CPU) is None
    assert TD.ft4_demod(np.zeros(100, np.complex64), device=CPU) is None
