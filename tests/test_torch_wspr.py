"""Torch port, WSPR (codec/wspr.py, fec/sequential.py, modulate/wspr.py,
demodulate/wspr.py) against the JAX package on the CPU, with the same
numpy inputs.

Tolerances: exact for packed bits, coded bits, stack decodes, channel
symbols and decoded messages. The beacon IQ within 0.25 absolute: its
phase is a cumulative sum over 1.33 M samples, which the port forms in
float64 and rounds once and XLA sums as a float32 tree (measured 0.19 rad
apart at the end of a beacon). The energy grid within 2e-5 of its largest
value (the port's one complex64 matmul sums the 1024 block products in
another order than XLA's einsum; measured at most 4e-6)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.codec import wspr as JC
from orion_sdr_tpu.demodulate import wspr as JD
from orion_sdr_tpu.fec import sequential as JS
from orion_sdr_tpu.modulate import wspr as JM

from orion_sdr_tpu_torch.codec import wspr as PC
from orion_sdr_tpu_torch.demodulate import wspr as PD
from orion_sdr_tpu_torch.fec import sequential as PS
from orion_sdr_tpu_torch.modulate import wspr as PM

torch.set_num_threads(1)
CPU = "cpu"
MESSAGES = [("K1ABC", "FN42", 30), ("W1AW", "FN31", 37),
            ("DL2XYZ", "JO62", 23), ("G4JNT", "IO90", 0)]
IQ_ATOL = 0.25
GRID_RTOL = 2e-5


@pytest.mark.parametrize("call,grid,dbm", MESSAGES)
def test_pack_unpack_and_symbols_match(call, grid, dbm):
    bits = PC.wspr_pack(call, grid, dbm)
    assert np.array_equal(bits, JC.wspr_pack(call, grid, dbm))
    assert PC.wspr_unpack(bits) == PC.WsprMessage(*vars(
        JC.wspr_unpack(bits)).values())
    assert np.array_equal(PC.wspr_symbols(call, grid, dbm),
                          JC.wspr_symbols(call, grid, dbm))


def test_stack_decode_matches_on_noisy_llrs():
    for seed in range(4):
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, 50).astype(np.uint8)
        coded = PS.conv_encode_long(bits)
        assert np.array_equal(coded, JS.conv_encode_long(bits))
        llr = ((1.0 - 2.0 * coded) * 2.0 + rng.standard_normal(len(coded))
               * 1.6).astype(np.float32)
        got = PS.stack_decode(llr, 50)
        want = JS.stack_decode(llr, 50)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got, want)
    assert PS.stack_decode(np.zeros(10, np.float32), 50) is None


def test_decode_symbols_matches():
    rng = np.random.default_rng(7)
    syms = PC.wspr_symbols("K1ABC", "FN42", 30)
    e = rng.exponential(1.0, (162, 4)).astype(np.float32)
    e[np.arange(162), syms] += 3.0
    got, want = PC.wspr_decode_symbols(e), JC.wspr_decode_symbols(e)
    assert vars(got) == vars(want) == {"callsign": "K1ABC", "grid": "FN42",
                                       "dbm": 30}


def test_wspr_mod_matches():
    ref = np.asarray(JM.wspr_mod("K1ABC", "FN42", 30, base_hz=1450.0))
    got = PM.wspr_mod("K1ABC", "FN42", 30, base_hz=1450.0,
                      device=CPU).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert float(np.abs(got - ref).max()) <= IQ_ATOL
    # over the first symbol (phase up to 6e3 rad) a few float32 ulps apart
    assert float(np.abs(got[:8192] - ref[:8192]).max()) < 5e-3
    with pytest.raises(ValueError):
        PM.wspr_mod("K1ABC", "FN42", 30, fs=8000.0, device=CPU)


def _capture(seed, snr_db=None):
    iq = np.asarray(JM.wspr_mod("K1ABC", "FN42", 30))
    z = np.concatenate([np.zeros(5000, np.complex64), iq,
                        np.zeros(8000, np.complex64)])
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        var = 12_000.0 / (10 ** (snr_db / 10) * 2500.0)
        z = z + (rng.standard_normal(len(z)) + 1j * rng.standard_normal(
            len(z))).astype(np.complex64) * np.sqrt(var / 2)
    return z.astype(np.complex64)


def test_energy_grid_and_demod_match():
    z = _capture(3, snr_db=-24.0)
    dts = tuple(int(d) for d in np.arange(-4, 5, 2) * 1024)
    dfs = np.linspace(-2.0, 2.0, 5).astype(np.float32)
    ref = np.asarray(JD._energy_grid(np.ascontiguousarray(z.real),
                                     np.ascontiguousarray(z.imag), dts, dfs,
                                     12_000.0, 1500.0))
    got = PD._energy_grid(torch.as_tensor(z), dts, dfs, 12_000.0,
                          1500.0).numpy()
    assert got.shape == ref.shape == (5, 5, 162, 4)
    scale = float(ref.max())
    assert float(np.abs(got - ref).max()) <= GRID_RTOL * scale
    m_ref, m = JD.wspr_demod(z), PD.wspr_demod(z, device=CPU)
    assert m is not None and vars(m) == vars(m_ref) == {
        "callsign": "K1ABC", "grid": "FN42", "dbm": 30}


def test_band_decode_three_beacons_matches():
    """tests/test_wspr.py::test_band_decode_three_beacons in both
    packages: the same three messages."""
    rng = np.random.default_rng(0)
    b1 = np.asarray(JM.wspr_mod("K1ABC", "FN42", 30, base_hz=1420.0))
    b2 = np.asarray(JM.wspr_mod("W1AW", "FN31", 37, base_hz=1500.0)) * 0.5
    b3 = np.asarray(JM.wspr_mod("DL2XYZ", "JO62", 23,
                                base_hz=1570.0)) * 0.25
    n = len(b1) + 30000
    band = np.zeros(n, np.complex64)
    band[:len(b1)] += b1
    band[8000:8000 + len(b2)] += b2
    band[20000:20000 + len(b3)] += b3
    band += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64) * 0.05
    want = [vars(m) for m in JD.wspr_decode_band(band)]
    got = [vars(m) for m in PD.wspr_decode_band(band, device=CPU)]
    assert got == want
    assert {m["callsign"] for m in got} == {"K1ABC", "W1AW", "DL2XYZ"}
    spec_ref = np.asarray(JD._spectrogram(np.ascontiguousarray(band.real),
                                          np.ascontiguousarray(band.imag),
                                          640, 2048))
    spec = PD._spectrogram(torch.as_tensor(band), 640, 2048).numpy()
    assert float(np.abs(spec - spec_ref).max()) <= 1e-5 * float(
        spec_ref.max())
    assert PD.wspr_decode_band(np.zeros(162 * 8192 + 40000, np.complex64),
                               device=CPU) == []
