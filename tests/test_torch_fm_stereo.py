"""Torch port, FM broadcast stereo + RDS (codec/rds.py, modulate/
fm_stereo.py, demodulate/fm_stereo.py) against the JAX package on the CPU,
with the same numpy inputs.

Tolerances: exact for RDS blocks, groups, bit streams and decoded station
data. 1e-5 of the largest magnitude for the Manchester baseband, the MPX
and the receiver's mono, difference, pilot and RDS baseband (exact
``atan2`` and the FIR bank's FFTs round apart from XLA's; measured at most
6e-7), and for left/right audio; the FM IQ within 5e-4 absolute (its phase
is a cumulative sum: torch's CPU sum runs in float64, XLA's in float32,
measured 4.2e-5 at 2^16 samples)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from test_torch_dsp_iir import close

from orion_sdr_tpu.codec import rds as JR
from orion_sdr_tpu.demodulate import fm_stereo as JD
from orion_sdr_tpu.modulate import fm_stereo as JM

from orion_sdr_tpu_torch.codec import rds as PR
from orion_sdr_tpu_torch.demodulate import fm_stereo as PD
from orion_sdr_tpu_torch.modulate import fm_stereo as PM

torch.set_num_threads(1)
CPU = "cpu"
FS = 240_000.0
IQ_ATOL = 5e-4


def _lr(n, fs=FS):
    t = np.arange(n) / fs
    return ((0.8 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32),
            (0.8 * np.sin(2 * np.pi * 2500 * t)).astype(np.float32))


def _groups(ps="ORIONFM ", rt="TPU NATIVE SDR"):
    return JR.rds_groups_0a(0x52A1, pty=9, tp=True, ps_name=ps) \
        + JR.rds_groups_2a(0x52A1, pty=9, radiotext=rt)


def _same_rds(got, want):
    assert (got.pi, got.pty, got.tp, got.ps_name, got.radiotext,
            got.groups) == (want.pi, want.pty, want.tp, want.ps_name,
                            want.radiotext, want.groups)


def test_rds_block_and_group_codec_match():
    for name in PR.RDS_OFFSETS:
        blk = PR.rds_block_encode(0xCAFE, name)
        assert np.array_equal(blk, JR.rds_block_encode(0xCAFE, name))
        assert PR.rds_block_classify(blk) == JR.rds_block_classify(blk)
    blk = PR.rds_block_encode(0xCAFE, "B")
    blk[7] ^= 1
    assert PR.rds_block_classify(blk) == JR.rds_block_classify(blk)
    assert PR._classify_expected(blk, ("B",)) == \
        JR._classify_expected(blk, ("B",)) == ("B", 0xCAFE)
    rt = "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789"
    groups = PR.rds_groups_0a(0x1001, ps_name="TESTFM  ") \
        + PR.rds_groups_2a(0x1001, radiotext=rt)
    assert groups == JR.rds_groups_0a(0x1001, ps_name="TESTFM  ") \
        + JR.rds_groups_2a(0x1001, radiotext=rt)
    bits = PR.rds_encode_groups(groups)
    assert np.array_equal(bits, JR.rds_encode_groups(groups))
    rng = np.random.default_rng(0)
    stream = np.concatenate([rng.integers(0, 2, 37).astype(np.uint8),
                             np.tile(bits, 2)])
    stream[37 + 104 + 40] ^= 1                  # one bit in a synced group
    got, want = PR.rds_decode_bits(stream), JR.rds_decode_bits(stream)
    _same_rds(got, want)
    assert got.ps_name == "TESTFM  " and got.radiotext == rt


def test_rds_manchester_and_mpx_match():
    n = 1 << 15
    bits = np.array([1, 0, 0, 0] * 9, np.uint8)      # odd parity: seams
    ref = np.asarray(JM.rds_manchester(bits, FS, n, 0.05))
    got = PM.rds_manchester(bits, FS, n, 0.05, device=CPU)
    close(ref, got)
    left, right = _lr(n)
    close(JM.stereo_mpx(left, right, FS, rds=ref),
          PM.stereo_mpx(left, right, FS, rds=got, device=CPU))
    close(JM.stereo_mpx(left, right, FS, pilot_phase0=0.3),
          PM.stereo_mpx(left, right, FS, pilot_phase0=0.3, device=CPU))
    assert PM.rds_manchester([], FS, 16, device=CPU).shape == (16,)


def test_fm_stereo_mod_and_receive_chain_match():
    n = 1 << 16
    left, right = _lr(n)
    bits = JR.rds_encode_groups(_groups())
    ref, _ = JM.fm_stereo_mod(left, right, FS, rds_bits=bits)
    ref = np.asarray(ref)
    got, _ = PM.fm_stereo_mod(left, right, FS, rds_bits=bits, device=CPU)
    assert float(np.abs(got.numpy() - ref).max()) <= IQ_ATOL
    args = (FS, 75e3, 15e3, 0.9, True)
    want = JD._stereo_device(np.ascontiguousarray(ref.real),
                             np.ascontiguousarray(ref.imag), *args)
    have = PD._stereo_device(torch.as_tensor(ref.real.copy()),
                             torch.as_tensor(ref.imag.copy()), *args)
    for w, h in zip(want, have):
        close(w, h)
    with pytest.raises(ValueError):
        PM.fm_stereo_mod(left[:64], right[:64], 48_000.0, device=CPU)
    with pytest.raises(ValueError):
        PD.fm_stereo_demod(ref[:64], 48_000.0, device=CPU)


def test_stereo_separation_matches():
    """tests/test_fm_broadcast.py::test_stereo_separation_clean in both
    packages: L/R within tolerance, pilot 0.09, separation > 40 dB."""
    n = 1 << 17
    left, right = _lr(n)
    iq = np.asarray(JM.fm_stereo_mod(left, right, FS)[0])
    want = JD.fm_stereo_demod(iq, FS)
    got = PD.fm_stereo_demod(iq, FS, device=CPU)
    for name in ("left", "right", "mono"):
        close(getattr(want, name), getattr(got, name))
    assert got.pilot_level == pytest.approx(want.pilot_level, rel=1e-5)
    seg = slice(20_000, -20_000)
    k = np.arange(n)[seg]
    amp = {f: [2 * abs(np.mean(x.numpy()[seg] * np.exp(
        -2j * np.pi * f * k / FS))) for x in (got.left, got.right)]
        for f in (1000, 2500)}
    assert 20 * np.log10(amp[1000][0] / amp[1000][1]) > 40.0
    assert 20 * np.log10(amp[2500][1] / amp[2500][0]) > 40.0


def test_rds_end_to_end_and_batch_match():
    """tests/test_fm_broadcast.py::test_rds_end_to_end_through_fm_chain (15
    dB) as a batch of two rows, the second rotated by a constant phase,
    with 50 µs de-emphasis: RDS bits and station data exact per row."""
    n = 1 << 18
    left, right = _lr(n)
    bits = JR.rds_encode_groups(_groups())
    iq = np.asarray(JM.fm_stereo_mod(left, right, FS, rds_bits=bits)[0])
    rng = np.random.default_rng(5)
    z = iq + ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
              .astype(np.complex64) * np.sqrt(1.0 / 10 ** 1.5 / 2))
    zb = np.stack([z, z * np.complex64(np.exp(0.7j))]).astype(np.complex64)
    want = JD.fm_stereo_demod(zb, FS, de_emphasis_us=50.0, decode_rds=True)
    got = PD.fm_stereo_demod(zb, FS, de_emphasis_us=50.0, decode_rds=True,
                             device=CPU)
    for name in ("left", "right", "mono"):
        close(getattr(want, name), getattr(got, name))
    np.testing.assert_allclose(got.pilot_level.numpy(), want.pilot_level,
                               rtol=1e-5)
    for r in range(2):
        assert np.array_equal(got.rds_bits[r], want.rds_bits[r])
        _same_rds(got.rds[r], want.rds[r])
        assert got.rds[r].ps_name == "ORIONFM "
        assert got.rds[r].radiotext == "TPU NATIVE SDR"
