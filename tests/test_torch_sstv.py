"""Torch port, SSTV Martin M1 (modulate/sstv.py, demodulate/sstv.py)
against the JAX package on the CPU, on tests/test_sstv.py's images.

The audio cannot match sample for sample: the reference sums the phase in
float32 up to ~1.4e6 rad (an ulp of 0.125 rad), so any two summation
orders part visibly; the port sums the float32 steps in float64 and takes
the sine there. The port is held to the reference through what survives
the phase. Tolerances:
- the frequency track bit-equal: the JAX package's own phase accumulator
  run on the port's track gives the JAX sstv_mod audio exactly;
- the port's audio within 1e-6 of a float64 numpy synthesis of the track;
- ``_instantaneous_freq`` of one audio within 0.02 Hz of the JAX one
  (float32 atan2 and mixing; measured 1.2e-3 Hz);
- the instantaneous frequency of the two packages' audios, 40 samples
  and more from a track step: within 6 Hz over the first 2^17 samples
  (phase < 1.5e5 rad; measured 4.1 Hz), median within 5 Hz and 99th
  percentile within 40 Hz over the whole picture (the reference's own
  float32 phase drifts as it grows; measured 2.5 / 25.0 Hz);
- the port's decode of the JAX audio equal to the JAX decode within one
  grey level on at least 99.9 % of the pixels (measured 100 %), the same
  VIS code, and PSNR against the sent image at least 35 dB for the JAX
  decode, the port's decode of its own audio and of the JAX audio (25 dB
  under tests/test_sstv.py's 20 dB noise)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.demodulate import sstv as JD
from orion_sdr_tpu.modulate import sstv as JM

from orion_sdr_tpu_torch.demodulate import sstv as PD
from orion_sdr_tpu_torch.modulate import sstv as PM

torch.set_num_threads(1)
CPU = "cpu"
FS = 11025.0
EDGE = 40


def _test_image():
    H, W = 256, 320
    img = np.zeros((H, W, 3), np.uint8)
    img[:, :, 0] = np.linspace(0, 255, W)[None, :]
    img[:, :, 1] = np.linspace(0, 255, H)[:, None]
    img[:H // 2, :, 2] = 200
    return img


def _psnr(got, want):
    err = np.abs(got.astype(float) - want.astype(float))[3:-3, 6:-6]
    return 20 * np.log10(255 / np.sqrt(np.mean(err ** 2)))


@pytest.fixture(scope="module")
def sent():
    """The test image, its track, the JAX and the port audio."""
    img = _test_image()
    track = PM._freq_track(img, FS)
    return (img, track, np.array(JM.sstv_mod(img, FS)),
            PM.sstv_mod(img, FS, device=CPU).numpy())


def test_track_bit_equal(sent):
    img, track, jax_audio, _ = sent
    assert np.array_equal(np.asarray(JM._freq_to_audio(track, FS, 0.8)),
                          jax_audio)
    small = np.random.default_rng(1).integers(0, 256, (100, 100, 3)).astype(
        np.uint8)
    for vis in (True, False):
        assert np.array_equal(
            np.asarray(JM._freq_to_audio(PM._freq_track(small, FS, vis),
                                         FS, 0.5)),
            np.asarray(JM.sstv_mod(small, FS, 0.5, vis)))


def test_audio_is_the_float64_phase(sent):
    _, track, jax_audio, audio = sent
    assert audio.dtype == np.float32 and audio.shape == jax_audio.shape
    phase = np.cumsum((np.float32(2 * np.pi / FS) * track).astype(np.float64))
    assert np.abs(audio - 0.8 * np.sin(phase)).max() <= 1e-6


def test_instantaneous_freq_and_audio_match(sent):
    _, track, jax_audio, audio = sent
    jf = np.asarray(JD._instantaneous_freq(jax_audio, FS))
    same = PD._instantaneous_freq(torch.as_tensor(jax_audio), FS).numpy()
    assert np.abs(same - jf).max() <= 0.02
    pf = PD._instantaneous_freq(torch.as_tensor(audio), FS).numpy()
    keep = np.ones(len(track), bool)
    for e in np.flatnonzero(np.diff(track)):
        keep[max(e - EDGE, 0):e + EDGE + 1] = False
    d = np.abs(pf - jf)
    head = 1 << 17
    assert d[:head][keep[:head]].max() <= 6.0
    assert np.median(d[keep]) <= 5.0
    assert np.percentile(d[keep], 99) <= 40.0


def test_decoded_images_match(sent):
    img, _, jax_audio, audio = sent
    ref = JD.sstv_demod(jax_audio, FS)
    got = PD.sstv_demod(jax_audio, FS, device=CPU)
    own = PD.sstv_demod(audio, FS, device=CPU)
    assert ref.vis == got.vis == own.vis == JM.MARTIN_M1["vis"]
    diff = np.abs(got.image.astype(int) - ref.image.astype(int))
    assert np.mean(diff <= 1) >= 0.999
    for out in (ref, got, own):
        assert out.image.shape == (256, 320, 3)
        assert _psnr(out.image, img) >= 35.0


def test_decode_under_noise_matches(sent):
    img, _, jax_audio, _ = sent
    rng = np.random.default_rng(0)
    noisy = jax_audio + rng.standard_normal(len(jax_audio)).astype(
        np.float32) * np.sqrt(np.mean(jax_audio ** 2) / 10 ** 2)
    ref = JD.sstv_demod(noisy, FS)
    got = PD.sstv_demod(torch.as_tensor(noisy), FS, device=CPU)
    assert ref.vis == got.vis == JM.MARTIN_M1["vis"]
    assert np.mean(np.abs(got.image.astype(int) - ref.image.astype(int))
                   <= 1) >= 0.999
    assert _psnr(got.image, img) >= 25.0


def test_validation_alike():
    with pytest.raises(ValueError):
        PM.sstv_mod(np.zeros((64, 64), np.uint8), FS, device=CPU)
    with pytest.raises(ValueError):
        PD.sstv_demod(np.zeros(int(FS), np.float32), FS, device=CPU)
