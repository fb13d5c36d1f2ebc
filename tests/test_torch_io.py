"""Torch port, capture file I/O (io.py) against the JAX package on the
CPU: the files each package writes are byte for byte the same, and what
each reads back is the same array (exact). The writers take a tensor too."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu import io as JI

from orion_sdr_tpu_torch import io as PI

torch.set_num_threads(1)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def iq():
    rng = np.random.default_rng(0)
    return ((rng.standard_normal(5000) + 1j * rng.standard_normal(5000))
            * 0.3).astype(np.complex64)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_iq_wav_identical(tmp_path, iq, as_tensor):
    ref, got = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    JI.write_iq_wav(ref, iq, 48000.0)
    PI.write_iq_wav(got, torch.as_tensor(iq) if as_tensor else iq, 48000.0)
    assert _bytes(got) == _bytes(ref)
    (a, fa), (b, fb) = JI.read_iq_wav(ref), PI.read_iq_wav(ref)
    assert fa == fb == 48000.0 and a.dtype == b.dtype
    assert np.array_equal(a, b)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_audio_wav_identical(tmp_path, as_tensor):
    audio = (0.5 * np.sin(2 * np.pi * 440 * np.arange(8000) / 8000.0)
             ).astype(np.float32)
    ref, got = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    JI.write_audio_wav(ref, audio, 8000.0)
    PI.write_audio_wav(got, torch.as_tensor(audio) if as_tensor else audio,
                       8000.0)
    assert _bytes(got) == _bytes(ref)
    (a, fa), (b, fb) = JI.read_audio_wav(ref), PI.read_audio_wav(ref)
    assert fa == fb and np.array_equal(a, b)
    # the first channel of a stereo (IQ) file, as the JAX reader takes it
    stereo = str(tmp_path / "s.wav")
    JI.write_iq_wav(stereo, audio + 0.5j, 8000.0)
    assert np.array_equal(PI.read_audio_wav(stereo)[0],
                          JI.read_audio_wav(stereo)[0])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_iq_npz_identical(tmp_path, iq, as_tensor):
    ref, got = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    JI.write_iq_npy(ref, iq, 96000.0)
    PI.write_iq_npy(got, torch.as_tensor(iq) if as_tensor else iq, 96000.0)
    (a, fa), (b, fb) = JI.read_iq_npy(ref), PI.read_iq_npy(got)
    assert fa == fb == 96000.0 and np.array_equal(a, b)
    assert np.array_equal(b, iq)


def test_validation_alike(tmp_path):
    bad = np.zeros((2, 10), np.complex64)
    p = str(tmp_path / "x.wav")
    for mod in (JI, PI):
        with pytest.raises(ValueError):
            mod.write_iq_wav(p, bad, 8000.0)
        with pytest.raises(ValueError):
            mod.write_audio_wav(p, bad.real, 8000.0)
    PI.write_audio_wav(p, np.ones(10, np.float32), 8000.0)
    with pytest.raises(ValueError):
        PI.read_iq_wav(p)              # mono is not an IQ file
