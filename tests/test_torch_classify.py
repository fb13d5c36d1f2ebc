"""Torch port, blind classification and band decode (classify.py)
against the JAX package on the CPU, on tests/test_classify.py's captures
(made by the JAX package's modulators, the same numpy arrays into both).

Tolerances: labels, decoded texts and pages exact; segment centres,
widths and powers within 1e-3 relative (the port's Welch PSD is torch,
the JAX one XLA, both float32); confidences and features within 1e-3
relative or 1e-6 absolute (host float64 on the channelizer's float32
output; measured equal on the channel cases and ≤ 2e-5 relative through
the band channelizer); demodulated audio within 1e-4 of its peak (float32
channelizer and IIR chain; measured ~1e-6)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as o
from orion_sdr_tpu import classify as JC
from orion_sdr_tpu.dsp.osc import rotate

from orion_sdr_tpu_torch import classify as PC

from tests.test_torch_dsp_iir import jrun

torch.set_num_threads(1)
CPU = "cpu"
FS = 48_000.0
N = 1 << 16


def _close_class(got, ref):
    assert got.label == ref.label
    assert got.confidence == pytest.approx(ref.confidence, rel=1e-2,
                                           abs=0.05)
    assert got.features.keys() == ref.features.keys()
    for k, v in ref.features.items():
        assert got.features[k] == pytest.approx(v, rel=1e-2, abs=0.05), k


def _close_segment(got, ref):
    for f in ("center_hz", "bw_hz", "power_db", "snr_db"):
        assert getattr(got, f) == pytest.approx(getattr(ref, f), rel=1e-3,
                                                abs=1e-3), f


def test_classify_mode_matrix_matches():
    rng = np.random.default_rng(0)
    t = np.arange(N) / FS
    key = (np.sin(2 * np.pi * 3.0 * t) > 0).astype(np.float32)
    cases = {
        "cw": (jrun(o.cw_mod, key, FS, 600.0)[0], FS),
        "am": (o.am_mod((0.6 * np.sin(2 * np.pi * 1000 * t)
                         ).astype(np.float32), FS)[0], FS),
        "ssb": (jrun(o.ssb_mod, (0.5 * np.sin(2 * np.pi * 800 * t)
                                 + 0.4 * np.sin(2 * np.pi * 1900 * t)
                                 ).astype(np.float32), FS, 2800.0,
                     1500.0)[0], FS),
        "fm": (o.fm_mod((0.5 * np.sin(2 * np.pi * 1000 * t)
                         ).astype(np.float32), FS, 5000.0)[0], FS),
        "psk31": (o.bpsk31_mod_bits(
            rng.integers(0, 2, 256).astype(np.uint8), 8000.0)[0], 8000.0),
        "fsk": (o.pocsag_mod([o.PocsagPage(address=0x123, function=3,
                                           text="HELLO WORLD PAGE")],
                             38400.0), 38400.0),
        "noise": ((rng.standard_normal(N) + 1j * rng.standard_normal(N)
                   ).astype(np.complex64) * 0.1, FS),
    }
    t2 = np.arange(1 << 17) / 240e3
    cases["fm_stereo"] = (o.fm_stereo_mod(
        (0.8 * np.sin(2 * np.pi * 1000 * t2)).astype(np.float32),
        (0.8 * np.sin(2 * np.pi * 2500 * t2)).astype(np.float32),
        240e3)[0], 240e3)
    params = o.DvbTFrameParams(o.DvbTLinkParams("1/8", "qpsk", "1/2"))
    frame = o.DvbTFrameMod(params).modulate(
        rng.integers(0, 256, 300).astype(np.uint8))
    cases["ofdm"] = (frame.iq[:1 << 17], 1142857.0)
    for want, (z, fs) in cases.items():
        z = np.ascontiguousarray(np.asarray(z), np.complex64)
        ref = JC.classify_signal(z, fs)
        assert ref.label == want
        _close_class(PC.classify_signal(z, fs), ref)
        _close_class(PC.classify_signal(torch.from_numpy(z.copy()), fs), ref)


def test_classify_validation_alike():
    for mod in (JC, PC):
        with pytest.raises(ValueError):
            mod.classify_signal(np.zeros(100, np.complex64), FS)
        assert mod.classify_signal(np.zeros(8192, np.complex64),
                                   FS).label == "noise"


def _at(z, c, fs, n, g=1.0):
    zz = np.ascontiguousarray(np.asarray(z)[:n], np.complex64)
    if len(zz) < n:
        zz = np.concatenate([zz, np.zeros(n - len(zz), np.complex64)])
    return g * np.asarray(rotate(zz, c, fs)[0])


def test_band_survey_mixed_band_matches():
    rng = np.random.default_rng(0)
    fs = 1_000_000.0
    n = 1 << 19
    t = np.arange(n) / fs
    band = (_at(o.am_mod((0.6 * np.sin(2 * np.pi * 1000 * t)
                          ).astype(np.float32), fs)[0], -300e3, fs, n)
            + _at(o.fm_mod((0.5 * np.sin(2 * np.pi * 1000 * t)
                            ).astype(np.float32), fs, 5000.0)[0], -100e3,
                  fs, n)
            + _at(o.pocsag_mod(
                [o.PocsagPage(address=0x123, function=3,
                              text="HELLO WORLD PAGE FILLER TEXT HERE")] * 6,
                fs), 150e3, fs, n, 0.7)).astype(np.complex64)
    band = band + (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                   ).astype(np.complex64) * 0.004
    ref = JC.band_survey(band, fs)
    got = PC.band_survey(band, fs, device=CPU)
    assert sorted(e.signal.label for e in ref) == ["am", "fm", "fsk"]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close_segment(g.segment, r.segment)
        _close_class(g.signal, r.signal)


@pytest.fixture(scope="module")
def dispatch_band():
    """tests/test_classify.py::test_band_decode_dispatches_receivers's
    capture: AM at -150 kHz, POCSAG at +100 kHz, 500 kHz, 2^19 samples."""
    rng = np.random.default_rng(0)
    fs = 500_000.0
    n = 1 << 19
    t = np.arange(n) / fs
    am = o.am_mod((0.6 * np.sin(2 * np.pi * 800 * t)).astype(np.float32),
                  fs)[0]
    pg = o.pocsag_mod([o.PocsagPage(address=0x123, function=3,
                                    text="PAGE ME NOW")] * 4, fs)
    band = (_at(am, -150e3, fs, n) + _at(pg, 100e3, fs, n, 0.8)).astype(
        np.complex64)
    return fs, band + (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                       ).astype(np.complex64) * 0.004


def test_band_decode_end_to_end_matches(dispatch_band):
    fs, band = dispatch_band
    ref = JC.band_decode(band, fs)
    got = PC.band_decode(band, fs, device=CPU)
    assert [e.signal.label for e in ref] == ["am", "fsk"]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close_segment(g.segment, r.segment)
        _close_class(g.signal, r.signal)
        assert g.text == r.text and g.fs_audio == r.fs_audio
        assert (g.pages is None) == (r.pages is None)
        if r.pages:
            assert [vars(p) for p in g.pages] == [vars(p) for p in r.pages]
        assert (g.audio is None) == (r.audio is None)
        if r.audio is not None:
            a = np.asarray(r.audio)
            assert isinstance(g.audio, torch.Tensor)
            assert np.abs(g.audio.numpy() - a).max() <= \
                1e-4 * np.abs(a).max()
    assert got[1].text == "PAGE ME NOW"


def test_band_decode_undecodable_keeps_label_and_runtime_errors_propagate(
        dispatch_band, monkeypatch):
    fs, band = dispatch_band

    def cannot(*a, **k):
        raise ValueError("no sync")
    monkeypatch.setattr(PC, "pocsag_decode", cannot)
    monkeypatch.setattr(PC, "rtty_decode_fsk", cannot)
    got = PC.band_decode(band, fs, device=CPU)
    assert [e.signal.label for e in got] == ["am", "fsk"]
    assert got[0].audio is not None
    assert got[1].text is None and got[1].pages is None

    def fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(PC, "am_demod", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        PC.band_decode(band, fs, device=CPU)
