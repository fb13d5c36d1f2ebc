"""Torch port, FT8/FT4 decoders against the JAX package on full 15 s / 7.5 s
frames: the batched many-window receive (``ft8/ft4_decode_windows``, the
slice's main path) on the windows of tests/test_ft8.py, with and without an
a-priori prior — the same messages, carriers and ``None``s, and the port's
one BP launch per call; the stream decoder (its floors, its hash table
across frames, AP ordering, ``flush``/``clear``); frames modulated by
either package decode in the other. Exact: messages, carriers (bin
centres), payloads."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as J
import orion_sdr_tpu_torch as T
from orion_sdr_tpu_torch.codec import ft8_ldpc

torch.set_num_threads(1)
CPU = "cpu"
FS = 12000.0


def _awgn(rng, n, power):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * np.sqrt(power / 2)).astype(np.complex64)


def _noise_power(snr_db):
    return FS / (2500.0 * 10.0 ** (snr_db / 10.0))


def _msg(m):
    """A message of either package as (type name, fields)."""
    return type(m).__name__, tuple(
        bytes(np.asarray(v, np.uint8)) if isinstance(v, np.ndarray) else v
        for v in dataclasses.astuple(m))


def _view(results):
    return [(_msg(r.message), r.carrier_hz) if r is not None else None
            for r in results]


def _bp_calls(monkeypatch):
    """Counts the BP decodes the port's FT8 path makes (on the CPU the
    wrapper runs its plain version, which the launch counter skips)."""
    calls = []
    real = ft8_ldpc.bp_decode

    def rec(g, llr, *a, **k):
        calls.append(llr.shape[0])
        return real(g, llr, *a, **k)
    monkeypatch.setattr(ft8_ldpc, "bp_decode", rec)
    return calls


def _windows(ft8, calls, snr_db, seed, step):
    ht = J.CallsignHashTable()
    rng = np.random.default_rng(seed)
    wins = []
    for i, c in enumerate(calls):
        p = J.pack77(J.Ft8Standard("CQ", c, "FN42"), ht)
        iq = np.asarray(J.ft8_mod(J.ft8_encode(p), FS, 1000.0 + i * step)
                        if ft8 else
                        J.ft4_mod(J.ft4_encode(p), FS, 1000.0 + i * step))
        wins.append(iq + _awgn(rng, len(iq), _noise_power(snr_db)))
    wins.append(_awgn(rng, len(wins[0]), _noise_power(snr_db)))
    return np.stack(wins)


@pytest.mark.parametrize("ft8,calls,snr,seed,step", [
    (True, ("KA1ABC", "W9XYZ", "K5TPU"), -12.0, 31, 25),
    (False, ("KA1ABC", "W9XYZ"), -8.0, 33, 30)])
def test_decode_windows_match(monkeypatch, ft8, calls, snr, seed, step):
    w = _windows(ft8, calls, snr, seed, step)
    jdec = J.ft8_decode_windows if ft8 else J.ft4_decode_windows
    tdec = T.ft8_decode_windows if ft8 else T.ft4_decode_windows
    bp = _bp_calls(monkeypatch)
    for ap in (None, J.ft8_ap_prior("CQ", ft4=not ft8)):
        jht, tht = J.CallsignHashTable(), T.CallsignHashTable()
        ref = jdec(w, FS, 950.0, 1150.0, hash_table=jht, ap=ap)
        got = tdec(w, FS, 950.0, 1150.0, hash_table=tht, ap=ap, device=CPU)
        assert _view(got) == _view(ref)
        assert [r.message.call_de if r else None for r in got] == \
            list(calls) + [None]
        for a, b in zip(got, ref):
            if a is not None:
                assert abs(a.snr_db - b.snr_db) <= 1e-3 * abs(b.snr_db)
        assert tht._inner == jht._inner
    # one BP decode a call: every candidate of every window (4 a window),
    # then the same rows and their prior-clamped copies together
    rows = 4 * (len(calls) + 1)
    assert bp == [rows, 2 * rows]


def test_decode_windows_ap_rescues_and_rejects():
    """tests/test_ft8.py's seeded -19.5 dB capture: the plain decode fails,
    the AP rows of the same batch recover it; a window of silence stays
    None; a prior for the wrong call does not fabricate a decode."""
    p = J.pack77(J.Ft8Standard("CQ", "KA1ABC", "FN42"), J.CallsignHashTable())
    iq = np.asarray(J.ft8_mod(J.ft8_encode(p), FS, base_hz=1012.5))
    rng = np.random.default_rng(904)
    noisy = iq + (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(
        len(iq))).astype(np.complex64) * np.sqrt(_noise_power(-19.5) / 2)
    w = np.stack([noisy, np.zeros_like(noisy)])
    ap = J.ft8_ap_prior("CQ")
    for prior in (None, ap, J.ft8_ap_prior("W9XYZ")):
        ref = J.ft8_decode_windows(w, FS, 950.0, 1150.0, ap=prior)
        got = T.ft8_decode_windows(w, FS, 950.0, 1150.0, ap=prior,
                                   device=CPU)
        assert _view(got) == _view(ref)
    got = T.ft8_decode_windows(w, FS, 950.0, 1150.0, ap=ap, device=CPU)
    assert got[0].message.call_de == "KA1ABC" and got[1] is None
    assert T.ft8_decode_windows(w, FS, 950.0, 1150.0, device=CPU)[0] is None


@pytest.mark.parametrize("ft8,snr_db", [(True, -15.0), (False, -11.0)])
def test_stream_decoder_at_the_snr_floor_matches(ft8, snr_db):
    p = J.pack77(J.Ft8Standard("CQ", "KA1ABC", "FN42"), J.CallsignHashTable())
    iq = np.asarray(J.ft8_mod(J.ft8_encode(p), FS, base_hz=1012.5) if ft8
                    else J.ft4_mod(J.ft4_encode(p), FS, base_hz=1012.5))
    jmk = J.Ft8StreamDecoder.new_ft8 if ft8 else J.Ft8StreamDecoder.new_ft4
    tmk = T.Ft8StreamDecoder.new_ft8 if ft8 else T.Ft8StreamDecoder.new_ft4
    for seed in range(3):
        x = iq + _awgn(np.random.default_rng(2000 + seed), len(iq),
                       _noise_power(snr_db))
        ref = jmk(FS, 950.0, 1150.0, max_cand=4).feed(x)
        dec = tmk(FS, 950.0, 1150.0, max_cand=4, device=CPU)
        # fed in two chunks: nothing decodes before a full frame is in
        assert dec.feed(x[:50_000]) == [] and len(dec) == 50_000
        got = dec.feed(x[50_000:])
        assert _view(got) == _view(ref)
        assert got and got[0].message.call_de == "KA1ABC"
        assert _view(dec.flush()) == _view(ref)
        dec.clear()
        assert len(dec) == 0 and dec.flush() == []
        assert dec.view_buf().device.type == "cpu"


def test_stream_decoder_hash_table_persists():
    jdec = J.Ft8StreamDecoder.new_ft8(FS, 950.0, 1150.0)
    tdec = T.Ft8StreamDecoder.new_ft8(FS, 950.0, 1150.0, device=CPU)
    # packing with the decoder's own table saves the full call in it
    J.pack77(J.Ft8NonStd("CQ", "PJ4/K1ABC"), jdec.hash_table)
    p1 = T.pack77(T.Ft8NonStd("CQ", "PJ4/K1ABC"), tdec.hash_table)
    frame = T.ft8_mod(T.ft8_encode(p1, device=CPU), FS, base_hz=1012.5,
                      device=CPU).numpy()
    ref, got = jdec.feed(frame), tdec.feed(frame)
    assert _view(got) == _view(ref)
    assert got[0].message.call_de == "PJ4/K1ABC"
    tdec.clear()
    jdec.clear()
    # the next frame's hashed call resolves through the decoder's table,
    # in both packages
    p2 = T.pack77(T.Ft8NonStd("PJ4/K1ABC", "W9XYZ"), T.CallsignHashTable())
    frame = T.ft8_mod(T.ft8_encode(p2, device=CPU), FS, base_hz=1050.0,
                      device=CPU).numpy()
    ref, got = jdec.feed(frame), tdec.feed(frame)
    assert _view(got) == _view(ref)
    assert got[0].message.call_to == "<PJ4/K1ABC>"
    assert tdec.hash_table._inner == jdec.hash_table._inner


def test_stream_decoder_ap_order_and_mismatch():
    p = J.pack77(J.Ft8Standard("W9XYZ", "KA1ABC", "FN42"),
                 J.CallsignHashTable())
    iq = np.asarray(J.ft8_mod(J.ft8_encode(p), FS, base_hz=1012.5))
    rng = np.random.default_rng(5)
    noisy = iq + (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(
        len(iq))).astype(np.complex64) * 0.05
    ap = J.ft8_ap_prior("CQ")             # wrong: the message is to W9XYZ
    ref = J.Ft8StreamDecoder(FS, 950.0, 1150.0, ap=ap).feed(noisy)
    got = T.Ft8StreamDecoder(FS, 950.0, 1150.0, ap=ap, device=CPU).feed(noisy)
    assert _view(got) == _view(ref)
    assert got[0].message.call_to == "W9XYZ"
    cand = T.ft8_sync(noisy, FS, 950.0, 1150.0, device=CPU)[0]
    assert T.ft8_decode_soft(cand.llr, ap=ap, device=CPU) is None


@pytest.mark.parametrize("ft8", [True, False])
def test_frames_cross_between_the_packages(ft8):
    ht = J.CallsignHashTable()
    p = J.pack77(J.Ft8Standard("KA1ABC", "W9XYZ", "-12"), ht)
    if ft8:
        jax_iq = np.asarray(J.ft8_mod(J.ft8_encode(p), FS, 1500.0))
        port_iq = T.ft8_mod(T.ft8_encode(p, device=CPU), FS, 1500.0,
                            device=CPU).numpy()
        jdec, tdec = J.ft8_decode_windows, T.ft8_decode_windows
    else:
        jax_iq = np.asarray(J.ft4_mod(J.ft4_encode(p), FS, 1500.0))
        port_iq = T.ft4_mod(T.ft4_encode(p, device=CPU), FS, 1500.0,
                            device=CPU).numpy()
        jdec, tdec = J.ft4_decode_windows, T.ft4_decode_windows
    a = tdec(jax_iq[None], FS, 1400.0, 1600.0, device=CPU)[0]
    b = jdec(port_iq[None], FS, 1400.0, 1600.0)[0]
    spacing = 6.25 if ft8 else 20.833334
    assert a is not None and b is not None and a.carrier_hz == b.carrier_hz
    for r in (a, b):
        assert abs(r.carrier_hz - 1500.0) <= spacing / 2
        assert (r.message.call_to, r.message.call_de, r.message.extra) == \
            ("KA1ABC", "W9XYZ", "-12")


def test_decode_windows_edge_shapes():
    """No window, silent windows, and a 1-D buffer (refused)."""
    n = 151_680
    for w in (np.zeros((0, n), np.complex64), np.zeros((2, n), np.complex64)):
        assert T.ft8_decode_windows(w, device=CPU) == \
            J.ft8_decode_windows(w) == [None] * len(w)
    with pytest.raises(ValueError):
        T.ft8_decode_windows(np.zeros(n, np.complex64), device=CPU)
