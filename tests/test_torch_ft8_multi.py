"""Torch port, FT8/FT4 multi-frame and multi-signal decoders against the JAX
package on tests/test_ft8.py's setups (full frames): LLR averaging over four
repeats at -21 dB (FT8) and -14 dB (FT4), composed with an AP prior at -23
dB; iterative subtraction over a separated band, a co-channel pair (one pass
finds the strong call, three find both) and an FT4 pair. The same messages
as the JAX package, in the same order; multi-frame carriers exact (bin
centres), multi-signal carriers (refined by the fit) within 0.05 Hz; one BP
decode a sync (all candidates together)."""

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


def _msg(m):
    return type(m).__name__, dataclasses.astuple(m)


def _frame(fields, base, ft8=True, amp=1.0):
    p = J.pack77(J.Ft8Standard(*fields), J.CallsignHashTable())
    return amp * np.asarray(J.ft8_mod(J.ft8_encode(p), FS, base_hz=base)
                            if ft8 else
                            J.ft4_mod(J.ft4_encode(p), FS, base_hz=base))


def _repeats(iq, snr_db, seed):
    rng = np.random.default_rng(seed)
    power = FS / (2500.0 * 10.0 ** (snr_db / 10.0))
    return np.stack([iq + ((rng.standard_normal(len(iq)) + 1j
                            * rng.standard_normal(len(iq)))
                           * np.sqrt(power / 2)).astype(np.complex64)
                     for _ in range(4)])


@pytest.mark.parametrize("ft8,call,snr,seed,ap", [
    (True, "KA1ABC", -21.0, 101, False), (False, "W9XYZ", -14.0, 7, False),
    (True, "KA1ABC", -23.0, 601, True)])
def test_multi_frame_matches(monkeypatch, ft8, call, snr, seed, ap):
    extra = "FN42" if call == "KA1ABC" else "EN50"
    frames = _repeats(_frame(("CQ", call, extra), 1012.5, ft8), snr, seed)
    jdec = J.ft8_decode_multi_frame if ft8 else J.ft4_decode_multi_frame
    tdec = T.ft8_decode_multi_frame if ft8 else T.ft4_decode_multi_frame
    calls = []
    real = ft8_ldpc.bp_decode
    monkeypatch.setattr(ft8_ldpc, "bp_decode", lambda g, llr, *a, **k: (
        calls.append(llr.shape[0]), real(g, llr, *a, **k))[1])
    priors = (None, J.ft8_ap_prior("CQ", ft4=not ft8)) if ap else (None,)
    for prior in priors:
        ref = jdec(frames, FS, 950.0, 1150.0, ap=prior)
        got = tdec(frames, FS, 950.0, 1150.0, ap=prior, device=CPU)
        assert (ref is None) == (got is None)
        if got is not None:
            assert _msg(got.message) == _msg(ref.message)
            assert got.carrier_hz == ref.carrier_hz
    # the composed case: plain fails, the prior rescues it
    assert got is not None and got.message.call_de == call
    if ap:
        assert ref is not None
        assert tdec(frames, FS, 950.0, 1150.0, device=CPU) is None or \
            tdec(frames, FS, 950.0, 1150.0, device=CPU).message.call_de \
            != call
    assert calls[0] == 4 and (not ap or calls[1] == 8)


def _same(got, ref):
    assert [_msg(r.message) for r in got] == [_msg(r.message) for r in ref]
    for a, b in zip(got, ref):
        assert abs(a.carrier_hz - b.carrier_hz) < 0.05


def test_multi_signal_separated_band_matches():
    iq = (_frame(("CQ", "KA1ABC", "FN42"), 1012.5)
          + _frame(("KA1ABC", "W9XYZ", "EN50"), 1293.75, amp=0.5)
          + _frame(("CQ", "G4ABC", "IO91"), 1550.0, amp=0.25))
    rng = np.random.default_rng(11)
    iq = (iq + 0.05 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))
          ).astype(np.complex64)
    ref = J.ft8_decode_multi_signal(iq, FS, 950.0, 1700.0)
    got = T.ft8_decode_multi_signal(iq, FS, 950.0, 1700.0, device=CPU)
    _same(got, ref)
    assert {"KA1ABC", "W9XYZ", "G4ABC"} <= {r.message.call_de for r in got}


def test_multi_signal_uncovers_the_cochannel_weak_signal():
    strong = _frame(("CQ", "KA1ABC", "FN42"), 1012.5)
    weak = _frame(("KA1ABC", "W9XYZ", "EN50"), 1012.5, amp=0.12)
    rng = np.random.default_rng(12)
    iq = (strong + weak + 0.01 * (rng.standard_normal(len(strong)) + 1j
                                   * rng.standard_normal(len(strong)))
          ).astype(np.complex64)
    for passes, want in ((1, {"KA1ABC"}), (3, {"KA1ABC", "W9XYZ"})):
        ref = J.ft8_decode_multi_signal(iq, FS, 950.0, 1150.0,
                                        max_passes=passes)
        got = T.ft8_decode_multi_signal(iq, FS, 950.0, 1150.0,
                                        max_passes=passes, device=CPU)
        _same(got, ref)
        assert {r.message.call_de for r in got} == want


def test_ft4_multi_signal_matches():
    ht = J.CallsignHashTable()
    a = _frame(("CQ", "KA1ABC", "FN42"), 1012.5, ft8=False)
    b = _frame(("CQ", "W9XYZ", "EN50"), 1300.0, ft8=False)
    iq = (a + 0.5 * b).astype(np.complex64)
    ref = J.ft4_decode_multi_signal(iq, FS, 950.0, 1400.0, hash_table=ht)
    got = T.ft4_decode_multi_signal(iq, FS, 950.0, 1400.0, device=CPU)
    _same(got, ref)
    assert {r.message.call_de for r in got} == {"KA1ABC", "W9XYZ"}


def test_subtraction_fit_matches():
    """One LS subtraction of a frame 2 Hz off its bin: the refined carrier,
    the coherence and the amplitude, and the residual left."""
    from orion_sdr_tpu.codec.ft8_stream import (
        _subtract_frame_impl as j_sub, _raw_cpfsk as j_synth,
        _full_tone_sequence as j_full)
    from orion_sdr_tpu_torch.codec.ft8_stream import (
        _subtract_frame_impl as t_sub, _raw_cpfsk as t_synth)
    p = J.pack77(J.Ft8Standard("CQ", "KA1ABC", "FN42"), J.CallsignHashTable())
    tones = J.ft8_encode(p)
    iq = (0.8 * np.asarray(J.ft8_mod(tones, FS, 1014.5))).astype(np.complex64)
    full = j_full(tones, True)
    r_j = iq.copy()
    fj, cj, aj = j_sub(r_j, full, 0, 1012.5, FS, 1920, j_synth(True))
    r_t = torch.as_tensor(iq.copy())
    ft, ct, at = t_sub(r_t, full, 0, 1012.5, FS, 1920, t_synth(True))
    assert abs(ft - fj) < 1e-3 and abs(ct - cj) < 1e-4 and abs(at - aj) < 1e-4
    assert abs(ft - 1014.5) < 0.05 and ct > 0.99 and abs(at - 0.8) < 1e-2
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=0, atol=1e-3)
    assert np.abs(r_t.numpy()).max() < 0.05
