"""Torch port: the DVB-T super-frame and the stream receivers against the JAX
package.

The setups are those of ``tests/test_dvb_t.py:272-360`` (super-frame cell id,
``decode_batch`` against ``decode``, chunked stream against one-shot, a
partial frame held) and ``tests/test_dvb_t_hier.py:172`` (the hierarchical
stream over two chunked frames). Super-frame IQ from both modulators must
agree within 1e-5 × RMS; payloads, the 16-bit cell id and the stream results
must equal the JAX package's; frames cross between the packages."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.demodulate.dvb_t_stream import (
    DvbTFrameStreamDemod as JStream, DvbTHierFrameStreamDemod as JHierStream)
from orion_sdr_tpu.demodulate.dvb_t_super_frame import (
    DvbTSuperFrameDemod as JSuperDemod)
from orion_sdr_tpu.modulate.dvb_t_super_frame import (
    DvbTSuperFrameMod as JSuperMod)
from orion_sdr_tpu.waveform import dvb_t as JD

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.demodulate.dvb_t_stream import (MAX_SHORT_SKIPS,
                                                         MIN_LOCK_SCORE)
from orion_sdr_tpu_torch.waveform import DVB_T_FRAMES_PER_SUPER_FRAME

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

LINK = ("1/32", "qpsk", "1/2")            # tests/test_dvb_t.py:21


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


def _noisy(iq, snr_db, seed):
    rng = np.random.default_rng(seed)
    sig = float(np.mean(np.abs(iq) ** 2))
    return iq + (rng.standard_normal(len(iq))
                 + 1j * rng.standard_normal(len(iq))
                 ).astype(np.complex64) * np.sqrt(sig / 10 ** (snr_db / 10)
                                                  / 2)


def _payloads(results):
    return [r.payload for r in results if hasattr(r, "payload")]


@pytest.fixture(scope="module")
def super_frame():
    """A 0xBEEF super-frame (2000-byte payload, seed 14) from each package."""
    jp = JD.DvbTSuperFrameParams(JD.DvbTLinkParams(*LINK), cell_id=0xBEEF)
    pp = P.DvbTSuperFrameParams(P.DvbTLinkParams(*LINK), cell_id=0xBEEF)
    payload = _payload(2000, 14)
    return dict(jp=jp, pp=pp, payload=payload,
                jsf=JSuperMod(jp).modulate(payload),
                psf=P.DvbTSuperFrameMod(pp, device="cpu").modulate(payload))


def test_super_frame_params_match():
    jp = JD.DvbTSuperFrameParams(JD.DvbTLinkParams(*LINK), cell_id=0xBEEF)
    pp = P.DvbTSuperFrameParams(P.DvbTLinkParams(*LINK), cell_id=0xBEEF)
    assert DVB_T_FRAMES_PER_SUPER_FRAME == JD.DVB_T_FRAMES_PER_SUPER_FRAME \
        == 4
    for f in range(4):
        a, b = pp.frame(f), jp.frame(f)
        assert (a.frame_number, a.cell_id) == (b.frame_number, b.cell_id)
        assert a.cell_id == (0xBE if f % 2 == 0 else 0xEF)


def test_super_frame_iq_matches(super_frame):
    jsf, psf = super_frame["jsf"], super_frame["psf"]
    assert psf.frame_payload_lens == jsf.frame_payload_lens == (500,) * 4
    assert (psf.symbols_per_frame, psf.samples_per_symbol) == \
        (jsf.symbols_per_frame, jsf.samples_per_symbol)
    assert psf.n_symbols() == 4 * 68
    rms = float(np.sqrt(np.mean(np.abs(jsf.iq) ** 2)))
    assert psf.iq.shape == jsf.iq.shape and psf.iq.dtype == np.complex64
    assert float(np.abs(psf.iq - jsf.iq).max()) <= 1e-5 * rms


def test_super_frame_roundtrip_cell_id(super_frame):
    # tests/test_dvb_t.py:272, both ways between the packages
    jsf, psf = super_frame["jsf"], super_frame["psf"]
    prx = P.DvbTSuperFrameDemod(super_frame["pp"], device="cpu").decode(
        jsf.iq, jsf.symbols_per_frame, jsf.frame_payload_lens)
    jrx = JSuperDemod(super_frame["jp"]).decode(
        psf.iq, psf.symbols_per_frame, psf.frame_payload_lens)
    for rx in (prx, jrx):
        assert np.array_equal(rx.payload, super_frame["payload"])
        assert rx.cell_id == 0xBEEF
    assert isinstance(prx, P.DvbTRxSuperFrame)


def test_super_frame_decode_batch_matches_decode(super_frame):
    # tests/test_dvb_t.py:344: 12 dB, noise seed 17
    psf = super_frame["psf"]
    cap = _noisy(psf.iq, 12.0, 17)
    demod = P.DvbTSuperFrameDemod(super_frame["pp"], device="cpu")
    a = demod.decode(cap, psf.symbols_per_frame, psf.frame_payload_lens)
    b = demod.decode_batch(cap, psf.symbols_per_frame, psf.frame_payload_lens)
    ref = JSuperDemod(super_frame["jp"]).decode_batch(
        cap, psf.symbols_per_frame, psf.frame_payload_lens)
    for rx in (a, b, ref):
        assert np.array_equal(rx.payload, super_frame["payload"])
        assert rx.cell_id == 0xBEEF


def test_super_frame_errors(super_frame):
    psf = super_frame["psf"]
    demod = P.DvbTSuperFrameDemod(super_frame["pp"], device="cpu")
    # frames out of order: frame 1 where frame 0 belongs
    n = len(psf.iq) // 4
    swapped = np.concatenate([psf.iq[n:2 * n], psf.iq[:n], psf.iq[2 * n:]])
    with pytest.raises(P.DvbTRxSuperFrameError) as e:
        demod.decode(swapped, psf.symbols_per_frame, psf.frame_payload_lens)
    assert e.value.got == [1, 0, 2, 3]
    with pytest.raises(P.DvbTRxSuperFrameError) as e:
        demod.decode_batch(psf.iq[:3 * n], psf.symbols_per_frame,
                           psf.frame_payload_lens)
    assert e.value.kind == "incomplete"
    with pytest.raises(P.DvbTRxSuperFrameError) as e:
        demod.decode(psf.iq[:2 * n], psf.symbols_per_frame,
                     psf.frame_payload_lens)
    assert e.value.frame == 2


# ── stream receivers ─────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def frame300():
    """tests/test_dvb_t.py:282: frame 0, cell 3, a 300-byte payload."""
    params = P.DvbTFrameParams(P.DvbTLinkParams(*LINK), 0, 3)
    payload = _payload(300, 15)
    return params, payload, P.DvbTFrameMod(params,
                                           device="cpu").modulate(payload)


def test_stream_chunked_matches_oneshot_and_jax(frame300):
    params, payload, frame = frame300
    run = np.concatenate([frame.iq, frame.iq,
                          np.zeros(frame.samples_per_symbol, np.complex64)])
    one = P.DvbTFrameStreamDemod(params, frame.n_symbols, len(payload),
                                 device="cpu")
    a = one.feed(run) + one.flush()
    chunked = P.DvbTFrameStreamDemod(params, frame.n_symbols, len(payload),
                                     device="cpu")
    b = []
    for i in range(0, len(run), 37_000):
        b += chunked.feed(run[i:i + 37_000])
    b += chunked.flush()
    jparams = JD.DvbTFrameParams(JD.DvbTLinkParams(*LINK), 0, 3)
    js = JStream(jparams, frame.n_symbols, len(payload))
    c = []
    for i in range(0, len(run), 37_000):
        c += js.feed(run[i:i + 37_000])
    c += js.flush()
    pa, pb, pc = _payloads(a), _payloads(b), _payloads(c)
    assert len(pa) == len(pb) == len(pc) == 2
    assert all(np.array_equal(x, payload) for x in pa + pb + pc)
    assert [r.tps for r in b if hasattr(r, "tps")] == [params.tps_word()] * 2
    assert len(one) == len(chunked) <= frame.samples_per_symbol


def test_stream_holds_partial_frame(frame300):
    # tests/test_dvb_t.py:301
    params, payload, frame = frame300
    st = P.DvbTFrameStreamDemod(params, frame.n_symbols, len(payload),
                                device="cpu")
    half = len(frame.iq) // 2
    assert st.feed(frame.iq[:half]) == []
    assert len(st) == half and st.view_buf().dtype == np.complex64
    rest = st.feed(np.concatenate([frame.iq[half:],
                                   np.zeros(frame.samples_per_symbol,
                                            np.complex64)]))
    good = _payloads(rest)
    assert good and np.array_equal(good[0], payload)
    st.clear()
    assert len(st) == 0


def test_stream_trims_dead_air_and_skips_bad_frames_as_jax(frame300):
    # silence (no lock: the buffer is cut to a frame + 5 symbols), then a
    # frame with a NaN burst (blanked) behind 5 symbols of silence: the same
    # short skips, the same frame and the same buffer as the JAX stream
    params, payload, frame = frame300
    iq = frame.iq.copy()
    iq[5000:5003] = np.nan
    sps = frame.samples_per_symbol
    jparams = JD.DvbTFrameParams(JD.DvbTLinkParams(*LINK), 0, 3)
    runs = []
    for st in (P.DvbTFrameStreamDemod(params, frame.n_symbols, len(payload),
                                      device="cpu"),
               JStream(jparams, frame.n_symbols, len(payload))):
        out = st.feed(np.zeros(3 * len(iq), np.complex64))
        held = len(st)
        for i in range(0, len(iq), 20_000):
            out += st.feed(iq[i:i + 20_000])
        out += st.feed(np.zeros(3 * sps, np.complex64)) + st.flush()
        runs.append((held, [type(r).__name__ for r in out], _payloads(out),
                     len(st)))
    (held, kinds, got, rest), (jheld, jkinds, jgot, jrest) = runs
    assert held == jheld == len(iq) + 5 * sps
    assert kinds == jkinds and rest == jrest
    assert kinds.count("DvbTRxFrame") == 1
    assert kinds.count("DvbTRxError") <= MAX_SHORT_SKIPS
    assert np.array_equal(got[0], payload) and np.array_equal(jgot[0], payload)
    assert MIN_LOCK_SCORE == 0.2


def test_hier_stream_demod_chunked_two_frames():
    # tests/test_dvb_t_hier.py:172, and the JAX stream on the same run
    fields = ("1/32", "qam16", 2, "1/2", "2/3")
    pp = P.DvbTHierFrameParams(P.DvbTHierLinkParams(*fields))
    jp = JD.DvbTHierFrameParams(JD.DvbTHierLinkParams(*fields))
    hp, lp = _payload(300, 6), _payload(700, 7)
    mod = P.DvbTHierFrameMod(pp, device="cpu")
    f1 = mod.modulate(hp, lp)
    f2 = mod.modulate(hp[::-1].copy(), lp[::-1].copy())
    stream = np.concatenate([np.zeros(500, np.complex64), f1.iq, f2.iq,
                             np.zeros(300, np.complex64)])

    def run(sd, chunk):
        out = []
        for i in range(0, len(stream), chunk):
            out += sd.feed(stream[i:i + chunk])
        out += sd.flush()
        return [r for r in out if hasattr(r, "hp_payload")]

    results = [run(P.DvbTHierFrameStreamDemod(pp, f1.n_symbols, len(hp),
                                              len(lp), device="cpu"), chunk)
               for chunk in (40_000, 170_000)]
    results.append(run(JHierStream(jp, f1.n_symbols, len(hp), len(lp)),
                       40_000))
    for frames in results:
        assert len(frames) == 2
        assert np.array_equal(frames[0].hp_payload, hp)
        assert np.array_equal(frames[0].lp_payload, lp)
        assert np.array_equal(frames[1].hp_payload, hp[::-1])
        assert np.array_equal(frames[1].lp_payload, lp[::-1])
    assert all(isinstance(f, P.DvbTHierRxFrame) for f in results[0])
    with pytest.raises(NotImplementedError):
        P.DvbTHierFrameStreamDemod(pp, f1.n_symbols, 1, 1, device="cpu") \
            .with_integer_cfo_correction()


def test_band_receive_stays_unported():
    """The band receiver is ported (slice 5a): the port's
    DvbTBandStreamDemod designs the JAX one's channelizer (the same taps,
    centers and decimation) and one stream a mux on its device."""
    from orion_sdr_tpu.demodulate.dvb_t_stream import DvbTBandStreamDemod
    jp = JD.DvbTFrameParams(JD.DvbTLinkParams(*LINK))
    params = P.DvbTFrameParams(P.DvbTLinkParams(*LINK))
    for fs, centers in ((1e6, [-1.4e6, 1.1e6]), (2e6, [0.0])):
        ref = DvbTBandStreamDemod(jp, 68, 100, centers, fs, 4 * fs)
        rx = P.DvbTBandStreamDemod(params, 68, 100, centers, fs, 4 * fs,
                                   device="cpu")
        assert np.array_equal(rx.channelizer.taps, ref.channelizer.taps)
        assert np.array_equal(rx.centers_hz, ref.centers_hz)
        assert rx.channelizer.m == ref.channelizer.m == 4
        assert len(rx.streams) == len(centers) and len(rx) == 0
        assert all(s.device == torch.device("cpu") for s in rx.streams)
