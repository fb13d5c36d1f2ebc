#!/usr/bin/env python3
"""Decodes chip_smoke.py's slice-6a captures ([43]-[47]) with the JAX
package on the CPU, at the widths the smoke runs the torch port at on the
card: the reference check that each full-width capture is decodable, so a
miss of the port on the card is the port's.

Usage, from the root of a checkout (JAX on the CPU; a few minutes):
    python3 tools/slice6a_jax_fullwidth.py [phase ...]
phases: cofdm dvbt ft8 morse band narrow adsb sstv (default: all). Prints
one line a phase with what came back, and exits 1 if any phase lost
something. The captures follow chip_smoke's recipes (its s6_* functions and
constants, the same numpy seeds), built with the JAX package's modulators.
"""

import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as S  # noqa: E402
import orion_sdr_tpu as J  # noqa: E402
from orion_sdr_tpu.classify import band_decode  # noqa: E402

OK = {}


def report(phase, ok, **what):
    OK[phase] = bool(ok)
    print(f"[{phase}] {'ok' if ok else 'LOST'} {what}", flush=True)


def cofdm():
    rng = np.random.default_rng(S.S6_SEED + 431)
    cfg, pre, table = S.link(J)
    mod = J.OfdmFrameMod(cfg, table, pre)
    frames = [(J.FrameMetadata(sequence_num=2000 + i, mcs_index=0,
                               flags=i % 256),
               rng.integers(0, 256, S.PAYLOAD_BYTES).astype(np.uint8),
               int(rng.integers(0, 2**32))) for i in range(S.N_FRAMES)]
    bodies = [np.asarray(mod.modulate_frame(J.FramePacket(m, d), s))[
        pre.total_len():] for m, d, s in frames]
    batch = np.zeros((len(bodies), max(map(len, bodies))), np.complex64)
    for i, b in enumerate(bodies):
        batch[i, :len(b)] = b
    y = J.cfo_apply(J.multipath_apply(batch, *S.CH_ECHO), S.CH_CFO_HZ, 1e6,
                    S.CH_PHASE0)
    sig = np.mean(np.abs(y) ** 2, axis=1, keepdims=True)
    y = y + ((rng.standard_normal(y.shape) + 1j * rng.standard_normal(
        y.shape)) * np.sqrt(sig * 0.02 / 2)).astype(np.complex64)
    out = J.OfdmFrameDemod(cfg, table).decode_batch(y)
    good = sum(isinstance(o, J.FramePacket) and np.array_equal(o.payload, d)
               and o.metadata == m for o, (m, d, _) in zip(out, frames))
    report("cofdm", good == len(frames), back=f"{good}/{len(frames)}")


def dvbt():
    rng = np.random.default_rng(S.S6_SEED + 432)
    base = J.DvbTFrameParams(J.DvbTLinkParams("1/8", "qpsk", "1/2"))
    from orion_sdr_tpu.modulate.dvb_t_frame import _coded_bits_for_packets
    cap = 68 * 1512 * 2
    n_pkt = 1
    while _coded_bits_for_packets(n_pkt + 1, base) <= cap:
        n_pkt += 1
    n_bytes = n_pkt * 187
    frames = [(J.DvbTFrameParams(base.link, i % 4, (17 * i) & 0xFF),
               rng.integers(0, 256, n_bytes).astype(np.uint8))
              for i in range(S.DVB_FRAMES)]
    mods = [J.DvbTFrameMod(p).modulate(d) for p, d in frames]
    batch = np.stack([np.asarray(m.iq) for m in mods])
    sig = float(np.mean(np.abs(batch) ** 2))
    y = np.asarray(J.multipath_apply(batch, *S.DVB_ECHO))
    y = y + ((rng.standard_normal(y.shape) + 1j * rng.standard_normal(
        y.shape)) * np.sqrt(sig / 10 ** (S.DVB_ECHO_SNR_DB / 10) / 2)
             ).astype(np.complex64)
    out = J.DvbTFrameDemod(base).decode_batch(y, mods[0].n_symbols, n_bytes)
    good = sum(np.array_equal(o.payload, d) and o.tps == p.tps_word()
               for o, (p, d) in zip(out, frames))
    report("dvbt", good == len(frames), back=f"{good}/{len(frames)}")


def ft8():
    from orion_sdr_tpu.codec.ft8_stream import ft8_decode_windows
    ht = J.CallsignHashTable()
    msgs = S.ft_messages(J, S.FT_FADED)
    n = S.FT_WIN["ft8"]
    x = np.zeros((S.FT_FADED, n), np.complex64)
    for w, msg in enumerate(msgs):
        frame = np.asarray(J.ft8_mod(J.ft8_encode(J.pack77(msg, ht)),
                                     S.FT_FS, S.FT_CARRIER))
        r = np.random.default_rng(S.S6_SEED + 4300 + w)
        win = np.zeros(n, np.complex64)
        win[:len(frame)] = frame
        y = np.asarray(J.watterson_apply(r, win, S.FT_FS, 1e-3, 0.5))
        sig = float(np.mean(np.abs(y[:len(frame)]) ** 2))
        x[w] = y + J.awgn(r, n, np.sqrt(sig * 0.5))
    out = ft8_decode_windows(x, S.FT_FS, S.FT_BASE, S.FT_MAX)
    good = [w for w, (o, m) in enumerate(zip(out, msgs))
            if o is not None and o.message == m]
    report("ft8", len(good) == len(msgs), back=f"{len(good)}/{len(msgs)}",
           lost=sorted(set(range(len(msgs))) - set(good)))


def morse():
    rng = np.random.default_rng(S.S6_SEED + 440)
    n = S.MORSE_N
    buf = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
           * S.MORSE_NOISE / np.sqrt(2)).astype(np.complex64)
    plan = S.s6_morse_plan()
    for text, wpm, tone, amp, start in plan:
        env = J.MorseEncoder(S.MORSE_FS, wpm).with_jitter(10.0).encode_text(
            text)
        assert start + len(env) <= n, text
        iq = np.asarray(J.cw_mod(env, S.MORSE_FS, tone)[0])
        buf[start:start + len(iq)] += amp * iq
    got = J.morse_decode_band(buf, S.MORSE_FS, 500.0, 10_500.0,
                              max_carriers=S.MORSE_SIGS)
    by_tone = {round(r.tone_hz / 100.0): r for r in got}
    bad = []
    for text, wpm, tone, _, _ in plan:
        r = by_tone.get(round(tone / 100.0))
        if r is None or r.text != text or abs(r.wpm - wpm) / wpm >= 0.15:
            bad.append((text, r and (r.text, round(r.wpm, 1))))
    report("morse", not bad and len(got) == len(plan), decoded=len(got),
           bad=bad)


def placed(z, c, fs, n, g=1.0):
    """chip_smoke.placed: cut or zero-padded to n samples, mixed to ``c``
    Hz by a float64 phasor."""
    zz = np.asarray(z, np.complex64)[:n]
    zz = np.concatenate([zz, np.zeros(n - len(zz), np.complex64)])
    turn = np.remainder(np.arange(n) * (c / fs), 1.0)
    return (g * (zz * np.exp(2j * np.pi * turn))).astype(np.complex64)


def band():
    fs, n = S.BAND_FS, 1 << S.BAND_LOG2_N
    rng = np.random.default_rng(S.S6_SEED + 45)
    t = np.arange(n) / fs

    def at(z, c, g=1.0):
        return placed(z, c, fs, n, g)
    am = J.am_mod((0.6 * np.sin(2 * np.pi * 800 * t)).astype(np.float32),
                  fs)[0]
    fm = J.fm_mod((0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32),
                  fs, 5000.0)[0]
    pg = J.pocsag_mod([J.PocsagPage(address=0x1234, function=3,
                                    text=S.BAND_PAGE)] * 5, fs)
    ssb = J.ssb_mod((0.5 * np.sin(2 * np.pi * 800 * t) + 0.4 * np.sin(
        2 * np.pi * 1900 * t)).astype(np.float32), fs, 2800.0, 1500.0)[0]
    wide = (at(am, -800e3) + at(fm, -300e3) + at(pg, 250e3, 0.7)
            + at(ssb, 700e3)).astype(np.complex64)
    wide = wide + ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                   * S.BAND_NOISE).astype(np.complex64)
    t0 = time.time()
    ok, what = S.s6_band_check(band_decode(wide, fs), np.asarray)
    report("band", ok, **what, s=round(time.time() - t0, 1))


def narrow():
    """CW at 250 kHz, RTTY at 256 kHz, PSK31 in a 500 kHz dispatch
    capture of 2^22 samples (the PSK31 text takes 7.9 s)."""
    from orion_sdr_tpu.codec.rtty import baudot_encode, rtty_frame_bits
    out = {}
    fs, n = 250_000.0, 1 << 20
    env = np.asarray(J.MorseEncoder(fs, 30.0).encode_text("CQ TEST K"),
                     np.float32)
    env = np.pad(env, (0, max(0, n - len(env))))[:n]
    z = placed(J.cw_mod(env, fs, 0.0)[0], 80e3, fs, n)
    rng = np.random.default_rng(S.S6_SEED + 451)
    z = z + ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
             * 0.01).astype(np.complex64)
    e = band_decode(z, fs)
    out["cw"] = [(x.signal.label, x.text) for x in e]
    fsr = 8000.0
    line = rtty_frame_bits(baudot_encode("CQ DE ORION SDR 599"))
    sps = fsr / 45.45
    k = np.minimum((np.arange(int(len(line) * sps)) / sps).astype(int),
                   len(line) - 1)
    iq = np.exp(1j * np.cumsum(2 * np.pi * np.where(line[k] == 1, -85.0,
                                                     85.0) / fsr)
                ).astype(np.complex64)
    wide = np.asarray(J.dsp.band_compose(iq[None], [60e3], 256_000.0, fsr))
    wide = wide + ((rng.standard_normal(len(wide)) + 1j
                    * rng.standard_normal(len(wide))) * 0.003
                   ).astype(np.complex64)
    out["rtty"] = [(x.signal.label, x.text) for x in band_decode(
        wide, 256_000.0)]
    fs, n = 500_000.0, 1 << 22
    t = np.arange(n) / fs

    def at(z, c, g=1.0):
        return placed(z, c, fs, n, g)
    am = J.am_mod((0.6 * np.sin(2 * np.pi * 800 * t)).astype(np.float32),
                  fs)[0]
    pg = J.pocsag_mod([J.PocsagPage(address=0x123, function=3,
                                    text="PAGE ME NOW")] * 60, fs)
    psk = J.bpsk31_mod_text("ORION PSK31 DISPATCH", fs)
    band = (at(am, -150e3) + at(pg, 100e3, 0.8) + at(psk, 30e3, 0.5)
            ).astype(np.complex64)
    band = band + ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                   * 0.004).astype(np.complex64)
    out["dispatch"] = [(round(x.segment.center_hz / 1e3), x.signal.label,
                        x.text) for x in band_decode(band, fs)]
    d = {c: (label, text) for c, label, text in out["dispatch"]}
    ok = (out["cw"] == [("cw", "CQ TEST K")]
          and out["rtty"] == [("fsk", "CQ DE ORION SDR 599")]
          and {c: v[0] for c, v in d.items()}
          == {-150: "am", 100: "fsk", 30: "psk31"}
          and set((d[100][1] or "").split(" / ")) == {"PAGE ME NOW"}
          and "ORION PSK31 DISPATCH" in (d[30][1] or ""))
    report("narrow", ok, **out)


def adsb():
    from orion_sdr_tpu.codec import adsb as A
    msgs, offsets, amps, truth = S.s6_adsb_plan()
    frames = [getattr(A, enc)(*args) for enc, args in msgs]
    n = 1 << S.ADSB_LOG2_N
    iq = J.adsb_mod(frames, S.ADSB_FS, offsets_s=offsets, amplitudes=amps,
                    total_s=n / S.ADSB_FS)
    rng = np.random.default_rng(S.S6_SEED + 460)
    iq = iq + ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
               * S.ADSB_NOISE).astype(np.complex64)
    got = J.adsb_decode_capture(iq, S.ADSB_FS, max_candidates=1024)
    ok, what = S.s6_adsb_check(got, frames, A.adsb_decode_frame, truth)
    report("adsb", ok, **what)


def sstv():
    img = S.s6_sstv_image()
    out = {}
    for fs in S.SSTV_RATES:
        audio = J.sstv_mod(img, fs)
        r = J.sstv_demod(audio, fs)
        out[fs] = (r.vis, round(S.s6_psnr(r.image, img), 2), len(audio))
    report("sstv", all(v[0] == 44 and v[1] >= 35.0 for v in out.values()),
           **{f"{k:g} Hz": v for k, v in out.items()})


PHASES = {"cofdm": cofdm, "dvbt": dvbt, "ft8": ft8, "morse": morse,
          "band": band, "narrow": narrow, "adsb": adsb, "sstv": sstv}

if __name__ == "__main__":
    for name in sys.argv[1:] or list(PHASES):
        t0 = time.time()
        PHASES[name]()
        print(f"  {name} took {time.time() - t0:.1f} s", flush=True)
    sys.exit(0 if all(OK.values()) else 1)
