"""Packet and aviation on the card: ADS-B aircraft, APRS through the FM
chain, an RTTY call, AIS ships and a CSS sensor beacon below the noise.

The torch port's counterpart of examples/10_packet_and_aviation.py, on the
same seed and sizes.

Run: python3 examples/torch/10_packet_and_aviation.py         (on the CUDA card)
     python3 examples/torch/10_packet_and_aviation.py --cpu   (plain torch on the CPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

import orion_sdr_tpu_torch as sdr


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def main(device="cuda"):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu")
    rng = np.random.default_rng(1)
    out = {}

    # ── 1. ADS-B: four aircraft in one 1090 MHz capture ──────────────────────
    frames = [
        sdr.adsb_encode_identification(0x4840D6, "KLM1023"),
        sdr.adsb_encode_position(0x4840D6, 52.2572, 3.91937, 38000, odd=0),
        sdr.adsb_encode_position(0x4840D6, 52.2572, 3.91937, 38000, odd=1),
        sdr.adsb_encode_velocity(0x4840D6, 450.0, 245.0),
        sdr.adsb_encode_identification(0xA0B1C2, "UAL89"),
        sdr.adsb_encode_position(0xA0B1C2, 40.6413, -73.7781, 12000, odd=0),
        sdr.adsb_encode_position(0xA0B1C2, 40.6413, -73.7781, 12000, odd=1),
    ]
    fs_adsb = 8_000_000.0
    iq = _host(sdr.adsb_mod(frames, fs_adsb,
                            amplitudes=[1.0, 0.9, 0.9, 0.8, 0.35, 0.3, 0.3],
                            device=device))
    iq = iq + ((rng.standard_normal(len(iq))
                + 1j * rng.standard_normal(len(iq)))
               .astype(np.complex64) * 0.05)
    print("ADS-B sky:")
    out["adsb"] = []
    for m in sdr.adsb_decode_capture(iq, fs_adsb, device=device):
        what = m.callsign or (f"pos {m.position[0]:.4f},{m.position[1]:.4f} "
                              f"@ {m.altitude_ft} ft" if m.position
                              else f"alt {m.altitude_ft} ft" if m.altitude_ft
                              else f"gs {m.ground_speed_kt:.0f} kt "
                                   f"trk {m.track_deg:.0f}°")
        print(f"  {m.icao:06X}  TC{m.type_code:<2}  {what}")
        out["adsb"].append(f"{m.icao:06X} TC{m.type_code} {what}")

    # ── 2. APRS over AFSK-1200, through the FM voice chain ───────────────────
    fs = 48_000.0
    pkt = sdr.Ax25Frame(dest="APRS", src="W1AW-9", digis=("WIDE1-1",),
                        payload=b"!4237.14N/07120.83W>orion_sdr_tpu mobile")
    audio = _host(sdr.ax25_beacon([pkt], fs, device=device))
    fm_iq, _ = sdr.fm_mod(audio * 0.5, fs, 3000.0, device=device)
    back, _ = sdr.fm_demod(_host(fm_iq), fs, 3000.0, 3000.0, device=device)
    print("\nAPRS (through the FM chain):")
    out["aprs"] = []
    for f in sdr.ax25_decode(_host(back) * 2.0, fs, device=device):
        line = (f"{f.src} > {f.dest} via {','.join(f.digis)}: "
                f"{f.payload.decode()}")
        print(f"  {line}")
        out["aprs"].append(line)

    # ── 3. RTTY CQ call at 8 dB audio SNR ────────────────────────────────────
    fs_r = 11_025.0
    tty = _host(sdr.rtty_mod("CQ CQ CQ DE W1AW W1AW K", fs_r, device=device))
    tty = tty + rng.standard_normal(len(tty)).astype(np.float32) \
        * np.sqrt(float(np.mean(tty ** 2)) / 10 ** 0.8)
    out["rtty"] = sdr.rtty_decode(tty, fs_r, device=device)
    print("\nRTTY:", repr(out["rtty"]))

    # ── 4. AIS: two ships on the harbor channel ──────────────────────────────
    ships = [sdr.AisPosition(mmsi=211234567, lat=53.5421, lon=9.9845,
                             sog_kt=12.3, cog_deg=87.5, heading_deg=88),
             sdr.AisPosition(mmsi=244000111, lat=53.5380, lon=9.9710,
                             sog_kt=0.2, cog_deg=310.0, msg_type=3)]
    ais_iq = _host(sdr.ais_mod(ships, device=device))
    ais_iq = ais_iq + ((rng.standard_normal(len(ais_iq))
                        + 1j * rng.standard_normal(len(ais_iq)))
                       .astype(np.complex64) * np.sqrt(0.1 / 2))   # 10 dB
    print("\nAIS (GMSK 9600):")
    out["ais"] = []
    for s in sdr.ais_decode(ais_iq, 96_000.0, device=device):
        print(f"  MMSI {s.mmsi}  {s.lat:.4f},{s.lon:.4f}  "
              f"{s.sog_kt:.1f} kt  COG {s.cog_deg:.1f}°")
        out["ais"].append({"mmsi": s.mmsi, "lat": s.lat, "lon": s.lon,
                           "sog_kt": s.sog_kt, "cog_deg": s.cog_deg})

    # ── 5. CSS (LoRa-style): a sensor beacon below the noise floor ───────────
    beacon = _host(sdr.css_mod(b"sensor-7: 21.4C 1013hPa", sf=9,
                               device=device))
    z = np.concatenate([np.zeros(400, np.complex64), beacon])
    z = z + ((rng.standard_normal(len(z)) + 1j * rng.standard_normal(len(z)))
             .astype(np.complex64) * np.sqrt(10 ** 0.5 / 2))       # −5 dB!
    frame = sdr.css_demod(z, sf=9, device=device)
    print(f"\nCSS @ −5 dB IQ SNR: {frame.payload.decode()!r} "
          f"(crc_ok={frame.crc_ok})")
    out["css"] = {"payload": frame.payload.decode(),
                  "crc_ok": bool(frame.crc_ok)}
    return out


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
