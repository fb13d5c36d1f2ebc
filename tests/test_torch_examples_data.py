"""Torch port: the data-mode and scale-out examples under examples/torch/
(04 scale-out, 10 packet and aviation, 12 weak-signal beacons, 13 GPS
receiver) reproduce the result lines of their JAX namesakes under
examples/, run on the CPU (``main("cpu")``; example 04 on a mesh of eight
CPU shards). Lines agree as tests/torch_examples.py states: callsigns,
ICAO addresses, MMSIs, CRC flags, payloads and counts exactly, measured
numbers (Hz, dB, m, kt, degrees) to one unit of their last printed place.
Example 04's scaling table is a timing and is not compared."""

import torch

from torch_examples import assert_same_lines, jax_lines, port_run

torch.set_num_threads(1)


def test_04_scale_out():
    want = jax_lines("04_scale_out")
    res, got = port_run("04_scale_out")
    cut = want.index("4. scaling harness:") + 2        # through the header
    assert_same_lines(want[:cut], got[:cut])
    assert len(got) == len(want)
    assert [r["devices"] for r in res["scaling"]] == [1, 2, 4, 8]
    assert res["psk31_text"] == "sharded psk31 stream decode"
    assert (res["ber_errors"], res["ber_bits"]) == (41, 32768)


def test_10_packet_and_aviation():
    want = jax_lines("10_packet_and_aviation")
    res, got = port_run("10_packet_and_aviation")
    assert_same_lines(want, got)
    assert [s["mmsi"] for s in res["ais"]] == [211234567, 244000111]
    assert res["css"] == {"payload": "sensor-7: 21.4C 1013hPa",
                          "crc_ok": True}
    assert res["rtty"].strip().startswith("CQ CQ CQ DE W1AW")


def test_12_weak_signal_beacons():
    want = jax_lines("12_weak_signal_beacons")
    res, got = port_run("12_weak_signal_beacons")
    assert_same_lines(want, got)
    assert [(d["callsign"], d["grid"], d["dbm"]) for d in res["decodes"]] == [
        ("K1ABC", "FN42", 37), ("W1AW", "FN31", 30), ("DL2XYZ", "JO62", 23)]


def test_13_gps_receiver():
    want = jax_lines("13_gps_receiver")
    res, got = port_run("13_gps_receiver")
    assert_same_lines(want, got)
    assert [a["prn"] for a in res["acquired"]] == [7, 13]
    assert res["fix_error_m"] < 0.5
