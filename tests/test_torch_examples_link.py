"""Torch port: the framed-link examples under examples/torch/ (02 FT8,
03 DVB-T link, 07 robust COFDM link, 08 band gateway, 11 blind receive)
reproduce the result lines of their JAX namesakes under examples/, run on
the CPU (``main("cpu")``). Lines agree as tests/torch_examples.py states:
texts, callsigns, TPS fields, payload flags and counts exactly, measured
numbers (Hz, dB, scores) to one unit of their last printed place."""

import torch

from torch_examples import assert_same_lines, jax_lines, port_run

torch.set_num_threads(1)


def test_02_ft8_receive():
    want = jax_lines("02_ft8_receive")
    res, got = port_run("02_ft8_receive")
    assert_same_lines(want, got)
    assert [d["text"] for d in res["decodes"]] == [
        "CQ KA1ABC FN42", "CQ W9XYZ FN42", "CQ K5TPU FN42"]


def test_03_dvb_t_link():
    want = jax_lines("03_dvb_t_link")
    res, got = port_run("03_dvb_t_link")
    assert_same_lines(want, got)
    assert want[-1] == "payload ok: True"
    assert res["frames"] == [{"frame": 0, "constellation": "qpsk",
                              "rate": "2/3", "guard": "1/16", "cell_id": 190,
                              "payload_ok": True}]


def test_07_robust_cofdm_link():
    want = jax_lines("07_robust_cofdm_link")
    res, got = port_run("07_robust_cofdm_link")
    assert_same_lines(want, got)
    assert res["payload_intact"] and res["seq"] == 1 and res["mcs"] == 1
    assert res["timing_offset"] == 5000


def test_08_band_gateway():
    want = jax_lines("08_band_gateway")
    res, got = port_run("08_band_gateway")
    assert_same_lines(want, got)
    assert [c["intact"] for c in res["channels"]] == [True] * 3
    assert [c["seq"] for c in res["channels"]] == [0, 1, 2]


def test_11_blind_receive():
    want = jax_lines("11_blind_receive")
    res, got = port_run("11_blind_receive")
    assert_same_lines(want, got)
    assert res["dvb_t"] == {"guard": "1/16", "constellation": "qam16",
                            "rate": "3/4", "cell_id": 42,
                            "payload_recovered": True}
    assert [e["label"] for e in res["band"]] == ["am", "fsk"]
    assert res["band"][1]["text"].startswith("MEET AT 0900")
