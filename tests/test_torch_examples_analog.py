"""Torch port: the analog and block examples under examples/torch/ (01 FM
broadcast, 05 drop-in blocks, 06 CW band decode, 09 FM broadcast band)
reproduce the result lines of their JAX namesakes under examples/, run on
the CPU (``main("cpu")``). Lines agree as tests/torch_examples.py states:
decoded texts, station PI/PS/RT and flags exactly, measured numbers (dB,
Hz, wpm, pilot and audio levels) to one unit of their last printed
place."""

import torch

from torch_examples import assert_same_lines, jax_lines, port_run

torch.set_num_threads(1)


def test_01_fm_broadcast():
    want = jax_lines("01_fm_broadcast")
    res, got = port_run("01_fm_broadcast")
    assert_same_lines(want, got)
    assert res["tone_snr_db"] > 20.0


def test_05_dropin_blocks():
    want = jax_lines("05_dropin_blocks")
    res, got = port_run("05_dropin_blocks")
    assert_same_lines(want, got)
    assert res["ft8"]["call_de"] == "KA1ABC"
    assert res["psk31_text"] == "via blocks" and res["qam64_exact"]


def test_06_cw_band_decode():
    want = jax_lines("06_cw_band_decode")
    res, got = port_run("06_cw_band_decode")
    assert_same_lines(want, got)
    assert [d["text"] for d in res["decodes"]] == [
        "CQ CQ DE W1AW", "HELLO WORLD", "73 GL SK"]


def test_09_fm_broadcast_band():
    want = jax_lines("09_fm_broadcast_band")
    res, got = port_run("09_fm_broadcast_band")
    assert_same_lines(want, got)
    assert [(s["pi"], s["ps"], s["rt"]) for s in res["stations"]] == [
        (0x1111, "ALPHA FM", "MORNING SHOW"),
        (0x2222, "BETA  FM", "ALL NEWS ALL DAY"),
        (0x3333, "GAMMAFM ", "CLASSIC HITS")]
