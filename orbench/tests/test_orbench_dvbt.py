"""The DVB-T cell at a tiny size (two frames, one pool batch): a sound run
is correct on the CPU and, traced, reports the metrics read from the
program's own spans and counters; a program without the recorder reports
none of them and still runs; a run is not correct with the timed path
broken underneath (a Viterbi decision, the start metrics handed to the
Viterbi or an RS output altered where each is produced, or half of the
batch left out); the same seed gives the same
inputs. On the card (``-m gpu``) the control fails the cell's limits while
the program passes them, and a traced run reads every new metric."""

import sys

import numpy as np
import pytest
import torch

from orion_sdr_tpu_torch.frame import chain
from orion_sdr_tpu_torch.ops import viterbi as viterbi_ops

from orbench import control, harness
from test_orbench_run import half_left_out
from tiny_dvbt import CELL, copy_with_tiny_dvbt

SPAN_METRICS = {"dvbt_receive_host_ms", "dvbt_tps_host_ms", "dvbt_ts_host_ms",
                "dvbt_forney_host_ms", "viterbi_launches"}
DEVICE_METRICS = {"viterbi_device_ms", "viterbi_roofline_pct",
                  "rs_roofline_pct"}
PROFILE_METRICS = {"device_idle_pct"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_with_tiny_dvbt(str(tmp_path_factory.mktemp("bench")))


def altered_viterbi(hooks, entry):
    """A decision flipped in the kernel's output, inside a lane's kept
    steps (RS corrects it downstream)."""
    def make(real):
        def w(*a, **k):
            bits = real(*a, **k).clone()
            bits[3, 200] ^= 1
            return bits
        return w
    hooks.wrap(viterbi_ops, "viterbi_chunks_kernel", make)


def free_start(hooks, entry):
    """The first chunk's pin of state 0 taken off the start metrics handed
    to the kernel (the decisions stay those of the zero margin's free
    start: only the start metrics' comparison sees it)."""
    def make(real):
        def w(c0, c1, pm0, *a, **k):
            pm0.fill_(0.0)
            return real(c0, c1, pm0, *a, **k)
        return w
    hooks.wrap(viterbi_ops, "viterbi_chunks_kernel", make)


def altered_rs(hooks, entry):
    """A message bit flipped in the RS decoder's output."""
    class Flipped:
        def __init__(self, rs):
            self.rs = rs

        def __getattr__(self, name):
            return getattr(self.rs, name)

        def decode_batch(self, blocks):
            msg, ok = self.rs.decode_batch(blocks)
            msg = np.array(msg)
            msg[3, 40] ^= 1
            return msg, ok
    hooks.wrap(chain, "rs_for", lambda real: lambda *a: Flipped(real(*a)))


def test_the_cell_is_listed_with_its_metrics(root):
    c = harness.load_cell(CELL, root)
    assert {m["name"] for m in c["per_layer"]} == SPAN_METRICS \
        | DEVICE_METRICS | PROFILE_METRICS
    assert {m["name"] for m in c["end_to_end"]} == {"rx_msps", "setup_s"}


def test_a_traced_run_reports_the_program_span_metrics(root):
    r = harness.run_cell(CELL, 2 ** 33 + 5, 0.3, True, root=root,
                         device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == SPAN_METRICS | PROFILE_METRICS, sorted(m)  # no kernels
    assert m["device_idle_pct"] == 100.0                    # on the CPU
    assert m["viterbi_launches"] == 0
    assert all(m[k] > 0 for k in SPAN_METRICS - {"viterbi_launches"})
    assert r["checks"]["llr_gap"]["value"] < r["checks"]["llr_gap"]["limit"]


def test_an_untraced_run_reports_the_end_to_end_metrics(root):
    r = harness.run_cell(CELL, 2 ** 31 + 17, 0.3, False, root=root,
                         device="cpu")
    assert r["correct"] and r["failed"] == 0
    assert set(r["metrics"]) == {"rx_msps", "setup_s"}


def test_a_program_without_the_recorder_reports_none(root, monkeypatch):
    import orion_sdr_tpu_torch
    monkeypatch.delattr(orion_sdr_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "orion_sdr_tpu_torch.obs", None)
    r = harness.run_cell(CELL, 2 ** 33 + 6, 0.3, True, root=root,
                         device="cpu")
    assert r["correct"]
    assert not SPAN_METRICS & set(r["metrics"])


@pytest.mark.parametrize("fault,broken", [
    (altered_viterbi, "viterbi_mismatch"), (free_start, "viterbi_mismatch"),
    (altered_rs, "rs_mismatch"),
    (half_left_out, "frames_mismatch")])
def test_a_broken_path_is_not_correct(root, fault, broken):
    r = harness.run_cell(CELL, 2 ** 31 + 18, 0.3, False, root=root,
                         device="cpu", faults=[fault])
    assert not r["correct"]
    assert r["checks"][broken]["value"] > r["checks"][broken]["limit"]


def test_the_same_seed_gives_the_same_inputs(root):
    c = harness.load_cell(CELL, root)
    gen = harness.part("traffic", c["generator"])
    a = gen.make(c["config_file"], c["params"], 2 ** 40 + 3, "cpu")
    b = gen.make(c["config_file"], c["params"], 2 ** 40 + 3, "cpu")
    assert all(torch.equal(x.iq, y.iq) and x.truth == y.truth
               for x, y in zip(a, b))
    assert len({t[5] for t in a[0].truth}) == len(a[0].truth)


@pytest.mark.gpu
def test_the_control_fails_and_the_program_passes(card, root):
    limits = harness.load_cell(CELL, root)["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102):
        r = control.readings(CELL, seed, card, root=root)
        assert all(r["program"][k] <= v for k, v in limits.items()), r
        assert r["control"]["llr_gap"] > limits["llr_gap"], r


@pytest.mark.gpu
def test_a_traced_run_on_the_card_reads_every_metric(card, root):
    r = harness.run_cell(CELL, 2 ** 31 + 103, 0.5, True, root=root,
                         device=card)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == SPAN_METRICS | DEVICE_METRICS | PROFILE_METRICS
    assert m["viterbi_launches"] == 1
    assert 0 <= m["device_idle_pct"] < 100
    assert 0 < m["viterbi_roofline_pct"] <= 100
    assert 0 < m["rs_roofline_pct"] <= 100
