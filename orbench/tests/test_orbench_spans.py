"""The metrics read from the program's own spans and counters
(``orbench/recorded.py``): a traced run of each tiny cell on the CPU
reports every one its cell lists, with the counts the cell's shapes give
on the CPU (no BP kernel launches there: the plain BP runs), and a program
without the recorder reports none of them and still runs."""

import sys

import pytest

from orbench import harness
from tiny import copy_with_tiny

NEW = {
    "cofdm_ldpc_bch.tiny": {"cofdm_crc_host_ms", "cofdm_demap_host_ms",
                            "rx_self_ms", "sync_wait_ms", "host_syncs",
                            "bp_launches"},
    "ft8_batch_rx.tiny": {"ft8_results_host_ms", "rx_self_ms",
                          "sync_wait_ms", "host_syncs", "bp_launches"},
}
# blocking reads a batch on the CPU: the header's LDPC ok and bits, and
# each of the 4 (MCS, length) groups' LDPC ok and outer-code input; FT8's
# winners and scores
HOST_SYNCS = {"cofdm_ldpc_bch.tiny": 10, "ft8_batch_rx.tiny": 2}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_with_tiny(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reports_the_program_span_metrics(root, cell):
    listed = {m["name"] for m in harness.load_cell(cell, root)["per_layer"]}
    assert NEW[cell] <= listed
    r = harness.run_cell(cell, 2 ** 33 + 5, 0.3, True, root=root,
                         device="cpu")
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert NEW[cell] <= set(m), sorted(m)
    assert m["host_syncs"] == HOST_SYNCS[cell]
    assert m["bp_launches"] == 0
    assert all(m[k] > 0 for k in NEW[cell] - {"bp_launches"})


def test_a_program_without_the_recorder_reports_none(root, monkeypatch):
    import orion_sdr_tpu_torch
    monkeypatch.delattr(orion_sdr_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "orion_sdr_tpu_torch.obs", None)
    r = harness.run_cell("ft8_batch_rx.tiny", 2 ** 33 + 6, 0.3, True,
                         root=root, device="cpu")
    assert r["correct"]
    assert not NEW["ft8_batch_rx.tiny"] & set(r["metrics"])
    assert "ft8_unpack_host_ms" in r["metrics"]
