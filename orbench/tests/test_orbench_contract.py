"""BENCHMARK.json against the benchmark's contract, every part found by
name, and the isolation of the benchmark from JAX and of its yardstick
from the program."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from tiny import ROOT, copy_with_tiny

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["orbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + CELLS + [m["name"] for m in METRICS])
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        assert 1 <= len(metric["layer"]) <= 200
        assert "\n" not in metric["layer"] and "\t" not in metric["layer"]
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for c in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if c in m.get("workloads", CELLS)]
        layer = [m for m in BENCH["per_layer"]
                 if c in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, c
        for m in layer:
            assert m["moves"] in e2e


def test_one_pair_of_config_and_traffic_a_cell_and_one_chip():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert all(1 <= len(w["why"]) <= 200 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_part_of_a_cell_is_found_by_name(cell):
    sys.path.insert(0, ROOT)
    from orbench import harness
    c = harness.load_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (c["config"], c["traffic"]) == (w["config"], w["traffic"])
    for kind in ("traffic", "entries", "checks"):
        name = c[{"traffic": "generator", "entries": "entry",
                  "checks": "check"}[kind]]
        assert os.path.exists(os.path.join(ROOT, "orbench", kind,
                                           f"{name}.py"))
    for m in c["end_to_end"] + c["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "orbench", "metrics",
                                           f"{m['name']}.py"))
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("orbench/configs/")
    body = json.load(open(os.path.join(ROOT, config["file"])))
    assert body["name"] == config["name"]
    assert body["source"] == config["source"]
    assert 1 <= len(config["source"]) <= 200
    assert config["reduced"] == []


def test_a_cell_added_as_files_is_found_with_no_edit(tmp_path):
    root = copy_with_tiny(str(tmp_path))
    code = ("from orbench import harness; "
            "c = harness.load_cell('ft8_batch_rx.tiny'); "
            "print(c['config'], c['params']['windows'], "
            "[m['name'] for m in c['end_to_end']])")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:2] == ["ft8_batch_rx", "4"]
    assert "batch_p95_ms" in out.stdout


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(os.path.relpath(os.path.join(d, f), ROOT)
                 for d, _, fs in os.walk(os.path.join(ROOT, "orbench"))
                 for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("path", MODULES)
def test_no_module_imports_jax_or_the_jax_package(path):
    found = set(_imports(os.path.join(ROOT, path)))
    assert not found & {"jax", "jaxlib", "flax", "orion_sdr_tpu"}, path


@pytest.mark.parametrize("path", [m for m in MODULES if m.split(os.sep)[1]
                                  in ("reference", "checks", "traffic")])
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "orion_sdr_tpu_torch" not in set(_imports(os.path.join(ROOT,
                                                                  path)))
