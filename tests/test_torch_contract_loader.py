"""The loader of the JAX package's tier-1 test files (tests/torch_contracts.py)
holds itself to its own rules, on the CPU: the files it loads are every JAX
test file but the three it names, each in one contract module; it changes
only import lines; every JAX case it leaves out is listed in ``EXCLUDED``
under an admitted reason, names a real test, and has a port test in its
place (every reason-(c) case and every card-only reason-(a) case a twin);
the cases it leaves out on the card are exactly those that name jax or jnp;
and its CPU placement reaches every ``"cuda"`` default and host-data
resolver of the port and restores all of them. It imports no JAX."""

import ast
import importlib
import os
import re

import numpy as np
import pytest
import torch

import orion_sdr_tpu_torch as P
import torch_contract_twins  # noqa: F401  (fills TWINS)
import torch_contracts as C

torch.set_num_threads(1)

ROOT = os.path.dirname(C.HERE)
PORT = os.path.join(ROOT, "orion_sdr_tpu_torch")


def _jax_test_files():
    return sorted(n for n in os.listdir(C.HERE)
                  if n.startswith("test_") and n.endswith(".py")
                  and not n.startswith("test_torch"))


def _defs(name):
    """{test or Test class: its test methods} of a JAX file, by ast."""
    tree = ast.parse((C.HERE / name).read_text())
    out = {}
    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and n.name.startswith("test"):
            out[n.name] = set()
        elif isinstance(n, ast.ClassDef) and n.name.startswith("Test"):
            out[n.name] = {m.name for m in n.body
                           if isinstance(m, ast.FunctionDef)
                           and m.name.startswith("test")}
    return out


def test_the_files_are_every_jax_test_file_but_three():
    assert len(C.FILES) == 42
    assert sorted(C.FILES + C.NOT_LOADED) == _jax_test_files()
    areas = [f for names in C.AREAS.values() for f in names]
    assert sorted(areas) == list(C.FILES)          # each file in one area
    for area in C.AREAS:
        assert os.path.exists(C.HERE / f"test_torch_contracts_{area}.py")


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("name", C.FILES)
def test_only_import_lines_change(name, card):
    src = (C.HERE / name).read_text()
    out = C.rewrite(src, card)
    a, b = src.splitlines(), out.splitlines()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x != y:
            assert re.match(r"\s*(import|from)\s", x), x
    assert not re.search(r"^\s*(import|from)\s+orion_sdr_tpu\b(?!_torch)",
                         out, re.M)
    assert not re.search(r"^\s*from\s+tests\.", out, re.M)
    if card:
        assert not re.search(r"^\s*(import|from)\s+jax", out, re.M)


def test_every_exclusion_names_a_real_case_with_a_reason_and_a_holder():
    for key, out in C.EXCLUDED.items():
        parts = key.split("[")[0].split("::")
        assert parts[0] in C.FILES, key
        defs = _defs(parts[0])
        if len(parts) > 1:
            assert parts[1] in defs, key
        if len(parts) > 2:
            assert parts[2] in defs[parts[1]], key
        assert out.reason in C.REASONS, key
        assert out.why and out.held_by, key
        assert "differ" not in out.why, key      # never "the port differs"
        if out.card:
            assert out.reason == "a", key


def test_every_twin_replaces_an_exclusion_and_every_c_case_has_one():
    assert set(C.TWINS) <= set(C.EXCLUDED)
    need = {k for k, o in C.EXCLUDED.items()
            if o.reason == "c" or o.card}
    assert need <= set(C.TWINS), sorted(need - set(C.TWINS))
    for key in C.TWINS:
        assert "twin" in C.EXCLUDED[key].held_by, key


def test_left_out_on_the_card_are_the_cases_that_name_jax():
    whole = {k for k, o in C.EXCLUDED.items() if "::" not in k}
    naming = {k for f in C.FILES if f not in whole
              for k in C.cases_naming_jax(f)}
    card_only = {k for k, o in C.EXCLUDED.items() if o.card}
    assert card_only == naming
    # the files the card machine cannot even import whole name jax at top
    top = {f for f in C.FILES
           if re.search(r"^(import|from)\s+jax", (C.HERE / f).read_text(),
                        re.M)}
    assert top == {"test_dsp.py", "test_fec_matrix.py",
                   "test_multicarrier_matrix.py", "test_parallel.py",
                   "test_sync_matrix.py"}


def test_excluded_cases_are_not_exported():
    ns = {}
    C.export(ns, ["test_fec_matrix.py", "test_digital.py"])
    names = set(ns["ORIGIN"].values())
    assert "test_fec_matrix.py::test_outer_device_gate_logic" not in names
    assert "test_fec_matrix.py::test_ldpc_code_rule_error_injected" in names
    assert "test_digital.py::test_burst_modem_qam_orders" not in names
    card = {}
    C.export(card, ["test_fec_matrix.py"], card=True)
    assert "test_fec_matrix.py::test_ldpc_code_rule_error_injected" not in \
        set(card["ORIGIN"].values())


def _cuda_defaults():
    """(module, qualname) of every function of the port whose source gives
    a parameter the default ``"cuda"``, nested ones included."""
    found = set()
    for d, _, names in os.walk(PORT):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(d, n)
            mod = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            mod = mod[:-len(".__init__")] if mod.endswith(".__init__") \
                else mod

            def walk(node, prefix):
                for ch in ast.iter_child_nodes(node):
                    if isinstance(ch, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        a = ch.args
                        ds = a.defaults + [x for x in a.kw_defaults if x]
                        if any(isinstance(x, ast.Constant) and
                               x.value == "cuda" for x in ds):
                            found.add((mod, prefix + ch.name))
                        walk(ch, f"{prefix}{ch.name}.<locals>.")
                    elif isinstance(ch, ast.ClassDef):
                        walk(ch, f"{prefix}{ch.name}.")
                    else:
                        walk(ch, prefix)
            with open(path) as f:
                walk(ast.parse(f.read()), "")
    return found


def test_placement_reaches_every_cuda_default_and_resolver():
    sites = C._sites()
    patched = {(o.__module__, o.__qualname__) for o, a, _, _ in sites
               if a in ("__defaults__", "__kwdefaults__")}
    assert patched == _cuda_defaults()
    bound = {(o.__name__, a) for o, a, _, _ in sites
             if a in ("on_device", "_outer_device")}
    for m in C._port_modules():
        for name in ("on_device", "_outer_device"):
            src = getattr(m, "__file__", "") or ""
            if src.endswith(".py") and re.search(
                    rf"^\s*from\s+\S+\s+import\s+[^#\n]*\b{name}\b",
                    open(src).read(), re.M):
                assert (m.__name__, name) in bound, (m.__name__, name)


def test_placement_sends_host_data_to_the_cpu_and_restores_the_port():
    dev = importlib.import_module("orion_sdr_tpu_torch.dsp.device")
    chain = importlib.import_module("orion_sdr_tpu_torch.frame.chain")
    before = [(o, a, getattr(o, a)) for o, a, _, _ in C._sites()]
    real_on, real_outer = dev.on_device, chain._outer_device
    with C.cpu_placement():
        assert dev.on_device(np.zeros(3)).device.type == "cpu"
        assert chain._outer_device(np.zeros(3), None).type == "cpu"
        assert P.util.atan2_approx(np.ones(2), np.ones(2)).device.type == \
            "cpu"
        assert all(getattr(o, a) is cpu for o, a, _, cpu in C._sites())
        assert "cuda" not in P.gps_acquire.__defaults__
    after = [(o, a, getattr(o, a)) for o, a, _, _ in C._sites()]
    assert all(x[2] is y[2] for x, y in zip(before, after))
    assert dev.on_device is real_on and chain._outer_device is real_outer
    # the port asks for the card again: numpy input resolves to "cuda"
    asked = []
    real = dev.on_device

    def spy(x, device=None, dtype=None):
        if device is None and not isinstance(x, torch.Tensor):
            asked.append("cuda")
            device = "cpu"
        return real(x, device, dtype)
    dev.on_device = spy
    try:
        P.util.atan2_approx(np.ones(2), np.ones(2))
    finally:
        dev.on_device = real
    assert asked == ["cuda", "cuda"]          # y and x
