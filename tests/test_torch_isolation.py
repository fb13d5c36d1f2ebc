"""The port stands alone: it builds its native host library from its own
source, imports nothing of the JAX package (nor JAX; nor do chip_smoke.py,
tools/torch_distributed_smoke.py, tools/gen_stub_torch.py, the thirteen
examples under examples/torch/, and the helpers and card files that run
on a card machine: the sweeps', tests/torch_sweeps.py and
tests/test_torch_perf_sweeps.py, and the JAX tier-1 contracts' loader,
twins, contract modules and card file, tests/torch_contracts.py,
tests/torch_contract_twins.py and tests/test_torch_contracts_*.py; and
the kernels' memory-safety harness and its card file,
tests/torch_kernel_safety.py and tests/test_torch_kernel_safety_gpu.py),
and its top level carries the JAX package's names of the modules it has ported. Runs on the
CPU: it reads the sources with ``ast``, imports no JAX module for the
check, and builds nothing."""

import ast
import filecmp
import os

import pytest
import torch

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import native

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "orion_sdr_tpu_torch")
JAX_PKG = os.path.join(ROOT, "orion_sdr_tpu")


def test_native_source_is_the_ports_own_copy():
    src = os.path.realpath(native._SRC)
    assert os.path.commonpath([src, os.path.realpath(PORT)]) == \
        os.path.realpath(PORT)
    assert os.path.basename(src) == "orion_native.cpp"
    assert filecmp.cmp(src, os.path.join(JAX_PKG, "native",
                                         "orion_native.cpp"), shallow=False)


def _imports(path):
    """Every module name ``path`` imports, relative ones resolved against
    its package."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    pkg = os.path.relpath(path, ROOT)[:-3].split(os.sep)[:-1]
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out.append(mod)
    return out


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "torch_distributed_smoke.py"),
             os.path.join(ROOT, "tools", "gen_stub_torch.py"),
             os.path.join(ROOT, "tests", "torch_sweeps.py"),
             os.path.join(ROOT, "tests", "test_torch_perf_sweeps.py"),
             os.path.join(ROOT, "tests", "torch_contracts.py"),
             os.path.join(ROOT, "tests", "torch_contract_twins.py"),
             os.path.join(ROOT, "tests", "torch_kernel_safety.py"),
             os.path.join(ROOT, "tests", "test_torch_kernel_safety_gpu.py")]
    tests = os.path.join(ROOT, "tests")
    files += [os.path.join(tests, n) for n in os.listdir(tests)
              if n.startswith("test_torch_contracts_") and n.endswith(".py")]
    for top in (PORT, os.path.join(ROOT, "examples", "torch")):
        for d, _, names in os.walk(top):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_the_ports_examples_are_all_checked():
    ex = [p for p in _sources() if os.sep + "examples" + os.sep in p]
    assert len(ex) == 13


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "orion_sdr_tpu")]
    assert not bad, bad


# the JAX package's top-level names of the modules slice 6a ported
SLICE_6A = ("io", "channel", "classify", "codec.morse", "codec.adsb",
            "modulate.adsb", "demodulate.adsb", "modulate.sstv",
            "demodulate.sstv")


def jax_names(modules):
    """Names ``orion_sdr_tpu/__init__.py`` imports from ``modules`` (read
    with ast, not imported)."""
    with open(os.path.join(JAX_PKG, "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            if node.module in modules:
                names += [a.asname or a.name for a in node.names]
            elif node.module is None:
                names += [a.name for a in node.names if a.name in modules]
    return names


def test_top_level_has_the_slices_names():
    names = jax_names(SLICE_6A)
    assert len(names) == 37
    assert [n for n in names if not hasattr(P, n)] == []
