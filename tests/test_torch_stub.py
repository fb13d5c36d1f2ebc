"""Torch port: the PEP 561 stub. ``orion_sdr_tpu_torch/py.typed`` marks the
package typed, and ``orion_sdr_tpu_torch/__init__.pyi`` (generated by
tools/gen_stub_torch.py) declares exactly the port's public top-level
names: read with ``ast``, its functions, classes, constants and
subpackage imports are the names ``dir()`` of the package shows on a fresh
import (in a subprocess: a test process has imported more of its
submodules, each of which then shows as a name). Signature
text is not compared (it follows the installed torch). The array
parameters of the host-data entry points are typed as tensors or numpy
arrays."""

import ast
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(ROOT, "orion_sdr_tpu_torch", "__init__.pyi")


def _stub_tree():
    with open(STUB) as f:
        return ast.parse(f.read(), STUB)


def _stub_names():
    names = {}
    for node in _stub_tree().body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] = "class" if isinstance(node, ast.ClassDef) \
                else "function"
        elif isinstance(node, ast.AnnAssign):
            names[node.target.id] = "value"
        elif isinstance(node, ast.ImportFrom) and node.level == 1:
            names.update({a.asname or a.name: "module" for a in node.names})
    return names


# the package's public names and kinds on a fresh import, as the generator
# sees them (a test process has imported more of its submodules)
_PUBLIC = """
import inspect, json, orion_sdr_tpu_torch as P
def kind(o):
    if inspect.ismodule(o): return "module"
    if inspect.isclass(o): return "class"
    return "function" if callable(o) else "value"
print(json.dumps({n: kind(getattr(P, n)) for n in dir(P)
                  if not n.startswith("_")}))
"""


def test_py_typed_marker_is_there():
    assert os.path.isfile(os.path.join(ROOT, "orion_sdr_tpu_torch",
                                       "py.typed"))


def test_stub_declares_the_public_names_with_their_kinds():
    import json
    out = subprocess.run([sys.executable, "-c", _PUBLIC], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    public = json.loads(out.stdout)
    stub = _stub_names()
    assert sorted(set(public) - set(stub)) == []
    assert sorted(set(stub) - set(public)) == []
    assert {n: k for n, k in stub.items() if public[n] != k} == {}


def test_stub_types_array_parameters_as_tensor_or_numpy():
    funcs = {n.name: n for n in _stub_tree().body
             if isinstance(n, ast.FunctionDef)}
    for name, arg in (("zf_equalize", "freq_syms"), ("fm_demod", "iq"),
                      ("soft_demap", "iq"), ("inner_encode", "info_bits")):
        a = next(a for a in funcs[name].args.args if a.arg == arg)
        assert ast.unparse(a.annotation) == "torch.Tensor | numpy.ndarray"
