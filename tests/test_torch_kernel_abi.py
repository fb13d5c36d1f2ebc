"""The port's kernel libraries: each ctypes declaration in
``ops/*.py`` against the C entry point in ``csrc/*.cu`` it calls.

A wrapper passes every argument of the C function through ctypes, the
launch appending the stream. An argtypes list one short lets ctypes pass
the last argument as a C int, which cuts a 64-bit pointer, so the count of
each list must equal the function's parameter count and each pointer
parameter must be declared a pointer. Runs on the CPU (no card, no nvcc):
it reads the sources."""

import ctypes
import importlib
import re

import pytest
import torch

from orion_sdr_tpu_torch.buildlib import CudaLib, F32, I64, INT, PTR

torch.set_num_threads(1)

MODULES = ["ldpc_bp", "viterbi", "outer_fec", "psk31_pll", "onepole_two_rate",
           "dd_pll", "gardner", "gnss_track", "psk31_viterbi"]


def _libs():
    out = []
    for name in MODULES:
        mod = importlib.import_module(f"orion_sdr_tpu_torch.ops.{name}")
        out += [v for v in vars(mod).values() if isinstance(v, CudaLib)]
    return out


def _c_params(src: str, fn: str):
    m = re.search(r'extern\s+"C"\s+int\s+' + fn + r'\s*\(([^)]*)\)', src)
    assert m, fn
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


def _ctype(param: str):
    if "*" in param:
        return PTR
    if "int64_t" in param or "long long" in param:
        return I64
    if re.match(r"(const\s+)?float\b", param):
        return F32
    return INT


def _declared(t):
    """A declared argtype, with typed pointers read as pointers."""
    return PTR if isinstance(t, type) and issubclass(t, ctypes._Pointer) \
        else t


@pytest.mark.parametrize("lib", _libs(), ids=lambda lib: lib.name)
def test_argtypes_match_the_c_entry_points(lib):
    with open(lib.src) as f:
        src = f.read()
    assert lib.argtypes
    for fn, types in lib.argtypes.items():
        params = _c_params(src, fn)
        assert [_ctype(p) for p in params] == [_declared(t) for t in types], \
            fn
