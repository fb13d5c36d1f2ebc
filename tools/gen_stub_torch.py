"""Generate orion_sdr_tpu_torch/__init__.pyi, the PEP 561 stub of the torch
port's flat namespace, from runtime introspection: classes with their
method signatures, functions with full signatures, module-level constants
and the subpackages. Array parameters (annotated ``torch.Tensor``, or one
of the data names below) are typed ``torch.Tensor | numpy.ndarray``: every
entry point takes host data as the JAX package's does.

Run: python3 tools/gen_stub_torch.py
"""
import ast
import inspect
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import orion_sdr_tpu_torch as sdr  # noqa: E402

ARRAY = "torch.Tensor | numpy.ndarray"
# unannotated parameters that carry signal, bit or LLR data
DATA_NAMES = {
    "iq", "x", "z", "audio", "bits", "llr", "llrs", "coded_llrs",
    "coded_bits", "info_bits", "message_bits", "syms", "symbols", "tones",
    "freq", "freq_syms", "estimate", "data_tones", "windows", "frames",
    "left", "right", "key_env", "soft", "soft_pairs", "wf", "samples",
}

HEADER = '''"""Type stub for the orion_sdr_tpu_torch flat namespace (PEP 561).

Generated by tools/gen_stub_torch.py; regenerate after changing the public
API. Array parameters are `torch.Tensor | numpy.ndarray`: a tensor stays on
its device, host data goes to the card unless `device` says otherwise.
Results are tensors where the JAX package returns jax arrays. IQ is
complex64, audio float32, bits uint8, LLRs float32 with positive => bit 0.
"""
from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

import numpy
import torch

'''


def _default(v) -> str:
    text = repr(v)
    try:
        ast.parse(text, mode="eval")
    except SyntaxError:
        return "..."
    return text


def _param(p: inspect.Parameter) -> str:
    ann = p.annotation
    if ann is not inspect.Parameter.empty:
        ann = ann if isinstance(ann, str) else getattr(ann, "__name__",
                                                       str(ann))
        if "Tensor" in ann:
            ann = ARRAY
    elif p.name in DATA_NAMES:
        ann = ARRAY
    else:
        ann = None
    text = p.name if ann is None else f"{p.name}: {_ann(ann)}"
    if p.default is not inspect.Parameter.empty:
        text += f" = {_default(p.default)}"
    return text


def _ann(ann: str) -> str:
    """An annotation as stub text, quoted unless it is the array union."""
    return ann if ann == ARRAY else repr(ann)


def sig_of(fn) -> str:
    try:
        sig = inspect.signature(fn)
    except (ValueError, TypeError):
        return "(*args, **kwargs)"
    parts, star = [], False
    for p in sig.parameters.values():
        if p.kind is p.VAR_POSITIONAL:
            parts.append(f"*{p.name}")
            star = True
        elif p.kind is p.VAR_KEYWORD:
            parts.append(f"**{p.name}")
        elif p.kind is p.KEYWORD_ONLY:
            if not star:
                parts.append("*")
                star = True
            parts.append(_param(p))
        elif p.kind is p.POSITIONAL_ONLY:
            parts.append(_param(p))
        else:
            parts.append(_param(p))
    if any(p.kind is p.POSITIONAL_ONLY for p in sig.parameters.values()):
        last = max(i for i, p in enumerate(sig.parameters.values())
                   if p.kind is p.POSITIONAL_ONLY)
        parts.insert(last + 1, "/")
    return f"({', '.join(parts)}) -> Any"


def emit_class(name, cls, out):
    out.append(f"class {name}:")
    body = []
    for fname in getattr(cls, "__dataclass_fields__", {}) or {}:
        body.append(f"    {fname}: Any")
    for mname, m in sorted(vars(cls).items()):
        if mname.startswith("_") and mname != "__init__":
            continue
        if isinstance(m, classmethod):
            body += ["    @classmethod",
                     f"    def {mname}{sig_of(m.__func__)}: ..."]
        elif isinstance(m, staticmethod):
            body += ["    @staticmethod",
                     f"    def {mname}{sig_of(m.__func__)}: ..."]
        elif isinstance(m, property):
            body += ["    @property", f"    def {mname}(self) -> Any: ..."]
        elif inspect.isfunction(m):
            body.append(f"    def {mname}{sig_of(m)}: ...")
    out.extend(body or ["    ..."])
    out.append("")


def render() -> str:
    out = [HEADER]
    consts, funcs, classes, mods = [], [], [], []
    for name in sorted(dir(sdr)):
        if name.startswith("_"):
            continue
        obj = getattr(sdr, name)
        if isinstance(obj, types.ModuleType):
            mods.append((name, obj))
        elif inspect.isclass(obj):
            classes.append((name, obj))
        elif callable(obj):
            funcs.append((name, obj))
        else:
            consts.append((name, obj))
    for name, mod in mods:
        sub = mod.__name__.rsplit(".", 1)[-1]
        out.append(f"from . import {sub} as {name}")
    out.append("")
    for name, v in consts:
        t = type(v).__name__ if isinstance(v, (bool, int, float, str)) \
            else "dict" if isinstance(v, dict) else "Any"
        out.append(f"{name}: {t}")
    out.append("")
    for name, f in funcs:
        out.append(f"def {name}{sig_of(f)}: ...")
    out.append("")
    for name, cls in classes:
        emit_class(name, cls, out)
    text = "\n".join(out) + "\n"
    ast.parse(text)
    return text


def main():
    path = os.path.join(ROOT, "orion_sdr_tpu_torch", "__init__.pyi")
    text = render()
    with open(path, "w") as fh:
        fh.write(text)
    print(f"wrote {os.path.relpath(path, ROOT)}: {text.count(chr(10))} "
          f"lines")


if __name__ == "__main__":
    main()
