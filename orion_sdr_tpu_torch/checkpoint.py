"""Checkpoint / resume of streaming receiver state (counterpart of
``orion_sdr_tpu/checkpoint.py``): any streaming receiver (``Psk31Stream``,
``Ft8StreamDecoder``, ``OfdmFrameStreamDemod``, ``DvbTFrameStreamDemod``,
the band receivers, the ``blocks.py`` classes, …) is snapshotted to one
``.npz`` file and resumed in a fresh process, with decode output identical
to an uninterrupted run.

A checkpoint is a reflective walk of the receiver's ``__dict__``, in the JAX
package's layout (a JSON header in ``__header__``, arrays under ``a:<dotted
path>``, format version ``_FMT_VERSION``):

* ``np.ndarray``             → an npz array entry
* ``torch.Tensor``           → an npz array entry (a host copy; views are
  copied out whole), tagged with its torch dtype. On load it goes to the
  device of the tensor it replaces in the freshly built target, or, where
  the target holds none there yet (a filter state first made by
  ``process()``), to the ``device`` of the nearest enclosing object. So a
  checkpoint taken on the card resumes on the CPU and the other way round.
* ``torch.device`` attributes → neither stored nor fingerprinted: they are
  how the target was built, not what it has seen
* numpy scalars              → their value and dtype (restored as that
  numpy type; the carried phases of the port are float32 scalars)
* scalars / str / None       → the JSON header; complex as ``[re, im]``
* NamedTuple states (``QuadDemodState``, ``CwState``, …) → their items,
  rebuilt as the same NamedTuple class of this package
* deque / list / tuple, dicts with int or str keys → JSON containers
* frozen dataclasses (``OfdmConfig``, ``DvbTFrameParams``,
  ``OfdmPreamble``, ``McsTable``, ``LdpcGraph``, …) → not stored: they are
  construction-time configuration. Their ``repr`` (arrays and tensors by a
  digest of their bytes) enters a fingerprint checked on load, so
  resuming into a receiver built with another configuration raises.
* tables derived from the configuration → fingerprinted, not stored:
  ``Channelizer``'s ``_f`` (its centers as a device tensor), ``taps`` and
  ``centers_hz``; ``StreamingViterbi``'s trellis tables ``_pred``,
  ``_trans_dibit``, ``_exp``. Graph tables, tone matrices, carrier grids,
  launch plans and built kernels live in process-wide caches or are
  rebuilt per call, not held by the receivers, so nothing of them is
  walked.
* other objects with ``__dict__`` → recursed as nested state; anything
  else raises TypeError naming its path.

``load_state_dict`` restores in place into an object constructed with the
same configuration. A file written by the JAX package is not read here:
its fingerprints are reprs of that package's classes; state crosses
packages through ``convert.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import io
import json
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

_FMT_VERSION = 1

_SCALARS = (bool, int, float, str)

# class name → attributes that are derived from the configuration:
# fingerprinted, never stored, left as constructed on load
_DERIVED = {
    "Channelizer": ("_f", "taps", "centers_hz"),
    "StreamingViterbi": ("_pred", "_trans_dibit", "_exp"),
}

_PACKAGE = __name__.rsplit(".", 1)[0]


def _is_frozen_config(v: Any) -> bool:
    return (dataclasses.is_dataclass(v) and not isinstance(v, type)
            and v.__dataclass_params__.frozen)


def _is_namedtuple(v: Any) -> bool:
    return isinstance(v, tuple) and hasattr(type(v), "_fields")


def _host_array(t: torch.Tensor) -> np.ndarray:
    return np.array(t.detach().resolve_conj().resolve_neg().cpu().numpy(),
                    copy=True)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def _config_repr(v: Any) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_config_repr(x) for x in v) + "]"
    if isinstance(v, torch.Tensor):
        a = _host_array(v)
        return f"tensor({v.dtype},{tuple(a.shape)},{_digest(a)})"
    if isinstance(v, np.ndarray):
        # repr truncates large arrays: digest the raw bytes instead
        return f"ndarray({v.dtype},{v.shape},{_digest(v)})"
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        fields = ",".join(f"{f.name}={_config_repr(getattr(v, f.name))}"
                          for f in dataclasses.fields(v))
        return f"{type(v).__name__}({fields})"
    return repr(v)


def _encode(v: Any, path: str, arrays: Dict[str, np.ndarray],
            fingerprint: "hashlib._Hash") -> Any:
    """→ JSON-able meta node; arrays collected into ``arrays`` by path."""
    if v is None or isinstance(v, _SCALARS):
        return v
    if isinstance(v, np.generic):
        val = ([float(v.real), float(v.imag)]
               if np.iscomplexobj(v) else v.item())
        return {"__np__": v.dtype.str, "v": val}
    if isinstance(v, complex):
        return {"__complex__": [float(v.real), float(v.imag)]}
    if isinstance(v, torch.Tensor):
        arrays[path] = _host_array(v)
        return {"__tensor__": path, "dtype": str(v.dtype).split(".")[-1]}
    if isinstance(v, np.ndarray):
        arrays[path] = v
        return {"__array__": path}
    if _is_namedtuple(v):
        cls = type(v)
        return {"__namedtuple__": f"{cls.__module__}:{cls.__qualname__}",
                "items": [_encode(x, f"{path}.{i}", arrays, fingerprint)
                          for i, x in enumerate(v)]}
    if isinstance(v, (list, tuple, deque)):
        if (not isinstance(v, deque) and v
                and all(_is_frozen_config(x) for x in v)):
            fingerprint.update(f"{path}={_config_repr(v)}".encode())
            return {"__config__": f"seq[{type(v[0]).__name__}]"}
        kind = ("deque" if isinstance(v, deque)
                else "tuple" if isinstance(v, tuple) else "list")
        return {"__seq__": kind,
                "items": [_encode(x, f"{path}.{i}", arrays, fingerprint)
                          for i, x in enumerate(v)]}
    if isinstance(v, dict):
        int_keys = all(isinstance(k, (int, np.integer)) for k in v)
        items = {str(k): _encode(x, f"{path}.{k}", arrays, fingerprint)
                 for k, x in v.items()}
        return {"__dict__": items, "int_keys": bool(int_keys and v)}
    if _is_frozen_config(v):
        fingerprint.update(f"{path}={_config_repr(v)}".encode())
        return {"__config__": type(v).__name__}
    if hasattr(v, "__dict__") and not callable(v):
        return {"__object__": type(v).__name__,
                "state": _encode_obj(v, path, arrays, fingerprint)}
    raise TypeError(
        f"checkpoint: cannot serialize {type(v).__name__!r} at {path!r}")


def _encode_obj(obj: Any, path: str, arrays: Dict[str, np.ndarray],
                fingerprint: "hashlib._Hash") -> Dict[str, Any]:
    derived = _DERIVED.get(type(obj).__name__, ())
    out = {}
    for name, v in vars(obj).items():
        node_path = f"{path}.{name}" if path else name
        if isinstance(v, torch.device):
            continue
        if name in derived:
            fingerprint.update(f"{node_path}={_config_repr(v)}".encode())
            continue
        out[name] = _encode(v, node_path, arrays, fingerprint)
    return out


def _namedtuple_class(name: str, current: Any):
    if current is not None and _is_namedtuple(current):
        cls = type(current)
        if f"{cls.__module__}:{cls.__qualname__}" == name:
            return cls
    module, qualname = name.split(":")
    if module != _PACKAGE and not module.startswith(_PACKAGE + "."):
        raise ValueError(f"checkpoint: state class {name!r} is not one of "
                         f"{_PACKAGE}'s")
    cls = importlib.import_module(module)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    return cls


def _decode(meta: Any, arrays: Dict[str, np.ndarray], current: Any,
            device: Optional[torch.device]) -> Any:
    if meta is None or isinstance(meta, _SCALARS):
        return meta
    if isinstance(meta, dict):
        if "__np__" in meta:
            t = np.dtype(meta["__np__"]).type
            v = meta["v"]
            return t(complex(*v)) if isinstance(v, list) else t(v)
        if "__complex__" in meta:
            re, im = meta["__complex__"]
            return complex(re, im)
        if "__tensor__" in meta:
            dev = current.device if isinstance(current, torch.Tensor) \
                else (device or torch.device("cpu"))
            return torch.as_tensor(arrays[meta["__tensor__"]]).to(
                device=dev, dtype=getattr(torch, meta["dtype"]))
        if "__array__" in meta:
            return arrays[meta["__array__"]]
        if "__namedtuple__" in meta:
            cls = _namedtuple_class(meta["__namedtuple__"], current)
            cur = (list(current) if _is_namedtuple(current)
                   and len(current) == len(meta["items"])
                   else [None] * len(meta["items"]))
            return cls._make(_decode(m, arrays, c, device)
                             for m, c in zip(meta["items"], cur))
        if "__seq__" in meta:
            # per-item counterparts go through sequences, so nested objects
            # (a band receiver's per-channel streams) restore into the
            # freshly constructed target's instances
            if (isinstance(current, (list, tuple, deque))
                    and len(current) == len(meta["items"])):
                cur = list(current)
            else:
                cur = [None] * len(meta["items"])
            items = [_decode(m, arrays, c, device)
                     for m, c in zip(meta["items"], cur)]
            if meta["__seq__"] == "deque":
                return deque(items)
            if meta["__seq__"] == "tuple":
                return tuple(items)
            return items
        if "__dict__" in meta:
            conv = int if meta.get("int_keys") else str
            cur = current if isinstance(current, dict) else {}
            return {conv(k): _decode(m, arrays, cur.get(conv(k)), device)
                    for k, m in meta["__dict__"].items()}
        if "__config__" in meta:
            return current                     # configs stay as constructed
        if "__object__" in meta:
            if current is None or not hasattr(current, "__dict__"):
                raise ValueError(
                    "checkpoint: nested object "
                    f"{meta['__object__']!r} has no counterpart in the "
                    "target: construct the receiver with the same "
                    "configuration before loading")
            _restore_obj(current, meta["state"], arrays, device)
            return current
    raise TypeError(f"checkpoint: malformed meta node {meta!r}")


def _restore_obj(obj: Any, state: Dict[str, Any],
                 arrays: Dict[str, np.ndarray],
                 device: Optional[torch.device] = None) -> None:
    own = getattr(obj, "device", None)
    if isinstance(own, torch.device):
        device = own
    for name, meta in state.items():
        if name not in vars(obj):
            raise ValueError(
                f"checkpoint: target {type(obj).__name__} has no attribute "
                f"{name!r}: was it built with the same configuration?")
        setattr(obj, name, _decode(meta, arrays, getattr(obj, name), device))


def _fingerprint(obj: Any, arrays: Dict[str, np.ndarray]):
    fp = hashlib.sha256(type(obj).__name__.encode())
    meta = _encode_obj(obj, "", arrays, fp)
    return fp.hexdigest(), meta


def state_dict(obj: Any) -> Dict[str, Any]:
    """Snapshot a streaming receiver's mutable state: ``{"class",
    "fingerprint", "meta", "arrays"}``, ``meta`` a JSON-able tree and
    ``arrays`` dotted paths → host numpy arrays (tensors copied out)."""
    arrays: Dict[str, np.ndarray] = {}
    fp, meta = _fingerprint(obj, arrays)
    return {"class": type(obj).__name__, "fingerprint": fp, "meta": meta,
            "arrays": arrays}


def load_state_dict(obj: Any, state: Dict[str, Any]) -> Any:
    """Restore ``state_dict`` output into ``obj`` in place (and return it).
    ``obj`` must be freshly constructed with the same configuration: the
    class name and the configuration fingerprint are checked and a
    mismatch raises ValueError. Tensors land on ``obj``'s devices."""
    if state["class"] != type(obj).__name__:
        raise ValueError(
            f"checkpoint: saved state is for {state['class']!r}, "
            f"target is {type(obj).__name__!r}")
    fp, _ = _fingerprint(obj, {})
    if fp != state["fingerprint"]:
        raise ValueError(
            "checkpoint: configuration fingerprint mismatch: the target "
            f"{type(obj).__name__} was constructed with different "
            "parameters than the checkpointed receiver")
    _restore_obj(obj, state["meta"], state["arrays"])
    return obj


def save_checkpoint(path: str, obj: Any) -> None:
    """Write a streaming receiver's state to one ``.npz`` file."""
    st = state_dict(obj)
    header = json.dumps({"version": _FMT_VERSION, "class": st["class"],
                         "fingerprint": st["fingerprint"],
                         "meta": st["meta"]})
    buf = io.BytesIO()
    np.savez(buf, __header__=np.frombuffer(header.encode(), np.uint8),
             **{f"a:{k}": v for k, v in st["arrays"].items()})
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_checkpoint(path: str, obj: Any) -> Any:
    """Load a ``save_checkpoint`` file into a same-config receiver."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header.get("version") != _FMT_VERSION:
            raise ValueError(
                f"checkpoint: unsupported format version "
                f"{header.get('version')!r}")
        arrays = {k[2:]: z[k] for k in z.files if k.startswith("a:")}
    return load_state_dict(obj, {"class": header["class"],
                                 "fingerprint": header["fingerprint"],
                                 "meta": header["meta"],
                                 "arrays": arrays})
