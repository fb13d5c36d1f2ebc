"""Host BCH and Reed–Solomon encoders/decoders from the port's native C++
source (``orion_native.cpp`` beside this file: batch LFSR encode,
Berlekamp–Massey + Chien (+ Forney for RS) decode), built with g++ at first
use into the port's build directory and bound with ctypes.

The source is the port's own copy of the JAX package's ``native/
orion_native.cpp``, kept byte for byte equal to it (a test holds the two
together); nothing of that package is read or imported.

``AVAILABLE`` (the JAX package's name) is True when the library builds and
loads. The JAX package builds at import; the port probes on the first read
of ``AVAILABLE`` (one g++ run, or the cached library) and keeps the answer,
so importing the port never runs the compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..buildlib import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "orion_native.cpp")

_lib = None


def load() -> ctypes.CDLL:
    """Build (once) and load the native library; raises if g++ fails."""
    global _lib
    if _lib is None:
        built = build_shared("orion_native", ["g++", "-O3", "-shared", "-fPIC",
                                              "-std=c++17", "-pthread"], [_SRC])
        lib = ctypes.CDLL(built.path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.bch_decode_batch.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, u8p, ctypes.c_int,
                                         u8p, u8p]
        lib.bch_decode_batch.restype = None
        lib.bch_encode_batch.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, u8p, ctypes.c_int, u8p]
        lib.bch_encode_batch.restype = None
        lib.rs_decode_batch.argtypes = [ctypes.c_int, ctypes.c_int, u8p,
                                        ctypes.c_int, u8p, u8p]
        lib.rs_decode_batch.restype = None
        lib.rs_encode_batch.argtypes = [ctypes.c_int, ctypes.c_int, u8p,
                                        ctypes.c_int, u8p]
        lib.rs_encode_batch.restype = None
        _lib = lib
    return _lib


_available = None


def __getattr__(name):
    global _available
    if name == "AVAILABLE":
        if _available is None:
            try:
                load()
                _available = True
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _available = False
        return _available
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + ["AVAILABLE"])


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def bch_decode_batch(n: int, k: int, t: int, received_bits: np.ndarray):
    """(B, n) bit codewords → ((B, k) message bits, (B,) ok flags); failed
    rows hold the systematic prefix."""
    if t > 16:
        raise ValueError("the native BCH decoder supports t <= 16")
    r = np.ascontiguousarray(received_bits, np.uint8)
    if r.ndim != 2 or r.shape[1] != n:
        raise ValueError(f"expected (B, {n}) bits, got {r.shape}")
    out = np.empty((r.shape[0], k), np.uint8)
    ok = np.empty(r.shape[0], np.uint8)
    load().bch_decode_batch(n, k, t, _ptr(r), r.shape[0], _ptr(out), _ptr(ok))
    return out, ok.astype(bool)


def bch_encode_batch(n: int, k: int, t: int, message_bits: np.ndarray):
    """(B, k) bit messages → (B, n) systematic BCH codewords."""
    m = np.ascontiguousarray(message_bits, np.uint8)
    if m.ndim != 2 or m.shape[1] != k:
        raise ValueError(f"expected (B, {k}) bits, got {m.shape}")
    out = np.empty((m.shape[0], n), np.uint8)
    load().bch_encode_batch(n, k, t, _ptr(m), m.shape[0], _ptr(out))
    return out


def rs_decode_batch(n: int, n_parity: int, received: np.ndarray):
    """(B, n) byte codewords → ((B, n − n_parity) messages, (B,) ok flags);
    failed rows hold the systematic prefix."""
    if n_parity > 64:
        raise ValueError("the native RS decoder supports n_parity <= 64")
    r = np.ascontiguousarray(received, np.uint8)
    if r.ndim != 2 or r.shape[1] != n:
        raise ValueError(f"expected (B, {n}) bytes, got {r.shape}")
    out = np.empty((r.shape[0], n - n_parity), np.uint8)
    ok = np.empty(r.shape[0], np.uint8)
    load().rs_decode_batch(n, n_parity, _ptr(r), r.shape[0], _ptr(out),
                           _ptr(ok))
    return out, ok.astype(bool)


def rs_encode_batch(n: int, n_parity: int, messages: np.ndarray):
    """(B, n − n_parity) byte messages → (B, n) systematic codewords (FCR=0
    generator)."""
    m = np.ascontiguousarray(messages, np.uint8)
    if m.ndim != 2 or m.shape[1] != n - n_parity:
        raise ValueError(f"expected (B, {n - n_parity}) bytes, got {m.shape}")
    out = np.empty((m.shape[0], n), np.uint8)
    load().rs_encode_batch(n, n_parity, _ptr(m), m.shape[0], _ptr(out))
    return out
