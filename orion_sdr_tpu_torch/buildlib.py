"""Build a shared library from sources in the checkout, at first use.

Outputs go to ``orion_sdr_tpu_torch/_build/`` (git-ignored), named by a hash
of the compiler command and the source text, so an edited source or flag
never reuses a stale library. The compile writes to a per-process temporary
name and renames it into place, so concurrent test workers can race safely.

:class:`CudaLib` is one hand-written kernel library: ``csrc/<name>.cu``
built with nvcc for ``sm_90a`` at first use, loaded by ctypes, and called on
the current stream with its CUDA error checked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple, Sequence

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# -fmad=false: no fused multiply-add contraction, so the kernel's float
# arithmetic rounds exactly like the plain version's separate tensor ops
NVCC_FLAGS_NO_FMA = NVCC_FLAGS + ["-fmad=false"]
# ctypes argument types of the kernels' C entry points
PTR, INT, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float


class Built(NamedTuple):
    path: str
    log: str          # compiler stdout + stderr (kept beside the library)
    seconds: float    # compile time (0.0 when reused)


def build_shared(name: str, cmd: Sequence[str], sources: Sequence[str],
                 timeout: float = 600.0) -> Built:
    """Compile ``sources`` with ``cmd`` (compiler and flags, without ``-o``
    or sources) into a shared library, or reuse the one already built.
    Raises RuntimeError with the compiler's output when the build fails."""
    h = hashlib.sha256("\0".join(cmd).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        log = ""
        if os.path.exists(f"{path}.log"):
            with open(f"{path}.log") as f:
                log = f.read()
        return Built(path, log, 0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(list(cmd) + ["-o", tmp] + list(sources),
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", f"{path}.log")
    os.replace(tmp, path)
    return Built(path, log, time.perf_counter() - t0)


class CudaLib:
    """The kernel library ``csrc/<name>.cu``, compiled with ``flags`` at
    first use. ``argtypes`` maps each exported function to its ctypes
    argument types; every one returns a CUDA error code (int)."""

    def __init__(self, name: str, flags: Sequence[str],
                 argtypes: dict[str, list]):
        self.name, self.flags, self.argtypes = name, list(flags), argtypes
        self.src = os.path.join(_PKG, "csrc", f"{name}.cu")
        self.lib = None
        self.built: Built | None = None

    def build(self) -> Built:
        """Compile (once per process) and load. Returns the build record;
        its log holds the ``-Xptxas -v`` report."""
        if self.lib is None:
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            self.built = build_shared(self.name, [nvcc] + self.flags,
                                      [self.src])
            lib = ctypes.CDLL(self.built.path)
            for fn, types in self.argtypes.items():
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
            self.lib = lib
        return self.built

    def call(self, fn: str, device, *args) -> None:
        """``fn(*args)`` with ``device`` current; raises RuntimeError on a
        CUDA error."""
        self.build()
        with torch.cuda.device(device):
            err = getattr(self.lib, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{fn} failed: CUDA error {err}")

    def launch(self, fn: str, device, *args) -> None:
        """``fn(*args, stream)`` on ``device``'s current stream; raises
        RuntimeError on a CUDA error."""
        self.build()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(self.lib, fn)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
