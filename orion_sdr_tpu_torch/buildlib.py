"""Build a shared library from sources in the checkout, at first use.

Outputs go to ``orion_sdr_tpu_torch/_build/`` (git-ignored), named by a hash
of the compiler command and the source text, so an edited source or flag
never reuses a stale library. The compile writes to a per-process temporary
name and renames it into place, so concurrent test workers can race safely.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from typing import NamedTuple, Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


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
