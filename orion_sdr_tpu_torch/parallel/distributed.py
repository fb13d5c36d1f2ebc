"""Across processes: process-aware meshes, link metrics summed over the
mesh and across processes, and the scaling harness (counterpart of
``orion_sdr_tpu/parallel/distributed.py``).

Inside a process the shards of a :class:`~.mesh.Mesh` are driven by that
process (``mesh.py``); across processes ``torch.distributed`` carries the
reductions. A process mesh is host-major, (processes, local devices): row
h lists process h's shards, and each process computes on its own row and
``all_reduce``s the result. The default backend is gloo: the reductions
here are scalars and one spectrum, and gloo runs wherever the processes
do, several of them on one card included (NCCL refuses two ranks on one
GPU).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from .mesh import Mesh, psum, shard, synchronize
from .sharding import as_tensor


def _dist():
    import torch.distributed as dist
    return dist


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join ``num_processes`` processes in one ``torch.distributed`` group:
    False (nothing to do) for one process, True once the group is up.
    ``coordinator`` is "host:port" (a TCP rendezvous at that address, as the
    JAX package's coordinator address) or an init method URL
    ("tcp://...", "file://..."); ``backend`` defaults to "gloo"."""
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator is None:
        raise ValueError("init_distributed needs a coordinator address")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    _dist().init_process_group(backend=backend or "gloo", init_method=url,
                               world_size=int(num_processes),
                               rank=int(process_id))
    return True


def _processes():
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_process_mesh(axis_names=("host", "chip"), shape=None,
                      devices=None) -> Mesh:
    """Host-major mesh: axis 0 the processes, axis 1 each process's
    ``devices`` (default every CUDA device; raises when there is none).
    On one process it is (1, n_local); ``shape`` refolds it."""
    from .sharding import make_mesh
    local = list(make_mesh(devices=devices).devices.reshape(-1))
    rank, world = _processes()
    if shape is None:
        shape = (world, len(local))
    return Mesh(np.asarray(local * world, dtype=object).reshape(shape),
                axis_names, process_index=rank, process_count=world)


def _local_rows(x: torch.Tensor, mesh: Mesh):
    """(this process's rows of ``x``'s leading axis, its local mesh):
    the leading axis splits host-major over every shard of the mesh."""
    if mesh.process_count <= 1:
        return x, mesh
    per = x.shape[0] // mesh.process_count
    r = mesh.process_index
    return x[r * per:(r + 1) * per], mesh.local()


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the processes of a process mesh (a host copy through gloo,
    the tensor itself through NCCL)."""
    if mesh.process_count <= 1:
        return t
    dist = _dist()
    if dist.get_backend() == "nccl":
        dist.all_reduce(t)
        return t
    host = t.cpu()
    dist.all_reduce(host)
    return host.to(t.device)


def ber_sharded(bits_ref, bits_hat, mesh: Mesh):
    """Global bit-error rate over bit tensors split on their leading axis
    over every shard: each shard counts its own errors, one ``psum``
    crosses the mesh (and an ``all_reduce`` the processes). Returns (ber,
    n_errors, n_bits)."""
    dev0 = mesh.local().first_device
    ref, local = _local_rows(as_tensor(bits_ref, dev0), mesh)
    hat, _ = _local_rows(as_tensor(bits_hat, dev0), mesh)
    spec = (local.axis_names,)
    counts = shard(ref, local, spec).map(
        lambda r, h: torch.stack([(r != h).sum(),
                                  torch.tensor(r.numel(), device=r.device)]),
        shard(hat, local, spec))
    total = _all_reduce(psum(counts, local.axis_names).blocks.flat[0], mesh)
    errs, n = (int(v) for v in total.tolist())
    return (errs / n if n else 0.0), errs, n


def power_spectrum_sharded(x, mesh: Mesh, nfft: int = 1024):
    """Mean power spectrum over captures split on their channel axis over
    every shard: each shard averages |FFT|² over its rows' whole nfft-point
    segments, one (nfft,) ``psum`` crosses the mesh (and an ``all_reduce``
    the processes). ``x``: (channels, n). Returns (nfft,) float32."""
    dev0 = mesh.local().first_device
    z, local = _local_rows(as_tensor(x, dev0).to(torch.complex64), mesh)
    if z.shape[0] % local.size:
        raise ValueError("channels must split evenly across the mesh")

    def spectrum(b):
        n_seg = b.shape[-1] // nfft
        segs = b[..., : n_seg * nfft].reshape(b.shape[0], n_seg, nfft)
        p = (torch.fft.fft(segs, dim=-1).abs() ** 2).mean(dim=(0, 1))
        return torch.cat([p * b.shape[0], p.new_tensor([b.shape[0]])])

    parts = shard(z, local, (local.axis_names,)).map(spectrum)
    total = _all_reduce(psum(parts, local.axis_names).blocks.flat[0], mesh)
    return total[:nfft] / total[nfft]


def measure_scaling(make_fn: Callable[[Mesh], Callable],
                    make_input: Callable[[int], tuple],
                    device_counts: Sequence[int] | None = None,
                    reps: int = 3, devices=None):
    """Samples/s at 1, 2, … devices → the scaling-efficiency table.
    ``make_fn(mesh)`` returns a callable over ``make_input(n)``'s arguments,
    sized in proportion to the device count (weak scaling). ``devices``:
    the shards' devices (default every CUDA device). Each rep is timed on
    the host clock until every device of the mesh has finished. Returns a
    list of {devices, samples_per_s, speedup, efficiency}."""
    from .sharding import make_mesh
    devs = list(make_mesh(devices=devices).devices.reshape(-1))
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]
    rows = []
    base_rate = None
    for n in device_counts:
        mesh = make_mesh(n, ("ch",), (n,), devices=devs)
        fn = make_fn(mesh)
        args = make_input(n)
        a0 = args[0]
        n_samples = int(a0.numel() if isinstance(a0, torch.Tensor)
                        else np.asarray(a0).size)
        fn(*args)                       # warm-up, finished before timing
        synchronize(mesh)
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            synchronize(mesh)
            best = min(best, time.perf_counter() - t0)
        rate = n_samples / best
        if base_rate is None:
            base_rate = rate
        rows.append({"devices": n, "samples_per_s": rate,
                     "speedup": rate / base_rate,
                     "efficiency": rate / (base_rate * n)})
    return rows


def format_scaling_table(rows) -> str:
    lines = ["devices  Msamples/s  speedup  efficiency"]
    for r in rows:
        lines.append(f"{r['devices']:7d}  {r['samples_per_s']/1e6:10.1f}  "
                     f"{r['speedup']:7.2f}  {r['efficiency']*100:9.1f}%")
    return "\n".join(lines)
