"""A mesh of shards in one process: the port's counterpart of
``jax.sharding.Mesh``, ``jax.shard_map`` and the ``lax`` collectives.

JAX drives every device of a mesh from one controller process. The port
does the same with torch: a :class:`Mesh` is an array of ``torch.device``
with named axes, and a device may stand in it more than once (eight shards
on one card, or on the CPU in the tests; one shard a card on a host with
several). A :class:`Shards` holds one tensor a shard, each on its shard's
device; its body functions run shard by shard, each with its shard's device
current, so a kernel wrapper launches on that device's stream (launches
queue asynchronously, so shards on different cards overlap).

The collectives are explicit tensor moves: :func:`ppermute`,
:func:`all_gather` and :func:`psum` move blocks between shards with
``Tensor.to(device, copy=True)`` (an on-device copy between shards of one
card, a peer copy between cards), and :func:`unshard` gathers the result
on the mesh's first device. Each adds the bytes it moves between shards to
:data:`traffic` (by collective), so a caller can read what a sharded path
moved. ``torch.distributed`` is used only across processes
(``distributed.py``); there is no rank per shard, because NCCL refuses two
ranks on one GPU and one process can drive every card of a host.

A spec names, for each dimension of a tensor, the mesh axis it is split
over (``None``: not split), as a ``PartitionSpec`` does; an entry may be a
tuple of axes, split major to minor. A mesh axis that a spec does not name
holds the same block on every shard along it: the port computes such a
block once, on the shards at index 0 of the unnamed axes.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Callable, Sequence

import numpy as np
import torch

# bytes moved between shards, by collective ("ppermute", "all_gather",
# "psum", "gather"); callers reset it with traffic.clear()
traffic: Counter = Counter()


def _objects(items, shape) -> np.ndarray:
    """An object array of ``shape`` holding ``items`` (numpy would unpack
    tensors into numbers if it built the array itself)."""
    out = np.empty(len(items), dtype=object)
    for i, it in enumerate(items):
        out[i] = it
    return out.reshape(shape)


class Mesh:
    """``devices``: a nested list or array of devices (``torch.device`` or
    their names), one a shard; ``axis_names``: one name an array axis.
    ``.devices`` is the object array of ``torch.device``, ``.shape`` the
    dict axis → size, ``.size`` the shard count. ``process_index`` and
    ``process_count`` say which row of a host-major process mesh
    (``make_process_mesh``) this process drives; 0 and 1 otherwise."""

    def __init__(self, devices, axis_names: Sequence[str],
                 process_index: int = 0, process_count: int = 1) -> None:
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = _objects(flat, arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D device array")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices.flat)))})"

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def flat(self, axis: str = "t") -> "Mesh":
        """Every device of the mesh on one named axis."""
        return Mesh(self.devices.reshape(-1), (axis,), self.process_index,
                    self.process_count)

    def local(self) -> "Mesh":
        """The shards this process drives: the whole mesh on one process,
        this process's row of a process mesh otherwise."""
        if self.process_count <= 1:
            return self
        return Mesh(self.devices[self.process_index], self.axis_names[1:])


def device_context(device: torch.device):
    """``device`` current for the block (CUDA), nothing to do otherwise."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(mesh: Mesh, spec) -> tuple:
    """The mesh axes ``spec`` names, in the mesh's order."""
    named = {a for e in spec for a in _entry_axes(e)}
    unknown = named - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"spec names axes {sorted(unknown)} the mesh lacks")
    return tuple(a for a in mesh.axis_names if a in named)


class Shards:
    """One block a shard over the mesh axes ``axes`` (an object array in
    the order of ``axes``, index 0 on the mesh's other axes)."""

    def __init__(self, mesh: Mesh, axes: Sequence[str], blocks: np.ndarray):
        self.mesh, self.axes, self.blocks = mesh, tuple(axes), blocks

    @property
    def devices(self) -> np.ndarray:
        idx = tuple(slice(None) if a in self.axes else 0
                    for a in self.mesh.axis_names)
        return self.mesh.devices[idx]

    def positions(self):
        """(array index, {axis: index along it}) of every shard."""
        for idx in np.ndindex(self.blocks.shape):
            yield idx, dict(zip(self.axes, idx))

    def map(self, fn: Callable, *others: "Shards",
            indexed: bool = False) -> "Shards":
        """``fn(block, *other blocks)`` on every shard with its device
        current (``fn(position, block, ...)`` when ``indexed``, position
        the dict axis → index)."""
        devs = self.devices
        out = []
        for idx, pos in self.positions():
            args = [self.blocks[idx]] + [o.blocks[idx] for o in others]
            with device_context(devs[idx]):
                out.append(fn(pos, *args) if indexed else fn(*args))
        return Shards(self.mesh, self.axes, _objects(out, self.blocks.shape))

    def part(self, i: int) -> "Shards":
        """Element ``i`` of tuple-valued blocks."""
        return Shards(self.mesh, self.axes, _objects(
            [b[i] for b in self.blocks.reshape(-1)], self.blocks.shape))


def shard(x: torch.Tensor, mesh: Mesh, spec) -> Shards:
    """Split ``x`` by ``spec`` (one entry a dimension, trailing ones
    ``None``) into per-shard blocks on their devices; a split dimension
    must divide evenly."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    axes = spec_axes(mesh, spec)
    sizes = mesh.shape
    for d, e in enumerate(spec):
        n = int(np.prod([sizes[a] for a in _entry_axes(e)]))
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} ({x.shape[d]}) does not split "
                             f"evenly into {n} shards")
    probe = Shards(mesh, axes, np.empty([sizes[a] for a in axes], object))
    devs = probe.devices
    blocks = []
    for idx, pos in probe.positions():
        sl = []
        for d, e in enumerate(spec):
            ea = _entry_axes(e)
            if not ea:
                sl.append(slice(None))
                continue
            n = int(np.prod([sizes[a] for a in ea]))
            k = int(np.ravel_multi_index([pos[a] for a in ea],
                                         [sizes[a] for a in ea]))
            step = x.shape[d] // n
            sl.append(slice(k * step, (k + 1) * step))
        blocks.append(x[tuple(sl)].to(devs[idx]))
    return Shards(mesh, axes, _objects(blocks, probe.blocks.shape))


def unshard(s: Shards, spec, device=None) -> torch.Tensor:
    """The inverse of :func:`shard`: the blocks put together by ``spec`` on
    ``device`` (default the mesh's first device); a gather, counted in
    :data:`traffic` for every block but the first shard's."""
    device = s.mesh.first_device if device is None else torch.device(device)
    b0 = s.blocks.flat[0]
    spec = tuple(spec) + (None,) * (b0.dim() - len(spec))
    sizes = s.mesh.shape
    counts = [int(np.prod([sizes[a] for a in _entry_axes(e)])) for e in spec]
    out = torch.empty([n * b for n, b in zip(counts, b0.shape)],
                      dtype=b0.dtype, device=device)
    for i, (idx, pos) in enumerate(s.positions()):
        blk = s.blocks[idx]
        sl = []
        for d, e in enumerate(spec):
            ea = _entry_axes(e)
            k = int(np.ravel_multi_index([pos[a] for a in ea],
                                         [sizes[a] for a in ea])) if ea else 0
            sl.append(slice(k * b0.shape[d], (k + 1) * b0.shape[d]))
        out[tuple(sl)] = blk.to(device)
        if i:
            traffic["gather"] += blk.numel() * blk.element_size()
    return out


def _along(s: Shards, axis: str):
    """Groups of shards along ``axis``: lists of array indices, ordered by
    the index along ``axis``."""
    if axis not in s.axes:
        raise ValueError(f"the shards do not span axis {axis!r}")
    k = s.axes.index(axis)
    rest = [n for i, n in enumerate(s.blocks.shape) if i != k]
    for other in np.ndindex(*rest):
        group = []
        for j in range(s.blocks.shape[k]):
            idx = list(other)
            idx.insert(k, j)
            group.append(tuple(idx))
        yield group


def ppermute(s: Shards, axis: str, perm) -> Shards:
    """``lax.ppermute``: for each (source, target) pair of ``perm``, the
    shard at index ``target`` along ``axis`` receives the block of the
    shard at ``source`` (copied to its device); a shard that no pair
    targets receives zeros of the block's shape."""
    devs = s.devices
    out = np.empty(s.blocks.shape, dtype=object)
    for group in _along(s, axis):
        for src, dst in perm:
            blk = s.blocks[group[src]]
            out[group[dst]] = blk.to(devs[group[dst]], copy=True)
            traffic["ppermute"] += blk.numel() * blk.element_size()
        for j, idx in enumerate(group):
            if out[idx] is None:
                out[idx] = torch.zeros_like(s.blocks[idx])
    return Shards(s.mesh, s.axes, out)


def all_gather(s: Shards, axis: str, dim: int = 0) -> Shards:
    """``lax.all_gather(tiled=True)``: every shard receives the blocks of
    its group along ``axis`` concatenated on ``dim``, in index order."""
    devs = s.devices
    out = np.empty(s.blocks.shape, dtype=object)
    for group in _along(s, axis):
        for idx in group:
            parts = [s.blocks[g].to(devs[idx], copy=g != idx) for g in group]
            out[idx] = torch.cat(parts, dim=dim)
            traffic["all_gather"] += sum(
                s.blocks[g].numel() * s.blocks[g].element_size()
                for g in group if g != idx)
    return Shards(s.mesh, s.axes, out)


def psum(s: Shards, axes) -> Shards:
    """``lax.psum`` over ``axes`` (a name or a sequence of names): each
    group's blocks summed on its first shard's device, the sum copied back
    to the others."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    cur = s
    for axis in axes:
        devs = cur.devices
        out = np.empty(cur.blocks.shape, dtype=object)
        for group in _along(cur, axis):
            head = group[0]
            total = cur.blocks[head].clone()
            for g in group[1:]:
                blk = cur.blocks[g]
                total += blk.to(devs[head], copy=True)
                traffic["psum"] += 2 * blk.numel() * blk.element_size()
            for g in group:
                out[g] = total if g == head else total.to(devs[g], copy=True)
        cur = Shards(cur.mesh, cur.axes, out)
    return cur


def synchronize(mesh: Mesh) -> None:
    """Wait for every CUDA device of the mesh."""
    for d in {d for d in mesh.devices.flat if d.type == "cuda"}:
        torch.cuda.synchronize(d)
