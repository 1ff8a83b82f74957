"""Device mesh construction — the port of ``pathway_tpu/parallel/mesh.py``.

Maps the reference's worker topology (PATHWAY_THREADS × PATHWAY_PROCESSES,
src/engine/dataflow/config.rs:88-127) onto a grid of devices: the "dp"
axis plays the role of the key-sharded worker set (rows/index shards),
"tp" shards model weights inside one replica.

torch has no mesh object, so ``Mesh`` is a small one: a grid of
``torch.device``s with named axes. A device may appear more than once:
``make_mesh(devices=[cuda:0] * 4)`` lays four index shards on one card,
and ``make_mesh(devices=[cpu] * 8)`` eight on the CPU, as the JAX
package's virtual CPU devices do for its tests.

Under a ``torch.distributed`` process group each rank drives one device,
so a rank's mesh (``distributed.global_mesh``) holds that device alone
and, beside it, the grid of every rank (``ranks``): the reference's
``make_mesh`` reshapes the device list with the last axis fastest, so
rank r of a (dp, tp) grid sits at (r // tp, r % tp).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch


def best_factorization(n: int, max_tp: int = 8) -> tuple[int, int]:
    """Factor n devices into (dp, tp): largest tp ≤ max_tp dividing n, with
    dp carrying the rest. tp stays small — weight sharding buys memory, not
    throughput, for encoder-class models; dp carries the ingest scale."""
    tp = 1
    for cand in range(min(max_tp, n), 0, -1):
        if n % cand == 0:
            tp = cand
            break
    # prefer dp-heavy splits: cap tp at sqrt(n) unless that leaves nothing
    while tp > 1 and n // tp < tp and n % (tp // 2) == 0 and tp % 2 == 0:
        tp //= 2
    return n // tp, tp


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices with named axes. ``devices`` is an object array
    of ``torch.device`` shaped like the mesh: the devices this process
    drives. ``shape`` maps each axis name to its size in that grid.

    A rank's mesh also has ``ranks``, the int array of every rank of the
    process group laid out on the axes, ``rank``, this process's rank,
    and ``groups``, the ``torch.distributed`` group of each axis that
    holds this rank (``group``); its device grid is the
    rank's own device, size 1 on every axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    ranks: np.ndarray | None = None
    rank: int | None = None
    groups: Mapping[str, Any] | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def global_shape(self) -> dict[str, int]:
        """The axis sizes over every process: the ranks' grid under a
        process group, else ``shape``."""
        grid = self.devices if self.ranks is None else self.ranks
        return dict(zip(self.axis_names, grid.shape))

    def coords(self) -> dict[str, int]:
        """This rank's index on each axis of ``ranks``."""
        (where,) = np.argwhere(self.ranks == self.rank)
        return dict(zip(self.axis_names, (int(i) for i in where)))

    def axis_ranks(self, axis: str) -> list[int]:
        """The ranks along ``axis`` through this rank, in axis order."""
        index = list(self.coords().values())
        index[self.axis_names.index(axis)] = slice(None)
        return [int(r) for r in self.ranks[tuple(index)]]

    def group(self, axis: str):
        """The ``torch.distributed`` group of the ranks along ``axis``
        that holds this rank."""
        if self.groups is None:
            raise ValueError(f"{self} is not a mesh of a process group "
                             "(global_mesh() after initialize_from_env())")
        return self.groups[axis]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, the other axes at index 0: one per
        shard of a structure sharded over ``axis``."""
        a = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[a] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices.flat)
        return f"Mesh({self.shape}, devices=[{devs}])"


def make_mesh(
    n_devices: int | None = None,
    axes: tuple[str, ...] = ("dp", "tp"),
    shape: tuple[int, ...] | None = None,
    devices: Sequence[Any] | None = None,
) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device), the
    first ``n_devices`` of them. Repeats are allowed in ``devices``."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= (e.g. "
                "devices=['cpu'] * 8) to lay the mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    devices = [
        torch.device("cuda", torch.cuda.current_device())
        if d.type == "cuda" and d.index is None else d
        for d in devices
    ]
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} devices asked, {len(devices)} given")
    devices = devices[:n]
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            shape = best_factorization(n)
        else:
            raise ValueError("pass `shape` explicitly for >2 mesh axes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), tuple(axes))
