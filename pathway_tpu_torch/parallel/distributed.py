"""Multi-process initialization: PATHWAY_* topology -> torch.distributed,
the port of ``pathway_tpu/parallel/distributed.py``.

The reference scales across processes with a timely TCP mesh configured by
PATHWAY_PROCESSES / PATHWAY_PROCESS_ID / PATHWAY_FIRST_PORT
(the reference's src/engine/dataflow/config.rs:63-127, `pathway spawn`
cli.py:96-103). The same variables, which ``python -m pathway_tpu_torch
spawn -n N`` sets for each rank, bootstrap a ``torch.distributed`` process
group beside the engine's own mesh.

The backend follows one rule (``choose_backend``): NCCL when every rank
drives a card of its own (rank r on ``cuda:r``), gloo otherwise — ranks
that share one card, since NCCL refuses two ranks on one device, and the
CPU. Rank r of the engine's mesh listens on ``first_port + r``, so the
default coordinator is ``first_port + processes``, the first port past
them (the JAX package's default, ``first_port``, is rank 0's listener).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.internals.device import resolve_device


def _unpinned_card(device: Any) -> bool:
    """``device`` names the card without an index (``None`` or "cuda")."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and dev.index is None


def choose_backend(device: Any, processes: int) -> str:
    """``"nccl"`` when every rank gets a card of its own: ``device`` names
    the card without pinning an index, and at least ``processes`` cards
    are visible. ``"gloo"`` otherwise: ranks sharing a card, and the
    CPU."""
    if _unpinned_card(device) and torch.cuda.device_count() >= processes:
        return "nccl"
    return "gloo"


def rank_device(device: Any = None) -> torch.device:
    """The device this rank drives: ``device=None`` is the card (it raises
    without CUDA unless ``device="cpu"``), rank r on ``cuda:{r % cards}``
    unless the caller pins an index."""
    dev = resolve_device(device)
    if not _unpinned_card(device):
        return dev
    rank = get_pathway_config().process_id
    return torch.device("cuda", rank % torch.cuda.device_count())


def default_coordinator(host: str = "127.0.0.1") -> str:
    """``PATHWAY_COORDINATOR``, else ``host:first_port + processes``."""
    cfg = get_pathway_config()
    return os.environ.get(
        "PATHWAY_COORDINATOR", f"{host}:{cfg.first_port + cfg.processes}"
    )


def initialize_from_env(
    coordinator_host: str = "127.0.0.1", *, device: Any = None
) -> bool:
    """Initialize the ``torch.distributed`` process group from PATHWAY_*
    env. Returns True if a multi-process group was initialized, False for
    single-process runs. The backend (``choose_backend`` over
    ``device``, by default the card) is then
    ``torch.distributed.get_backend()``.

    Launch with ``python -m pathway_tpu_torch spawn -n N program.py`` (each
    child gets PATHWAY_PROCESS_ID) or any launcher exporting the same
    variables.
    """
    import torch.distributed as dist

    cfg = get_pathway_config()
    if cfg.processes <= 1:
        return False
    dev = rank_device(device)
    backend = choose_backend(device, cfg.processes)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{default_coordinator(coordinator_host)}",
        world_size=cfg.processes,
        rank=cfg.process_id,
    )
    return True


def global_mesh(axes=("dp", "tp"), shape=None, *, device: Any = None):
    """This process's mesh. In a single process: every visible card, or the
    CPU when ``device="cpu"``. In a process group it spans the world's
    ranks, as the reference's spans every device of the cluster: ``shape``
    (by default ``best_factorization(world)`` for two axes) lays them out
    with the last axis fastest, the rank drives its own device
    (``rank_device``), and the subgroup of every axis line is made here,
    once (``Mesh.group``)."""
    import torch.distributed as dist

    from pathway_tpu_torch.parallel.mesh import Mesh, best_factorization, make_mesh

    dev = rank_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        devices = [dev] if dev.type == "cpu" else None
        return make_mesh(axes=axes, shape=shape, devices=devices)
    axes = tuple(axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        if len(axes) == 1:
            shape = (world,)
        elif len(axes) == 2:
            shape = best_factorization(world)
        else:
            raise ValueError("pass `shape` explicitly for >2 mesh axes")
    shape = tuple(shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover the {world} ranks")
    ranks = np.arange(world).reshape(shape)
    local = make_mesh(axes=axes, shape=(1,) * len(axes), devices=[dev])
    return Mesh(local.devices, axes, ranks=ranks, rank=rank,
                groups=_axis_groups(ranks, axes, rank))


def _axis_groups(ranks: np.ndarray, axes: tuple, rank: int) -> dict:
    """This rank's subgroup on every axis of ``ranks``. ``new_group`` is
    collective over the world: every rank makes every line's group, in
    the same order, including the lines it is not on; a line that is the
    whole world is the world's group."""
    import torch.distributed as dist

    mine = {}
    for a, axis in enumerate(axes):
        for line in np.moveaxis(ranks, a, -1).reshape(-1, ranks.shape[a]):
            members = [int(r) for r in line]
            group = (dist.group.WORLD if len(members) == ranks.size
                     else dist.new_group(members))
            if rank in members:
                mine[axis] = group
    return mine


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (gloo reduces bf16 as it is, as
    XLA's psum does)."""
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    return t


class TensorParallel:
    """A rank's place in its tp group: ``size`` ranks, this one ``rank``,
    the ``torch.distributed`` ``group`` (unused with one rank; None would
    mean the world's). The encoder's blocks shard on it
    (``models/encoder.py``) and call ``copy`` and ``reduce`` around their
    column- and row-parallel layers; ``all_reduces`` counts the group's
    collectives. ``TensorParallel(1, 0)``, the encoder's default, holds
    whole weights and makes no collective."""

    def __init__(self, size: int, rank: int, group=None):
        self.size, self.rank, self.group = size, rank, group
        self.all_reduces = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self.all_reduces += 1
        return _all_reduce(t, self.group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: ``x`` forward, its gradient summed backward."""
        return x if self.size == 1 else _CopyToGroup.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g: ``x`` summed forward, the gradient as is backward."""
        return x if self.size == 1 else _ReduceOverGroup.apply(x, self)

    def __repr__(self) -> str:
        return f"TensorParallel(size={self.size}, rank={self.rank})"


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce(grad.clone(memory_format=torch.contiguous_format)), None


class _ReduceOverGroup(torch.autograd.Function):
    # not torch.distributed.nn's all_reduce: its backward sums again
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return grad, None
