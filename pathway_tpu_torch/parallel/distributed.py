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
    """This process's mesh. torch has no single controller, so a rank of a
    process group meshes the device it drives (``rank_device``); a single
    process meshes every visible card, or the CPU when ``device="cpu"``."""
    import torch.distributed as dist

    from pathway_tpu_torch.parallel.mesh import make_mesh

    dev = rank_device(device)
    grouped = dist.is_available() and dist.is_initialized()
    devices = [dev] if grouped or dev.type == "cpu" else None
    return make_mesh(axes=axes, shape=shape, devices=devices)
