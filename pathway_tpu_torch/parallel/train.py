"""The sentence encoder's fine-tuning step, the port of
``pathway_tpu/parallel/train.py``: contrastive InfoNCE over in-batch
negatives, the standard recipe for bge-class retrievers.

torch has no single controller, so the mesh axes execute as follows:

* dp in one process (a ``Mesh`` whose dp axis repeats one device): the
  step splits the batch into ``mesh.shape["dp"]`` chunks, encodes each,
  and takes one InfoNCE over the whole batch, so in-batch negatives span
  the global batch, as XLA computes it for the JAX package;
* dp across ranks (``torch.distributed`` initialized, the mesh the rank's
  own from ``global_mesh``): each rank passes its own rows, all-gathers
  the document embeddings with the autograd-aware gather, takes the loss
  of its own query rows against every document (summed, over the global
  batch), and sums the gradients over the ranks;
* tp: the Megatron specs (``make_param_shardings``) are computed and
  validated, and the weights stay whole, which computes the same function
  on a mesh whose tp axis repeats one device.

A single-process mesh over distinct devices raises: one process drives
one card here, and ``python -m pathway_tpu_torch spawn -n N`` starts a
rank per card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch.internals.device import resolve_device
from pathway_tpu_torch.models.convert import init_params
from pathway_tpu_torch.models.encoder import EncoderConfig, TransformerEncoder
from pathway_tpu_torch.parallel.mesh import Mesh

BATCH_KEYS = ("q_ids", "q_mask", "d_ids", "d_mask")


@dataclasses.dataclass
class TrainState:
    """The model whose parameters train, its optimizer and the step count.
    A step updates all three in place (JAX's donation)."""

    params: nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0


def param_sharding_rules(name: str, shape: tuple[int, ...]) -> tuple:
    """Megatron-style tp rules keyed on the port's state-dict names, a spec
    as a tuple of mesh axis names (or None) per dimension; () replicates.

    ``nn.Linear`` weights are [out, in]:

    - attention query/key/value and ``mlp_in``: column-parallel, dim 0;
    - attention ``out`` and ``mlp_out``: row-parallel, dim 1;
    - embeddings, LayerNorms and biases: replicated.
    """
    parts = name.split(".")
    if parts[-1] != "weight":
        return ()
    if "attention" in parts:
        return (None, "tp") if "out" in parts else ("tp", None)
    if "mlp_in" in parts:
        return ("tp", None)
    if "mlp_out" in parts:
        return (None, "tp")
    return ()


def _distinct_devices(mesh: Mesh) -> list[torch.device]:
    devices = list(dict.fromkeys(mesh.devices.flat))
    if len(devices) > 1:
        raise NotImplementedError(
            f"a single-process training mesh over distinct devices {devices}: "
            "one process drives one card here; start a rank per card with "
            "`python -m pathway_tpu_torch spawn -n N` and use global_mesh()"
        )
    return devices


def make_param_shardings(mesh: Mesh, model: nn.Module) -> dict[str, tuple]:
    """The tp spec of every parameter of ``model`` on ``mesh``: a spec
    longer than the parameter's rank replicates it, a spec naming an axis
    the mesh lacks or a dimension its size does not divide raises
    ``ValueError`` (as JAX's ``NamedSharding`` placement does)."""
    sizes = mesh.shape
    specs = {}
    for name, p in model.named_parameters():
        spec = param_sharding_rules(name, tuple(p.shape))
        if len(spec) > p.dim():
            spec = ()
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            if ax not in sizes:
                raise ValueError(f"{name}: spec {spec} names axis {ax!r}, "
                                 f"not in the mesh {mesh}")
            if p.shape[dim] % sizes[ax]:
                raise ValueError(f"{name}: dimension {dim} of {tuple(p.shape)} "
                                 f"does not divide over {ax}={sizes[ax]}")
        specs[name] = spec
    return specs


def adamw(params: Iterable[torch.Tensor], learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)``: betas (0.9, 0.999), eps 1e-8 outside
    the square root, weight decay 1e-4 on every parameter (torch's default
    is 1e-2)."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def create_train_state(
    config: EncoderConfig,
    mesh: Mesh,
    *,
    seed: int = 0,
    learning_rate: float = 1e-4,
    device: Any = None,
) -> tuple[TrainState, TransformerEncoder, torch.optim.AdamW]:
    """A seeded ``TransformerEncoder`` on the mesh's device (``device``
    names it again, or ``None``), its AdamW, and a state at step 0.
    Returns ``(state, model, tx)``."""
    (mesh_dev,) = _distinct_devices(mesh)
    dev = resolve_device(mesh_dev)
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"create_train_state: device={device!r}, the mesh lies on {dev}")
    model = TransformerEncoder(config)
    model.load_state_dict(init_params(config, seed))
    model.to(dev)
    make_param_shardings(mesh, model)
    tx = adamw(model.parameters(), learning_rate)
    return TrainState(params=model, opt_state=tx), model, tx


def contrastive_loss(q_emb, d_emb, temperature: float = 0.05):
    """InfoNCE over in-batch negatives: row i's positive is column i."""
    logits = q_emb.float() @ d_emb.float().T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)


def _to_device(a, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to a card through pinned memory, so the
    copy does not wait for the work already queued."""
    t = torch.as_tensor(np.asarray(a))
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _encode(model, ids, mask, chunks: int) -> torch.Tensor:
    return torch.cat([
        model(i, m) for i, m in zip(ids.chunk(chunks), mask.chunk(chunks))
    ])


def _grouped() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _loss_over_ranks(q_emb, d_emb, temperature: float = 0.05):
    """This rank's share of the global InfoNCE: its query rows against the
    documents of every rank, summed over the global batch. The gather's
    backward sums each rank's document gradients over the ranks, so the
    shares' gradients, summed over the ranks, are the global loss's."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_gather

    world, rank = dist.get_world_size(), dist.get_rank()
    d_all = torch.cat(all_gather(d_emb))
    n = q_emb.shape[0]
    logits = q_emb.float() @ d_all.float().T / temperature
    labels = rank * n + torch.arange(n, device=logits.device)
    return F.cross_entropy(logits, labels, reduction="sum") / (n * world)


def _all_reduce_grads(model: nn.Module) -> None:
    """Sum every gradient over the ranks in one collective."""
    import torch.distributed as dist

    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def contrastive_train_step(model, tx, state: TrainState, batch, *, mesh=None):
    """One InfoNCE step. ``batch`` = dict(q_ids, q_mask, d_ids, d_mask) of
    [n, L] int arrays (across ranks: this rank's n rows). Updates
    ``state`` in place and returns ``(state, loss)``, the loss a 0-dim
    tensor on the model's device (the step does not wait for it)."""
    dev = next(model.parameters()).device
    chunks = 1 if mesh is None else mesh.shape["dp"]
    t = {key: _to_device(batch[key], dev) for key in BATCH_KEYS}
    tx.zero_grad(set_to_none=True)
    q_emb = _encode(model, t["q_ids"].long(), t["q_mask"], chunks)
    d_emb = _encode(model, t["d_ids"].long(), t["d_mask"], chunks)
    if _grouped():
        import torch.distributed as dist

        loss = _loss_over_ranks(q_emb, d_emb)
        loss.backward()
        _all_reduce_grads(model)
        loss = loss.detach()
        dist.all_reduce(loss)
    else:
        loss = contrastive_loss(q_emb, d_emb)
        loss.backward()
        loss = loss.detach()
    tx.step()
    state.step += 1
    return state, loss


def make_sharded_train_step(model, tx, mesh: Mesh):
    """The train step over ``mesh``: the batch split on dp, the tp specs
    validated. The returned fn takes (state, batch dict of [n, L] arrays)
    and runs one step."""
    _distinct_devices(mesh)
    if "dp" not in mesh.shape:
        raise ValueError(f"make_sharded_train_step: the mesh {mesh} has no 'dp' axis")
    make_param_shardings(mesh, model)
    dp = mesh.shape["dp"]

    def step(state: TrainState, batch):
        n = np.shape(batch["q_ids"])[0]
        if n % dp or np.shape(batch["d_ids"])[0] != n:
            raise ValueError(f"a batch of {n} queries and "
                             f"{np.shape(batch['d_ids'])[0]} documents does "
                             f"not split over dp={dp}")
        return contrastive_train_step(model, tx, state, batch, mesh=mesh)

    return step
