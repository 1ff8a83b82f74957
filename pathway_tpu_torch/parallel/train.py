"""The sentence encoder's fine-tuning step, the port of
``pathway_tpu/parallel/train.py``: contrastive InfoNCE over in-batch
negatives, the standard recipe for bge-class retrievers.

torch has no single controller, so the mesh axes execute as follows:

* dp in one process (a ``Mesh`` whose dp axis repeats one device): the
  step splits the batch into ``mesh.shape["dp"]`` chunks, encodes each,
  and takes one InfoNCE over the whole batch, so in-batch negatives span
  the global batch, as XLA computes it for the JAX package;
* dp across ranks (``torch.distributed`` initialized, the rank's mesh
  from ``global_mesh``): each rank passes its own rows, all-gathers the
  document embeddings over its dp group with the autograd-aware gather,
  takes the loss of its own query rows against every document (summed,
  over the global batch), and sums the gradients over the dp group;
* tp across ranks (the rank's mesh has a tp axis of t > 1): the model
  holds only this rank's shard of every weight the Megatron specs
  (``make_param_shardings``) split, and the AdamW state of that shard
  (``TensorParallel``, ``shard_state_dict``). Each block runs with
  Megatron's two all-reduces over the rank's tp group: f (identity
  forward, sum backward) on the input of the column-parallel layers,
  g (sum forward, identity backward) on the output of the row-parallel
  ones. The column-parallel biases stay whole, as the reference
  replicates them: a rank adds its slice, and their gradients are
  summed over the tp group after the backward;
* tp in one process: the specs are computed and validated, and the
  weights stay whole, which computes the same function on a mesh whose
  tp axis repeats one device.

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
from pathway_tpu_torch.parallel.distributed import TensorParallel, _all_reduce
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


def _tp_dim(name: str, shape: tuple[int, ...]) -> int | None:
    """The dimension the tp axis splits, or None for a replicated tensor."""
    spec = param_sharding_rules(name, shape)
    return spec.index("tp") if "tp" in spec and len(spec) <= len(shape) else None


def make_param_shardings(mesh: Mesh, model: nn.Module) -> dict[str, tuple]:
    """The tp spec of every parameter of ``model`` on ``mesh`` (its sizes
    over every rank): a spec longer than the parameter's rank replicates
    it, a spec naming an axis the mesh lacks or a dimension its size does
    not divide raises ``ValueError`` (as JAX's ``NamedSharding`` placement
    does). A model that holds tp shards is checked at its whole shapes."""
    sizes = mesh.global_shape
    tp_size = model.tp.size if hasattr(model, "tp") else 1
    specs = {}
    for name, p in model.named_parameters():
        spec = param_sharding_rules(name, tuple(p.shape))
        if len(spec) > p.dim():
            spec = ()
        shape = list(p.shape)
        if "tp" in spec:
            shape[spec.index("tp")] *= tp_size
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            if ax not in sizes:
                raise ValueError(f"{name}: spec {spec} names axis {ax!r}, "
                                 f"not in the mesh {mesh}")
            if shape[dim] % sizes[ax]:
                raise ValueError(f"{name}: dimension {dim} of {tuple(shape)} "
                                 f"does not divide over {ax}={sizes[ax]}")
        specs[name] = spec
    return specs


def _tensor_parallel(mesh: Mesh) -> TensorParallel:
    """This rank's ``TensorParallel`` on a rank's mesh whose tp axis has
    more than one rank; one rank otherwise (one process keeps whole
    weights)."""
    size = mesh.global_shape.get("tp", 1)
    if mesh.ranks is None or size == 1:
        return TensorParallel(1, 0)
    return TensorParallel(size, mesh.coords()["tp"], mesh.group("tp"))


def shard_state_dict(state_dict: dict, size: int, rank: int) -> dict:
    """Rank ``rank``'s shards of a whole state dict over a tp axis of
    ``size``: rows of the column-parallel weights, columns of the
    row-parallel ones (``param_sharding_rules``), the rest as is."""
    out = {}
    for name, t in state_dict.items():
        dim = _tp_dim(name, tuple(t.shape))
        if dim is None:
            out[name] = t
            continue
        if t.shape[dim] % size:
            raise ValueError(f"{name}: dimension {dim} of {tuple(t.shape)} "
                             f"does not divide over tp={size}")
        n = t.shape[dim] // size
        out[name] = t.narrow(dim, rank * n, n).clone()
    return out


def _merge_shards(shards: list[dict]) -> dict:
    """The whole state dict of the tp ranks' ``shards``, in rank order:
    ``shard_state_dict``'s inverse."""
    out = {}
    for name, t in shards[0].items():
        dim = _tp_dim(name, tuple(t.shape))
        out[name] = t if dim is None else torch.cat([s[name] for s in shards], dim)
    return out


def gather_state_dict(tensors: dict, tp: TensorParallel) -> dict:
    """The whole tensors of this rank's shards (a state dict, or its
    gradients by name), gathered over the tp group; every rank of the
    group gets them."""
    if tp.size == 1:
        return dict(tensors)
    import torch.distributed as dist

    shards = [{} for _ in range(tp.size)]
    for name, t in tensors.items():
        if _tp_dim(name, tuple(t.shape)) is None:
            for s in shards:
                s[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(tp.size)]
        dist.all_gather(parts, t.contiguous(), group=tp.group)
        for s, part in zip(shards, parts):
            s[name] = part
    return _merge_shards(shards)


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
    Returns ``(state, model, tx)``. On a rank's mesh with a tp axis the
    whole seeded model is made, as the reference initializes the whole
    tree before placing it, and the rank keeps its shards; the AdamW is
    over the shards."""
    (mesh_dev,) = _distinct_devices(mesh)
    dev = resolve_device(mesh_dev)
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"create_train_state: device={device!r}, the mesh lies on {dev}")
    tp = _tensor_parallel(mesh)
    model = TransformerEncoder(config, tp)
    model.load_state_dict(shard_state_dict(init_params(config, seed), tp.size, tp.rank))
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


def _dp_group(mesh):
    """The process group a step's batch is split over: None in one process
    (or a group of one), the mesh's dp group on a rank's mesh, else the
    world."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return None
    if mesh is not None and mesh.ranks is not None:
        return mesh.group("dp")
    return dist.group.WORLD


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of ``x`` over ``group``, in group-rank order;
    backward, the gradient summed over the group, this rank's rows (a
    reduce-scatter, which gloo lacks; ``torch.distributed.nn``'s gather
    emulates it with a scatter that names a subgroup's ranks wrongly)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group, ctx.rank, ctx.n = group, dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def _loss_over_ranks(q_emb, d_emb, group, temperature: float = 0.05):
    """This rank's share of the global InfoNCE: its query rows against the
    documents of every rank of its dp ``group``, summed over the global
    batch. The gather's backward sums each rank's document gradients over
    the group, so the shares' gradients, summed over the group, are the
    global loss's."""
    import torch.distributed as dist

    size, rank = dist.get_world_size(group), dist.get_rank(group)
    d_all = _GatherRows.apply(d_emb, group) if size > 1 else d_emb
    n = q_emb.shape[0]
    logits = q_emb.float() @ d_all.float().T / temperature
    labels = rank * n + torch.arange(n, device=logits.device)
    return F.cross_entropy(logits, labels, reduction="sum") / (n * size)


def _all_reduce_flat(tensors: list[torch.Tensor], reduce) -> None:
    """Sum ``tensors`` in one collective: ``reduce`` sums a flat copy."""
    flat = reduce(torch.cat([t.reshape(-1) for t in tensors]))
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _all_reduce_grads(model: nn.Module, group) -> None:
    """Sum every gradient over the dp ``group`` in one collective."""
    import torch.distributed as dist

    if dist.get_world_size(group) > 1:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        _all_reduce_flat(grads, lambda flat: _all_reduce(flat, group))


def _sum_sliced_bias_grads(model: nn.Module, tp: TensorParallel) -> None:
    """The column-parallel biases are whole on every rank and each rank
    adds its slice: sum their gradients over the tp group, so every rank
    holds the whole gradient. (The embeddings' and LayerNorms' gradients
    are already equal over the group: f sums what flows into them.)"""
    grads = [p.grad for name, p in model.named_parameters()
             if name.endswith(".bias") and p.grad is not None
             and param_sharding_rules(name[:-len("bias")] + "weight", ()) == ("tp", None)]
    _all_reduce_flat(grads, tp.all_reduce)


def contrastive_train_step(model, tx, state: TrainState, batch, *, mesh=None):
    """One InfoNCE step. ``batch`` = dict(q_ids, q_mask, d_ids, d_mask) of
    [n, L] int arrays (across ranks: the n rows of this rank's dp row,
    the same on every rank of its tp group). Updates ``state`` in place
    and returns ``(state, loss)``, the loss a 0-dim tensor on the model's
    device (the step does not wait for it)."""
    dev = next(model.parameters()).device
    chunks = 1 if mesh is None else mesh.shape["dp"]
    t = {key: _to_device(batch[key], dev) for key in BATCH_KEYS}
    tx.zero_grad(set_to_none=True)
    q_emb = _encode(model, t["q_ids"].long(), t["q_mask"], chunks)
    d_emb = _encode(model, t["d_ids"].long(), t["d_mask"], chunks)
    group = _dp_group(mesh)
    if group is not None:
        import torch.distributed as dist

        loss = _loss_over_ranks(q_emb, d_emb, group)
        loss.backward()
        if model.tp.size > 1:
            _sum_sliced_bias_grads(model, model.tp)
        _all_reduce_grads(model, group)
        loss = loss.detach()
        if dist.get_world_size(group) > 1:
            _all_reduce(loss, group)
    else:
        loss = contrastive_loss(q_emb, d_emb)
        loss.backward()
        loss = loss.detach()
    tx.step()
    state.step += 1
    return state, loss


def make_sharded_train_step(model, tx, mesh: Mesh):
    """The train step over ``mesh``: the batch split on dp, the tp specs
    validated (and applied, on a rank's mesh). The returned fn takes
    (state, batch dict of [n, L] arrays) and runs one step."""
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
