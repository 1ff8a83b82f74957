"""Ring attention — sequence parallelism for long sequences, the port of
``pathway_tpu/parallel/ring_attention.py``.

Attention over a sequence split into one block per device of a mesh
axis: each device keeps its query block, the key/value blocks travel
around the ring, and a flash-attention-style online softmax (running
max, denominator and weighted sum, all in f32) accumulates the exact
result block by block (Liu et al., Ring Attention). A device holds one
``(S/P)²`` score block at a time instead of the ``S²`` of full attention.

Two rings:

* over a ``Mesh`` axis in one process (``mesh.axis_devices(axis)``): the
  blocks are copied to the next device (``.to(dev, non_blocking=True)``),
  a re-indexing where the mesh repeats one device;
* over the ranks of a process group's mesh (``global_mesh``: one device
  per rank, the axis a line of ranks): each rank passes its own block and
  gets its own block of the output back; the blocks travel around the
  axis's ranks with ``batch_isend_irecv``.

The block step is plain torch (two matmuls and the softmax update), as
the JAX package leaves its ``einsum`` to XLA.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.internals.device import resolve_device
from pathway_tpu_torch.parallel.mesh import Mesh

_NEG_INF = torch.finfo(torch.float32).min


class _Accumulator:
    """The online softmax of one query block: running max ``m``,
    denominator ``l`` and unnormalised output ``o``, all f32."""

    def __init__(self, q: torch.Tensor, rank: int, sm_scale: float, causal: bool):
        b, h, s_local, d = q.shape
        self.q32 = q.float() * sm_scale
        self.causal = causal
        self.s_local = s_local
        self.q_pos = rank * s_local + torch.arange(s_local, device=q.device)
        self.m = torch.full((b, h, s_local), _NEG_INF, dtype=torch.float32, device=q.device)
        self.l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
        self.o = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)

    def add(self, k_blk: torch.Tensor, v_blk: torch.Tensor, src: int) -> None:
        """Fold in the key/value block that originated at rank ``src``."""
        s = torch.matmul(self.q32, k_blk.float().transpose(-1, -2))
        if self.causal:
            k_pos = src * self.s_local + torch.arange(self.s_local, device=s.device)
            mask = self.q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(self.m, s.amax(-1))
        # guard fully-masked rows: exp(neg_inf - neg_inf) must not NaN
        alpha = torch.exp(torch.where(self.m == _NEG_INF, _NEG_INF, self.m - m_new))
        probs = torch.exp(s - m_new[..., None])
        if self.causal:
            probs = torch.where(mask, probs, 0.0)
        self.l = self.l * alpha + probs.sum(-1)
        self.o = self.o * alpha[..., None] + torch.matmul(probs, v_blk.float())
        self.m = m_new

    def result(self, dtype: torch.dtype) -> torch.Tensor:
        return (self.o / torch.clamp(self.l, min=1e-30)[..., None]).to(dtype)


def _grouped(mesh: Mesh) -> bool:
    """The ring is a line of ranks: the process group is initialized and
    ``mesh`` is a rank's mesh over it."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and mesh.ranks is not None


def _ring_over_mesh(q, k, v, devices, causal, sm_scale):
    p = len(devices)
    seq = q.shape[2]
    if seq % p:
        raise ValueError(
            f"ring_attention: sequence length {seq} is not divisible by the "
            f"ring's {p} devices"
        )
    s_local = seq // p

    def block(x, r):
        return x[:, :, r * s_local:(r + 1) * s_local].to(devices[r], non_blocking=True)

    k_blk = [block(k, r) for r in range(p)]
    v_blk = [block(v, r) for r in range(p)]
    accs = [_Accumulator(block(q, r), r, sm_scale, causal) for r in range(p)]
    for r in range(p):  # the local block, no rotation needed
        accs[r].add(k_blk[r], v_blk[r], r)
    for i in range(1, p):
        # rotate FIRST: rank r receives rank r - 1's block, so at step i
        # the held block originated at rank (r - i) mod p
        k_blk = [k_blk[r - 1].to(devices[r], non_blocking=True) for r in range(p)]
        v_blk = [v_blk[r - 1].to(devices[r], non_blocking=True) for r in range(p)]
        for r in range(p):
            accs[r].add(k_blk[r], v_blk[r], (r - i) % p)
    return torch.cat([a.result(q.dtype).to(q.device) for a in accs], dim=2)


def _ring_over_group(q, k, v, ring: list[int], causal, sm_scale):
    """The ring over the ranks ``ring`` (global ranks, in ring order),
    this rank among them."""
    import torch.distributed as dist

    p, my = len(ring), ring.index(dist.get_rank())
    nxt, prv = ring[(my + 1) % p], ring[(my - 1) % p]

    def rotate(k_blk, v_blk):
        k_in, v_in = torch.empty_like(k_blk), torch.empty_like(v_blk)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, k_blk, nxt), dist.P2POp(dist.irecv, k_in, prv),
            dist.P2POp(dist.isend, v_blk, nxt), dist.P2POp(dist.irecv, v_in, prv),
        ])
        return k_in, v_in, reqs

    k_blk, v_blk = k.contiguous(), v.contiguous()
    acc = _Accumulator(q, my, sm_scale, causal)
    # each transfer overlaps the block step before it
    pending = rotate(k_blk, v_blk) if p > 1 else None
    acc.add(k_blk, v_blk, my)
    for i in range(1, p):
        k_blk, v_blk, reqs = pending
        for req in reqs:
            req.wait()
        if i < p - 1:
            pending = rotate(k_blk, v_blk)
        acc.add(k_blk, v_blk, (my - i) % p)
    return acc.result(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "sp",
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Exact attention over a sequence split on ``mesh`` axis ``axis``.

    Inputs are [batch, heads, seq, head_dim] with seq divisible by the
    axis size; batch and heads stay whole on every device of the ring.
    Within one process the output is the whole sequence, on ``q``'s
    device. On a rank's mesh (``global_mesh``) each rank of the axis
    passes its own sequence block and gets its block of the output.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if _grouped(mesh):
        return _ring_over_group(q, k, v, mesh.axis_ranks(axis), causal, sm_scale)
    devices = [resolve_device(d) for d in mesh.axis_devices(axis)]
    return _ring_over_mesh(q, k, v, devices, causal, sm_scale)


def reference_attention(q, k, v, *, causal: bool = False,
                        sm_scale: float | None = None):
    """Single-device full-materialization attention (test oracle)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float() * sm_scale, k.float().transpose(-1, -2))
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = torch.where(mask, s, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)
