"""BERT-class sentence encoder in PyTorch — the port of the framework's
flagship model (``pathway_tpu/models/encoder.py``).

It matches the Flax model, not HuggingFace's BERT, so the same parameters
give the same embeddings in both packages:

* LayerNorm with epsilon 1e-6 (Flax's default; torch's is 1e-5), its
  statistics in f32 as ``E[x²] − E[x]²`` and its output cast to the
  activation dtype, as Flax's ``LayerNorm(dtype=bf16)`` does;
* the exact erf GELU;
* row 0 of the type embedding added to every position;
* masked attention scores set to ``finfo(dtype).min``, not ``-inf``, so an
  all-padding batch row (``pad_batch`` adds them) pools to zeros, not NaN;
  the softmax runs in the activation dtype, as Flax 0.12's does;
* masked mean pooling, then L2 normalisation with a 1e-9 floor;
* activations in ``config.dtype`` (bf16 by default), parameters in f32.

The GEMMs and the attention are plain ``torch.matmul``/einsum: the JAX
package leaves them to XLA, not to a hand kernel.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import threading
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch.internals import device as _devsup
from pathway_tpu_torch.internals.device import (
    PLANE as _DEVICE,
    batch_bucket,
    device_site,
    encoder_bucket,
    nbytes_of,
    resolve_device,
    seq_bucket,
)
from pathway_tpu_torch.models.tokenizer import get_tokenizer

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 12
    heads: int = 12
    mlp: int = 1536
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16  # activation dtype; params stay f32

    @classmethod
    def bge_small(cls) -> "EncoderConfig":
        return cls()

    @classmethod
    def bge_base(cls) -> "EncoderConfig":
        return cls(hidden=768, layers=12, heads=12, mlp=3072)

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        """Test/dry-run geometry: tiny but structurally identical."""
        return cls(vocab_size=512, hidden=64, layers=2, heads=4, mlp=128, max_len=64)


class _LayerNorm(nn.Module):
    """Flax ``LayerNorm(dtype=...)``: f32 statistics with the fast
    variance, normalise in f32, cast to the activation dtype."""

    def __init__(self, hidden: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias
        return y.to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    # Flax Dense(dtype=...) casts inputs, kernel and bias to the dtype
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class _Attention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h = cfg.hidden
        self.heads = cfg.heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)
        self._scales: dict = {}

    def _scale(self, hd: int, dt: torch.dtype, device) -> torch.Tensor:
        """sqrt(depth) rounded to the dtype, as a 0-dim tensor made once
        per (dtype, device): a CUDA graph capture may not copy from the
        host, so the forward itself makes no new host tensor."""
        key = (dt, device)
        t = self._scales.get(key)
        if t is None:
            t = self._scales[key] = torch.tensor(math.sqrt(hd), dtype=dt, device=device)
        return t

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        n, L, h = x.shape
        hd = h // self.heads
        dt = x.dtype
        q = _linear(x, self.query).view(n, L, self.heads, hd)
        k = _linear(x, self.key).view(n, L, self.heads, hd)
        v = _linear(x, self.value).view(n, L, self.heads, hd)
        # Flax scales the query by sqrt(depth) rounded to the dtype
        q = q / self._scale(hd, dt, x.device)
        s = torch.einsum("nqhd,nkhd->nhqk", q, k)
        s = torch.where(mask, s, torch.finfo(dt).min)
        # jax.nn.softmax in the activation dtype
        e = torch.exp(s - s.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)
        o = torch.einsum("nhqk,nkhd->nqhd", w, v).reshape(n, L, h)
        return _linear(o, self.out)


class _Block(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.ln_attn = _LayerNorm(cfg.hidden)
        self.mlp_in = nn.Linear(cfg.hidden, cfg.mlp)
        self.mlp_out = nn.Linear(cfg.mlp, cfg.hidden)
        self.ln_mlp = _LayerNorm(cfg.hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.ln_attn(x + self.attention(x, mask))
        # erf-based gelu: the approximate tanh form drifts ~1e-3
        h = F.gelu(_linear(x, self.mlp_in), approximate="none")
        return self.ln_mlp(x + _linear(h, self.mlp_out))


class TransformerEncoder(nn.Module):
    """Token ids + mask -> L2-normalized sentence embeddings [n, hidden]."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        cfg = self.config = config
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.pos_embed = nn.Embedding(cfg.max_len, cfg.hidden)
        # single-segment encoding: BERT's token_type embedding collapses to
        # one learned row added everywhere (kept as a 2-row table so
        # checkpoints load losslessly)
        self.type_embed = nn.Embedding(2, cfg.hidden)
        self.ln_embed = _LayerNorm(cfg.hidden)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.layers))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        L = ids.shape[1]
        x = (
            F.embedding(ids, self.tok_embed.weight).to(dt)
            + self.pos_embed.weight[:L].to(dt)[None]
            + self.type_embed.weight[0].to(dt)
        )
        x = self.ln_embed(x)
        m = mask.bool()
        attn_mask = m[:, None, :, None] & m[:, None, None, :]  # [n,1,L,L]
        for block in self.blocks:
            x = block(x, attn_mask)
        # mean pool over valid tokens, then L2 normalize (bge pooling)
        mf = m[:, :, None].float()
        pooled = (x.float() * mf).sum(1) / torch.clamp(mf.sum(1), min=1.0)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-9)


def forward_flops_per_token(cfg: EncoderConfig, seq_len: int) -> float:
    """Model FLOPs one padded token costs in a forward pass: per layer,
    QKV projections 6h², attention scores + weighted values 4·L·h, output
    projection 2h², and the MLP pair 4·h·mlp. Embedding lookups,
    layernorms and pooling are O(h) and omitted."""
    h, m = cfg.hidden, cfg.mlp
    per_layer = 8.0 * h * h + 4.0 * h * m + 4.0 * seq_len * h
    return cfg.layers * per_layer


def encoder_param_bytes(cfg: EncoderConfig) -> float:
    """Device bytes of the f32 parameter set (embedding tables + per-layer
    attention/MLP weights)."""
    h, m = cfg.hidden, cfg.mlp
    return 4.0 * (
        cfg.vocab_size * h + cfg.max_len * h
        + cfg.layers * (4.0 * h * h + 2.0 * h * m)
    )


def forward_cost_model(
    cfg: EncoderConfig, n: int, seq_len: int
) -> tuple[float, float]:
    """Analytical ``(flops, device_bytes_accessed)`` of one padded forward
    batch: the per-token model above times the padded token count; one
    read of the f32 parameter set plus a few bf16 activation passes per
    layer."""
    flops = forward_flops_per_token(cfg, seq_len) * n * seq_len
    h = cfg.hidden
    act_b = 2.0 * n * seq_len * h * cfg.layers * 4.0
    return flops, encoder_param_bytes(cfg) + act_b


device_site(
    "encoder.forward",
    cost_model=forward_cost_model,
    dtypes=("int16", "int32", "float32", "bfloat16"),
    where="pathway_tpu_torch/models/encoder.py:SentenceEncoder.encode_tokens_device",
    description="sentence-encoder forward "
                "(pow2 batch x multiple-of-32 seq buckets)",
)


def pad_batch(ids: np.ndarray, mask: np.ndarray, max_len: int, batch_cap: int):
    """Pad (ids, mask) to the bounded (batch, seq) shape set: pow2 batch
    buckets x multiple-of-32 sequence buckets. Returns
    (ids_p, mask_p, n_valid_rows)."""
    n, L = ids.shape
    Lb = seq_bucket(L, max_len)
    nb = batch_bucket(n, 8, batch_cap)
    if n > nb:
        raise ValueError(f"batch of {n} exceeds batch capacity {batch_cap}")
    ids_p = np.zeros((nb, Lb), np.int32)
    mask_p = np.zeros((nb, Lb), np.int32)
    L_eff = min(L, Lb)
    ids_p[:n, :L_eff] = ids[:, :L_eff]
    mask_p[:n, :L_eff] = mask[:, :L_eff]
    return ids_p, mask_p, n


def compact_tokens(ids_p: np.ndarray, mask_p: np.ndarray, vocab_size: int):
    """The compact wire format of a padded batch, or None where it does
    not apply: ids as 16-bit words (vocab < 2^16) and the contiguous-prefix
    mask as per-row lengths, rebuilt on the device. Cuts host->device
    bytes ~4x. Returns (ids_u16 viewed as int16, lengths int32)."""
    lengths = mask_p.sum(axis=1, dtype=np.int32)
    contiguous = bool(
        (mask_p.cumsum(axis=1)[np.arange(len(lengths)), lengths - 1]
         == lengths).all()
    ) if mask_p.shape[1] else True
    if not (contiguous and vocab_size <= 65536):
        return None
    # torch has no general uint16 arithmetic: ship the bits as int16
    return ids_p.astype(np.uint16).view(np.int16), lengths


def expand_compact(ids16: torch.Tensor, lengths: torch.Tensor):
    """Device side of ``compact_tokens``: (ids int64, mask int32)."""
    ids = ids16.to(torch.int64) & 0xFFFF
    pos = torch.arange(ids16.shape[1], device=ids16.device, dtype=torch.int32)
    mask = (pos[None, :] < lengths[:, None]).to(torch.int32)
    return ids, mask


class SentenceEncoder:
    """Host-facing batched encoder: list[str] -> np.ndarray [n, hidden].

    ``params`` is a state dict in this package's layout (see
    ``models/convert.py``); without one the weights come from
    ``checkpoint`` (a local HF checkpoint directory, or a hub name in a
    populated HF cache; ``models/hf_loader.py``), which brings its own
    config and tokenizer, or else from ``init_params(config, seed)``.
    ``device=None`` runs on the card.
    """

    def __init__(
        self,
        config: EncoderConfig | None = None,
        *,
        checkpoint: str | None = None,
        tokenizer_path: str | None = None,
        seed: int = 0,
        batch_size: int = 256,
        params: dict[str, Any] | None = None,
        device: Any = None,
    ):
        self.device = resolve_device(device)
        tokenizer = None
        if checkpoint is not None and params is None:
            try:
                from pathway_tpu_torch.models.hf_loader import load_bert_encoder

                config, params, tokenizer = load_bert_encoder(checkpoint)
            except OSError:
                # not available offline: seeded weights and the WordPiece
                # vocab, as in the JAX package. Any other exception is a
                # loader or geometry fault and surfaces.
                pass
        self.config = config or EncoderConfig.bge_small()
        self.tokenizer = tokenizer or get_tokenizer(
            tokenizer_path,
            vocab_size=self.config.vocab_size,
            max_length=self.config.max_len,
        )
        self.batch_size = batch_size
        if params is None:
            from pathway_tpu_torch.models.convert import init_params

            params = init_params(self.config, seed)
        model = TransformerEncoder(self.config)
        model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        # the forward's shape buckets, (site, bucket) -> its CUDA graph on
        # the card (None on the CPU)
        self._graphs: dict = {}
        self._graph_lock = threading.Lock()
        self._graph_pool = None

    @property
    def embed_dim(self) -> int:
        return self.config.hidden

    def forward(
        self, ids: torch.Tensor, mask: torch.Tensor, *,
        site: str = "encoder.forward", bucket: tuple | None = None,
    ) -> torch.Tensor:
        """Embeddings of a padded batch (ids int64, mask int32).

        ``site`` and ``bucket`` name the calling device site and its shape
        bucket (by default the batch's shape); a bucket must fix the
        shape. The first forward of a (site, bucket) notes a recompile at
        ``site``, on every device. On the card it captures that bucket's
        CUDA graph, which every later forward of the bucket replays:
        eager, the forward's ~300 small launches each release and retake
        the GIL, and beside a busy Python thread (a connector's rescan,
        the engine's own operators) every retake can wait out the
        interpreter's switch interval."""
        key = (site, tuple(ids.shape) if bucket is None else bucket)
        with torch.inference_mode():
            if self.device.type != "cuda":
                with self._graph_lock:
                    new = key not in self._graphs
                    self._graphs[key] = None
                if new:
                    _DEVICE.note_recompile(site)
                return self.model(ids, mask)
            with self._graph_lock:
                entry = self._graphs.get(key)
                if entry is None:
                    entry = self._graphs[key] = self._capture(ids, mask)
                    _DEVICE.note_recompile(site)
                graph, ids_in, mask_in, out = entry
                ids_in.copy_(ids)
                mask_in.copy_(mask)
                graph.replay()
                return out.clone()

    def _capture(self, ids: torch.Tensor, mask: torch.Tensor):
        """Capture the forward at the shape and types of ``ids``/``mask``
        into a graph whose memory pool every graph of this encoder
        shares (they replay one at a time, under ``_graph_lock``)."""
        ids_in, mask_in = ids.clone(), mask.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # warm-up: lazy inits stay out of the graph
            self.model(ids_in, mask_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # a dead reference cycle may hold another encoder's graphs; the
        # cyclic collector must not free them inside this capture (a graph
        # destroyed there is an operation the capture forbids, and the
        # capture fails), so it is held off until the capture ends. (A
        # collection here instead would cost a walk of the whole heap,
        # which an engine holding a large corpus pays at every capture.)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  capture_error_mode="thread_local"):
                out = self.model(ids_in, mask_in)
        finally:
            if collecting:
                gc.enable()
        return graph, ids_in, mask_in, out

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        texts = list(texts)
        if not texts:
            return np.zeros((0, self.config.hidden), np.float32)
        ids, mask = self.tokenizer(texts)
        out = np.empty((len(texts), self.config.hidden), np.float32)
        for start in range(0, len(texts), self.batch_size):
            sl = slice(start, min(start + self.batch_size, len(texts)))
            out[sl] = self.encode_tokens_device(ids[sl], mask[sl]).cpu().numpy()
        return out

    def encode_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Encode one batch and return the device-resident embeddings
        [n, hidden] without a host round trip; the launch is
        asynchronous, so chaining into ``KnnShard.add`` lets host
        tokenization of the next batch overlap device compute."""
        ids, mask = self.tokenizer(list(texts))
        return self.encode_tokens_device(ids, mask)

    def encode_tokens_device(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Device-encode a pre-tokenized batch — the shared padding +
        forward core. Uses the compact uint16-ids-plus-lengths transfer
        when the mask is a contiguous prefix and ids fit 16 bits.

        The device site ``encoder.forward``: the launch runs under
        ``supervised_dispatch`` and, while the device plane is armed,
        inside one timed dispatch record closed on CUDA events."""
        ids_p, mask_p, n = pad_batch(
            ids, mask, self.config.max_len, self.batch_size
        )
        compact = compact_tokens(ids_p, mask_p, self.config.vocab_size)
        nb, Lb = ids_p.shape
        dev = _DEVICE.begin("encoder.forward", self.device) if _DEVICE.on else None
        if compact is not None:
            wire = compact
            lengths = compact[1]
        else:
            wire = (ids_p, mask_p)
            lengths = mask_p.sum(axis=1, dtype=np.int32)

        def launch() -> torch.Tensor:
            if compact is not None:
                ids_t, mask_t = expand_compact(
                    torch.from_numpy(wire[0]).to(self.device),
                    torch.from_numpy(wire[1]).to(self.device),
                )
            else:
                ids_t = torch.from_numpy(ids_p).to(self.device, torch.int64)
                mask_t = torch.from_numpy(mask_p).to(self.device)
            return self.forward(
                ids_t, mask_t, site="encoder.forward",
                bucket=encoder_bucket(nb, Lb, compact is not None),
            )

        try:
            emb = _devsup.supervised_dispatch("encoder.forward", launch)
        except BaseException:
            # close the record on the failure path (an abandoned record
            # leaks dispatch-queue depth)
            _DEVICE.end(dev, None, block=False)
            raise
        if dev is not None:
            # effective share: real tokens over padded tokens — the
            # bucket-padding waste the effective-MFU gauge exposes
            flops, acc = forward_cost_model(self.config, nb, Lb)
            eff_tokens = float(np.sum(lengths[:n], dtype=np.int64))
            _DEVICE.end(
                dev, emb, flops=flops, bytes_accessed=acc,
                transfer_bytes=nbytes_of(*wire, emb),
                effective_share=eff_tokens / float(nb * Lb),
            )
        return emb[:n]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)
