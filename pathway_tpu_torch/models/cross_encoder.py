"""Cross-encoder reranker in PyTorch: (query, document) pair -> relevance
score — the port of ``pathway_tpu/models/cross_encoder.py``.

The replacement for the reference's CrossEncoderReranker
(python/pathway/xpacks/llm/rerankers.py:186 — sentence-transformers
CrossEncoder). The backbone is the sentence encoder's, without the type
embedding: the pair is concatenated [CLS] q [SEP] d [SEP], and a tanh
pool plus a scalar head read the CLS position in f32. Whole candidate
lists are scored in batched forwards. The same Flax parameters
(``models/convert.py flax_cross_params_to_torch``) give the same scores in
both packages.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch.internals.device import batch_bucket, resolve_device
from pathway_tpu_torch.models.encoder import EncoderConfig, _Block, _LayerNorm
from pathway_tpu_torch.models.tokenizer import get_tokenizer


class CrossEncoderModel(nn.Module):
    """Token ids + mask of (query, doc) pairs -> one f32 score per pair."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        cfg = self.config = config
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.pos_embed = nn.Embedding(cfg.max_len, cfg.hidden)
        self.ln_embed = _LayerNorm(cfg.hidden)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.layers))
        self.pool = nn.Linear(cfg.hidden, cfg.hidden)
        self.score = nn.Linear(cfg.hidden, 1)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        L = ids.shape[1]
        x = (
            F.embedding(ids, self.tok_embed.weight).to(dt)
            + self.pos_embed.weight[:L].to(dt)[None]
        )
        x = self.ln_embed(x)
        m = mask.bool()
        attn_mask = m[:, None, :, None] & m[:, None, None, :]  # [n,1,L,L]
        for block in self.blocks:
            x = block(x, attn_mask)
        cls = x[:, 0, :].float()
        h = torch.tanh(self.pool(cls))
        return self.score(h)[:, 0]


class CrossEncoder:
    """Host-facing scorer: [(query, doc)] -> np.ndarray of scores.

    ``params`` is a ``CrossEncoderModel`` state dict; without one the
    weights come from ``init_cross_params(config, seed)``. ``device=None``
    runs on the card."""

    def __init__(
        self,
        config: EncoderConfig | None = None,
        *,
        tokenizer_path: str | None = None,
        seed: int = 0,
        batch_size: int = 64,
        params: dict[str, Any] | None = None,
        device: Any = None,
    ):
        self.device = resolve_device(device)
        self.config = config or EncoderConfig.bge_small()
        self.tokenizer = get_tokenizer(
            tokenizer_path,
            vocab_size=self.config.vocab_size,
            max_length=self.config.max_len,
        )
        self.batch_size = batch_size
        if params is None:
            from pathway_tpu_torch.models.convert import init_cross_params

            params = init_cross_params(self.config, seed)
        model = CrossEncoderModel(self.config)
        model.load_state_dict(params)
        self.model = model.to(self.device).eval()

    def score(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        pairs = list(pairs)
        if not pairs:
            return np.zeros((0,), np.float32)
        out = np.empty((len(pairs),), np.float32)
        for start in range(0, len(pairs), self.batch_size):
            chunk = pairs[start : start + self.batch_size]
            ids, mask = self._encode_pairs(chunk)
            with torch.inference_mode():
                scores = self.model(
                    torch.from_numpy(ids).to(self.device, torch.int64),
                    torch.from_numpy(mask).to(self.device),
                )
            out[start : start + len(chunk)] = scores.float().cpu().numpy()[: len(chunk)]
        return out

    def _encode_pairs(self, pairs):
        q_ids, q_mask = self.tokenizer([q for q, _ in pairs])
        d_ids, d_mask = self.tokenizer([d for _, d in pairs])
        max_len = self.config.max_len
        seqs = []
        for qi, qm, di, dm in zip(q_ids, q_mask, d_ids, d_mask):
            # [CLS] q [SEP] d [SEP]: the query keeps its CLS...SEP envelope,
            # the doc drops its CLS and keeps its own tokenizer's SEP
            qs = [int(t) for t, m in zip(qi, qm) if m]
            ds = [int(t) for t, m in zip(di, dm) if m][1:]
            seqs.append((qs + ds)[:max_len])
        longest = max(len(s) for s in seqs)
        # the JAX package pads both axes with the pow2 batch bucket
        Lb = batch_bucket(longest, 16, max_len)
        nb = batch_bucket(len(seqs), 8, self.batch_size)
        ids = np.zeros((nb, Lb), np.int32)
        mask = np.zeros((nb, Lb), np.int32)
        for i, s in enumerate(seqs):
            s = s[:Lb]
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids, mask

    def __call__(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        return self.score(pairs)
