"""The harness's one contact with the program, ``pathway_tpu_torch``.

It builds the system under test from a configuration file: the encoder
(``SentenceEncoder`` over the benchmark's seeded state dict, with the
port's own tokenizer) and a prefilled ``KnnShard``. Imported only once
the harness has found a card, so the program's import counts as set-up.
"""

from __future__ import annotations

import torch

from rag_bench import corpus


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The allocator's peak on the card (0 off the card: tests only)."""
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def encoder(cfg: dict, params: dict, device, batch_size: int = 256):
    from pathway_tpu_torch.models.encoder import EncoderConfig, SentenceEncoder

    ec = EncoderConfig(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
        mlp=cfg["intermediate_size"], max_len=cfg["max_position_embeddings"],
        dtype=getattr(torch, cfg["activation_dtype"]),
    )
    return SentenceEncoder(ec, params=params, batch_size=batch_size, device=device)


def prefilled_shard(cfg: dict, seed: int, device):
    """A ``KnnShard`` of the deployment's capacity holding its ``rows``
    seeded unit rows under keys 0..rows-1, added block by block."""
    from pathway_tpu_torch.ops.knn import KnnShard

    dep = cfg["deployment"]
    d = cfg["hidden_size"]
    shard = KnnShard(d, dep["metric"], precision=dep["precision"],
                     capacity=dep["capacity"], device=device)
    for c in corpus.blocks(dep["rows"]):
        x = corpus.rows(seed, c, dep["rows"], d, device)
        start = c * corpus.BLOCK
        shard.add(range(start, start + x.shape[0]), x)
        del x
    return shard
