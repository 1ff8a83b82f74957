"""Seeded encoder weights, made on the device in one call.

One ``torch.randn`` over every parameter at once, on the device, in
float32 (the type the port keeps its parameters in), then cut into
views. Matrices and embedding tables are N(0, 0.02²), as BERT initialises
them; biases N(0, 0.02²) and LayerNorm scales 1 + N(0, 0.02²), so that
no term of the forward is a constant the comparison could not see. Keyed
as the port's ``TransformerEncoder`` state dict; the reference reads the
same tensors by the same names.
"""

from __future__ import annotations

import torch

STD = 0.02


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Parameter name -> shape for a configuration file's model keys."""
    h, m = cfg["hidden_size"], cfg["intermediate_size"]
    out: dict[str, tuple[int, ...]] = {
        "tok_embed.weight": (cfg["vocab_size"], h),
        "pos_embed.weight": (cfg["max_position_embeddings"], h),
        "type_embed.weight": (cfg["type_vocab_size"], h),
        "ln_embed.weight": (h,), "ln_embed.bias": (h,),
    }
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}"
        for name in ("query", "key", "value", "out"):
            out[f"{b}.attention.{name}.weight"] = (h, h)
            out[f"{b}.attention.{name}.bias"] = (h,)
        out[f"{b}.ln_attn.weight"] = (h,)
        out[f"{b}.ln_attn.bias"] = (h,)
        out[f"{b}.mlp_in.weight"] = (m, h)
        out[f"{b}.mlp_in.bias"] = (m,)
        out[f"{b}.mlp_out.weight"] = (h, m)
        out[f"{b}.mlp_out.bias"] = (h,)
        out[f"{b}.ln_mlp.weight"] = (h,)
        out[f"{b}.ln_mlp.bias"] = (h,)
    return out


def state_dict(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    sh = shapes(cfg)
    sizes = [int(torch.Size(s).numel()) for s in sh.values()]
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2_654_435_761 + 12_345) % (2**63 - 1))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    flat.mul_(STD)
    out = {}
    for (name, s), part in zip(sh.items(), torch.split(flat, sizes)):
        t = part.view(s)
        if name.endswith(".weight") and len(s) == 1:  # a LayerNorm scale
            t.add_(1.0)
        out[name] = t
    return out
