"""Weights across the two packages: the Flax parameter tree of the JAX
encoder as a state dict of this package's ``TransformerEncoder``.

The Flax layouts (``pathway_tpu/models/encoder.py``):

* ``attention/{query,key,value}/kernel`` is ``[H, heads, hd]``, bias
  ``[heads, hd]``;
* ``attention/out/kernel`` is ``[heads, hd, H]``, bias ``[H]``;
* ``Dense`` kernels are ``[in, out]`` (torch's ``Linear`` is ``[out, in]``);
* ``Embed`` tables are ``[rows, H]`` under ``embedding``;
* ``LayerNorm`` has ``scale``/``bias``.

The cross-encoder's tree (``pathway_tpu/models/cross_encoder.py``) is the
same backbone without ``type_embed``, plus ``pool`` and ``score`` Dense
layers.

The tree arrives as nested dicts of numpy arrays: this package never sees
a jax array.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pathway_tpu_torch.models.encoder import EncoderConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _ln(sd: dict, dst: str, src: Mapping[str, Any]) -> None:
    sd[f"{dst}.weight"] = _t(src["scale"])
    sd[f"{dst}.bias"] = _t(src["bias"])


def _dense(sd: dict, dst: str, src: Mapping[str, Any]) -> None:
    sd[f"{dst}.weight"] = _t(np.asarray(src["kernel"]).T)
    sd[f"{dst}.bias"] = _t(src["bias"])


def _backbone(
    params: Mapping[str, Any], config: EncoderConfig, embeds: tuple
) -> dict[str, torch.Tensor]:
    """The embedding tables ``embeds``, ``ln_embed`` and every block."""
    H = config.hidden
    sd: dict[str, torch.Tensor] = {}
    for name in embeds:
        sd[f"{name}.weight"] = _t(params[name]["embedding"])
    _ln(sd, "ln_embed", params["ln_embed"])
    for i in range(config.layers):
        blk = params[f"block_{i}"]
        att = blk["attention"]
        pre = f"blocks.{i}"
        for proj in ("query", "key", "value"):
            kern = np.asarray(att[proj]["kernel"]).reshape(H, H)  # [in, out]
            sd[f"{pre}.attention.{proj}.weight"] = _t(kern.T)
            sd[f"{pre}.attention.{proj}.bias"] = _t(
                np.asarray(att[proj]["bias"]).reshape(H)
            )
        out = np.asarray(att["out"]["kernel"]).reshape(H, H)  # [in, out]
        sd[f"{pre}.attention.out.weight"] = _t(out.T)
        sd[f"{pre}.attention.out.bias"] = _t(att["out"]["bias"])
        _ln(sd, f"{pre}.ln_attn", blk["ln_attn"])
        _dense(sd, f"{pre}.mlp_in", blk["mlp_in"])
        _dense(sd, f"{pre}.mlp_out", blk["mlp_out"])
        _ln(sd, f"{pre}.ln_mlp", blk["ln_mlp"])
    return sd


def flax_params_to_torch(
    params: Mapping[str, Any], config: EncoderConfig
) -> dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> ``TransformerEncoder`` state dict."""
    return _backbone(params, config, ("tok_embed", "pos_embed", "type_embed"))


def flax_cross_params_to_torch(
    params: Mapping[str, Any], config: EncoderConfig
) -> dict[str, torch.Tensor]:
    """The JAX package's ``CrossEncoderModel`` param tree (numpy leaves)
    -> ``CrossEncoderModel`` state dict: no type embedding, plus the
    ``pool`` and ``score`` Dense layers."""
    sd = _backbone(params, config, ("tok_embed", "pos_embed"))
    _dense(sd, "pool", params["pool"])
    _dense(sd, "score", params["score"])
    return sd


def random_flax_params(config: EncoderConfig, seed: int) -> dict[str, Any]:
    """A seeded random parameter tree in the Flax layout (numpy leaves):
    BERT's initializer (normal, std 0.02) for every weight, zero biases,
    unit LayerNorm scales."""
    rng = np.random.default_rng(seed)
    H, heads, M = config.hidden, config.heads, config.mlp
    hd = H // heads

    def normal(*shape):
        return (0.02 * rng.standard_normal(shape, dtype=np.float32))

    def ln():
        return {"scale": np.ones(H, np.float32), "bias": np.zeros(H, np.float32)}

    params: dict[str, Any] = {
        "tok_embed": {"embedding": normal(config.vocab_size, H)},
        "pos_embed": {"embedding": normal(config.max_len, H)},
        "type_embed": {"embedding": normal(2, H)},
        "ln_embed": ln(),
    }
    for i in range(config.layers):
        att = {
            proj: {
                "kernel": normal(H, heads, hd),
                "bias": np.zeros((heads, hd), np.float32),
            }
            for proj in ("query", "key", "value")
        }
        att["out"] = {"kernel": normal(heads, hd, H), "bias": np.zeros(H, np.float32)}
        params[f"block_{i}"] = {
            "attention": att,
            "ln_attn": ln(),
            "mlp_in": {"kernel": normal(H, M), "bias": np.zeros(M, np.float32)},
            "mlp_out": {"kernel": normal(M, H), "bias": np.zeros(H, np.float32)},
            "ln_mlp": ln(),
        }
    return params


def random_flax_cross_params(config: EncoderConfig, seed: int) -> dict[str, Any]:
    """A seeded random ``CrossEncoderModel`` tree in the Flax layout: the
    encoder's tree without ``type_embed``, plus the pool and score heads."""
    params = random_flax_params(config, seed)
    del params["type_embed"]
    rng = np.random.default_rng([seed, 1])
    H = config.hidden
    params["pool"] = {
        "kernel": 0.02 * rng.standard_normal((H, H), dtype=np.float32),
        "bias": np.zeros(H, np.float32),
    }
    params["score"] = {
        "kernel": 0.02 * rng.standard_normal((H, 1), dtype=np.float32),
        "bias": np.zeros(1, np.float32),
    }
    return params


def init_params(config: EncoderConfig, seed: int) -> dict[str, torch.Tensor]:
    """The port's own seeded weights, as a ``TransformerEncoder`` state
    dict (no checkpoint is shipped)."""
    return flax_params_to_torch(random_flax_params(config, seed), config)


def init_cross_params(config: EncoderConfig, seed: int) -> dict[str, torch.Tensor]:
    """The port's own seeded cross-encoder weights, as a
    ``CrossEncoderModel`` state dict."""
    return flax_cross_params_to_torch(random_flax_cross_params(config, seed), config)
