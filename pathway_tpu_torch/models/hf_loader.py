"""HF BERT checkpoint -> the port's ``TransformerEncoder`` weights, the
counterpart of ``pathway_tpu/models/hf_loader.py``.

The state dict of a BERT-family encoder (bge-small/base, all-MiniLM, ...)
is renamed onto this package's parameter names. Both use torch's
``Linear`` layout (``[out, in]``), so no weight is transposed; every
tensor becomes f32, as the JAX package's loader makes it.

Loading is offline. A local checkpoint directory in the HF layout is read
here without ``transformers`` (the GPU machine has neither it nor
``safetensors``):

* ``config.json`` with ``json``;
* ``model.safetensors`` with a small reader of the format (an 8-byte
  little-endian header length, a JSON header, then the raw tensors), or,
  failing that file, ``pytorch_model.bin`` through
  ``torch.load(weights_only=True)``;
* the tokenizer through ``transformers.AutoTokenizer`` where it is
  importable, else the port's ``WordPieceTokenizer`` over ``vocab.txt``
  with ``do_lower_case`` from ``tokenizer_config.json``. The two give the
  same ids (``tests/test_torch_hf_loader.py``).

A name that is not a directory (a hub id in a populated HF cache) goes
through ``transformers`` with ``local_files_only=True``, as in the JAX
package. ``OSError`` means "not available offline": ``SentenceEncoder``
then keeps its seeded weights.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Mapping

import torch

from pathway_tpu_torch.models.encoder import EncoderConfig, TransformerEncoder

# safetensors dtype names -> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes overruns the file")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        shape = info["shape"]
        numel = 1
        for s in shape:
            numel *= s
        width = torch.empty((), dtype=dtype).element_size()
        if end - start != numel * width or base + end > len(data):
            raise ValueError(f"{path}: {name} has a bad byte range")
        t = (torch.frombuffer(data, dtype=dtype, count=numel, offset=base + start)
             if numel else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape).clone()
    return out


def _hf_get(cfg: Any, name: str):
    return cfg[name] if isinstance(cfg, Mapping) else getattr(cfg, name)


def config_from_hf(hf_config) -> EncoderConfig:
    """``EncoderConfig`` matching an HF ``BertConfig`` (an object, or the
    dict of its ``config.json``)."""
    return EncoderConfig(
        vocab_size=_hf_get(hf_config, "vocab_size"),
        hidden=_hf_get(hf_config, "hidden_size"),
        layers=_hf_get(hf_config, "num_hidden_layers"),
        heads=_hf_get(hf_config, "num_attention_heads"),
        mlp=_hf_get(hf_config, "intermediate_size"),
        max_len=_hf_get(hf_config, "max_position_embeddings"),
    )


def _layer_names(i: int) -> list[tuple[str, str]]:
    hf, pt = f"encoder.layer.{i}.", f"blocks.{i}."
    return [
        (hf + "attention.self.query", pt + "attention.query"),
        (hf + "attention.self.key", pt + "attention.key"),
        (hf + "attention.self.value", pt + "attention.value"),
        (hf + "attention.output.dense", pt + "attention.out"),
        (hf + "attention.output.LayerNorm", pt + "ln_attn"),
        (hf + "intermediate.dense", pt + "mlp_in"),
        (hf + "output.dense", pt + "mlp_out"),
        (hf + "output.LayerNorm", pt + "ln_mlp"),
    ]


def bert_state_dict_to_torch(
    state_dict: Mapping[str, Any], config: EncoderConfig
) -> dict[str, torch.Tensor]:
    """Map an HF ``BertModel`` state dict (``bert.`` prefix stripped; old
    ``LayerNorm.gamma``/``beta`` names accepted) onto a
    ``TransformerEncoder`` state dict of f32 tensors. Raises ``KeyError``
    for a missing tensor and ``ValueError`` for one whose shape is not the
    config's."""
    pairs = [
        ("embeddings.word_embeddings", "tok_embed"),
        ("embeddings.position_embeddings", "pos_embed"),
        ("embeddings.token_type_embeddings", "type_embed"),
        ("embeddings.LayerNorm", "ln_embed"),
    ]
    for i in range(config.layers):
        pairs += _layer_names(i)
    with torch.device("meta"):
        want = TransformerEncoder(config).state_dict()
    out: dict[str, torch.Tensor] = {}
    for src, dst in pairs:
        for leaf, old in (("weight", "gamma"), ("bias", "beta")):
            if f"{dst}.{leaf}" not in want:
                continue
            name = f"{src}.{leaf}"
            if name not in state_dict and src.endswith("LayerNorm"):
                name = f"{src}.{old}"
            t = state_dict[name]
            t = (t if isinstance(t, torch.Tensor) else torch.as_tensor(t)).detach()
            shape = tuple(want[f"{dst}.{leaf}"].shape)
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"checkpoint tensor {name} has shape {tuple(t.shape)}, "
                    f"the config needs {shape}"
                )
            out[f"{dst}.{leaf}"] = t.to("cpu", torch.float32)
    return out


def _strip_prefix(sd: dict) -> dict:
    # strip the "bert." prefix some checkpoints carry
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")}
    return sd


def _read_dir(path: str) -> tuple[dict, dict, dict]:
    """(config.json, raw state dict, tokenizer_config.json) of a local
    checkpoint directory."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        hf_cfg = json.load(f)
    st = os.path.join(path, "model.safetensors")
    binf = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st):
        sd = read_safetensors(st)
    elif os.path.exists(binf):
        sd = torch.load(binf, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"{path} holds neither model.safetensors nor pytorch_model.bin"
        )
    tok_cfg: dict = {}
    tc = os.path.join(path, "tokenizer_config.json")
    if os.path.exists(tc):
        with open(tc, encoding="utf-8") as f:
            tok_cfg = json.load(f)
    return hf_cfg, sd, tok_cfg


def _transformers():
    """The ``transformers`` module, or None where it is not installed."""
    try:
        import transformers
    except ImportError:
        return None
    return transformers


def load_bert_encoder(model_name_or_path: str):
    """Load an HF BERT checkpoint offline: returns ``(config, state_dict,
    tokenizer)``, the state dict in this package's layout and the
    tokenizer with the ``(ids, mask)`` contract, truncating at
    ``config.max_len``.

    Raises ``OSError`` when the checkpoint is not available offline (no
    such directory or cached hub entry, or no weights file in the
    directory); callers fall back to seeded weights.
    """
    from pathway_tpu_torch.models.tokenizer import _HFTokenizerAdapter

    tf = _transformers()
    if os.path.isdir(model_name_or_path):
        hf_cfg, sd, tok_cfg = _read_dir(model_name_or_path)
        config = config_from_hf(hf_cfg)
        if tf is not None:
            tok = _HFTokenizerAdapter(
                tf.AutoTokenizer.from_pretrained(
                    model_name_or_path, local_files_only=True
                ),
                config.max_len,
            )
        else:
            from pathway_tpu_torch.models.wordpiece import WordPieceTokenizer

            tok = WordPieceTokenizer(
                os.path.join(model_name_or_path, "vocab.txt"),
                max_length=config.max_len,
                lowercase=bool(tok_cfg.get("do_lower_case", True)),
            )
    else:
        if tf is None:
            raise OSError(
                f"{model_name_or_path!r} is not a local checkpoint directory, "
                "and a cached hub checkpoint needs transformers"
            )
        hf = tf.AutoConfig.from_pretrained(model_name_or_path, local_files_only=True)
        model = tf.AutoModel.from_pretrained(model_name_or_path, local_files_only=True)
        config = config_from_hf(hf)
        sd = model.state_dict()
        tok = _HFTokenizerAdapter(
            tf.AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True),
            config.max_len,
        )
    return config, bert_state_dict_to_torch(_strip_prefix(sd), config), tok
