"""pathway_tpu_torch.models — the sentence encoder, the cross-encoder and
their tokenizers in PyTorch, the counterparts of the JAX package's
``models``. Weights are seeded random (``init_params``,
``init_cross_params``), carried across from the Flax models
(``flax_params_to_torch``, ``flax_cross_params_to_torch``) or read from a
local HF checkpoint (``load_bert_encoder``, ``SentenceEncoder(checkpoint=)``)."""

from pathway_tpu_torch.models.convert import (
    flax_cross_params_to_torch,
    flax_params_to_torch,
    init_cross_params,
    init_params,
)
from pathway_tpu_torch.models.cross_encoder import CrossEncoder, CrossEncoderModel
from pathway_tpu_torch.models.encoder import (
    EncoderConfig,
    SentenceEncoder,
    TransformerEncoder,
)
from pathway_tpu_torch.models.hf_loader import (
    bert_state_dict_to_torch,
    config_from_hf,
    load_bert_encoder,
)
from pathway_tpu_torch.models.tokenizer import HashTokenizer, get_tokenizer

__all__ = [
    "EncoderConfig",
    "TransformerEncoder",
    "SentenceEncoder",
    "CrossEncoder",
    "CrossEncoderModel",
    "HashTokenizer",
    "get_tokenizer",
    "flax_params_to_torch",
    "flax_cross_params_to_torch",
    "init_params",
    "init_cross_params",
    "load_bert_encoder",
    "config_from_hf",
    "bert_state_dict_to_torch",
]
