"""pathway_tpu_torch.models — the sentence encoder and its tokenizers in
PyTorch, the counterparts of ``pathway_tpu.models``. Weights are seeded
random (``init_params``) or carried across from the Flax model
(``flax_params_to_torch``)."""

from pathway_tpu_torch.models.convert import flax_params_to_torch, init_params
from pathway_tpu_torch.models.encoder import (
    EncoderConfig,
    SentenceEncoder,
    TransformerEncoder,
)
from pathway_tpu_torch.models.tokenizer import HashTokenizer, get_tokenizer

__all__ = [
    "EncoderConfig",
    "TransformerEncoder",
    "SentenceEncoder",
    "HashTokenizer",
    "get_tokenizer",
    "flax_params_to_torch",
    "init_params",
]
