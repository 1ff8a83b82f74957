"""pathway_tpu_torch.stdlib.utils (reference: python/pathway/stdlib/utils)."""

from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.bucketing import truncate_to_minutes
from pathway_tpu_torch.stdlib.utils.col import apply_all_rows, unpack_col
from pathway_tpu_torch.stdlib.utils.filtering import argmax_rows, argmin_rows
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer

__all__ = [
    "AsyncTransformer",
    "apply_all_rows",
    "argmax_rows",
    "argmin_rows",
    "pandas_transformer",
    "unpack_col",
]
