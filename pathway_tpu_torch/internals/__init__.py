"""pathway_tpu_torch.internals — device resolution and shape buckets."""
