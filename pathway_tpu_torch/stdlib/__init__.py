"""pathway_tpu_torch.stdlib — standard library (reference:
python/pathway/stdlib/, SURVEY §2.7)."""
