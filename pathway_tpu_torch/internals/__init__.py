"""pathway_tpu_torch.internals — the Table DSL, schema, expressions, graph
capture, config and observability planes, and the device plane
(``device.py``)."""
