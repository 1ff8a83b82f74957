"""pw.io.jsonlines (reference: python/pathway/io/jsonlines) — wrapper over fs."""

from __future__ import annotations

from pathway_tpu_torch.io import fs


def read(path, *, schema=None, mode="streaming", **kwargs):
    return fs.read(path, format="jsonlines", schema=schema, mode=mode, **kwargs)


def write(table, filename, **kwargs):
    return fs.write(table, filename, format="jsonlines", **kwargs)
