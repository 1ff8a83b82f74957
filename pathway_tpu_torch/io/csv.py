"""pw.io.csv (reference: python/pathway/io/csv) — thin wrapper over fs."""

from __future__ import annotations

from pathway_tpu_torch.io import fs


def read(path, *, schema=None, mode="streaming", **kwargs):
    return fs.read(path, format="csv", schema=schema, mode=mode, **kwargs)


def write(table, filename, **kwargs):
    return fs.write(table, filename, format="csv", **kwargs)
