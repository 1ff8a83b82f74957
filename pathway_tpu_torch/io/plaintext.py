"""pw.io.plaintext (reference: python/pathway/io/plaintext)."""

from __future__ import annotations

from pathway_tpu_torch.io import fs


def read(path, *, mode="streaming", **kwargs):
    return fs.read(path, format="plaintext", mode=mode, **kwargs)
