"""The index rows: seeded unit vectors, made on the device in blocks.

Row ``i`` is key ``i``. Block ``c`` (rows ``c * BLOCK`` onwards) comes
from a ``torch.Generator`` on the device seeded from (seed, c) alone, so
the reference makes any block again without the program. The rows stand
in for embedded passages: embedding millions of passages would take most
of a run's set-up.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 20


def _block_seed(seed: int, c: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (c + 1)) % (2**63 - 1)


def rows(seed: int, c: int, n_rows: int, dim: int, device) -> torch.Tensor:
    """Block ``c`` of a corpus of ``n_rows`` unit rows: [<= BLOCK, dim] f32."""
    start = c * BLOCK
    count = min(BLOCK, n_rows - start)
    g = torch.Generator(device=device)
    g.manual_seed(_block_seed(seed, c))
    x = torch.randn((count, dim), generator=g, device=device, dtype=torch.float32)
    return x / x.norm(dim=-1, keepdim=True)


def blocks(n_rows: int) -> range:
    return range((n_rows + BLOCK - 1) // BLOCK)
