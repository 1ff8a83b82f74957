"""pw.stateful (reference: python/pathway/stdlib/stateful/deduplicate.py:31)."""

from __future__ import annotations

from typing import Any, Callable


def deduplicate(
    table,
    *,
    value,
    instance=None,
    acceptor: Callable[[Any, Any], bool],
    persistent_id: str | None = None,
    name: str | None = None,
):
    """Keep one accepted value per instance: `acceptor(new, current)` decides
    whether the incoming value replaces the held one (reference:
    stateful/deduplicate.py — stateful-reducer protocol over the engine's
    deduplicate operator)."""
    return table.deduplicate(
        value=value,
        instance=instance,
        acceptor=acceptor,
        persistent_id=persistent_id,
        name=name,
    )
