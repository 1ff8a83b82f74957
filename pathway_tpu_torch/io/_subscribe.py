"""pw.io.subscribe (reference: python/pathway/io/_subscribe.py:13)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


def subscribe(
    table: Table,
    on_change: Callable | None = None,
    on_end: Callable | None = None,
    on_time_end: Callable | None = None,
    *,
    on_batch: Callable | None = None,
    with_envelope: bool = False,
    batch_format: str = "rows",
    include_key: bool = True,
    name: str | None = None,
    sort_by=None,
) -> None:
    """on_change(key, row: dict, time: int, is_addition: bool).

    ``on_batch(time, changes)`` is the batched egress: one callback per
    delivered batch with ``changes = [(key, row_dict, diff), ...]`` —
    serving fan-outs and columnar sinks should prefer it over the
    per-row ``on_change`` (which expands every C-owned batch row-wise
    through a Python callback; the Plan Doctor's ``sink.row-expanding``
    diagnostic names exactly that de-optimization).

    ``batch_format="arrow"`` is the fully columnar egress:
    ``on_batch(time, batch)`` receives a ``pyarrow.RecordBatch`` whose
    schema is the table's columns (nullable), a ``diff`` int64 column
    (±1) and — unless ``include_key=False`` — a 16-byte ``_key`` column
    carrying the engine's row keys little-endian
    (``pathway_tpu_torch.io._arrow.key_from_bytes`` converts back; counting/
    aggregating consumers that never touch keys should turn it off, it
    is the priciest column of the tuple-delta fallback leg). Columnar NativeBatch deliveries export ZERO-COPY through the
    Arrow C data interface — no Python row objects exist at the sink;
    tuple-delta deliveries (retractions, object columns, forced row
    path) are built column-wise on the Python side, with cells outside
    the Arrow scalar set pickled into binary columns tagged with
    ``pw_pickled`` field metadata (``unpickle_columns`` restores them)
    — so an Arrow-mode subscriber receives *every* delivery as a
    record batch. Requires pyarrow.

    ``batch_format="tuples"`` is the zero-transformation rows egress:
    ``on_batch(time, deltas)`` receives the engine's raw
    ``[(key, row_tuple, diff), ...]`` batch — row tuples in the table's
    column order, NO per-row dict building (the dict wrapper of the
    default ``"rows"`` format costs one dict per change; a counting or
    forwarding consumer pays it for nothing). The batch is a shared
    read-only view — consumers must not mutate it.

    ``with_envelope=True`` changes the ``on_batch``
    signature to ``on_batch(envelope, changes)`` where ``envelope`` is
    a :class:`~pathway_tpu_torch.io.txn.DeliveryEnvelope` ``(epoch,
    commit_ts, seq)`` — delivery metadata for the remaining
    at-least-once surface: ``commit_ts`` is the plain ``time`` of the
    unenveloped form (monotone across restarts), ``seq`` strictly
    monotone per subscription within one process incarnation, and an
    epoch bump or ``seq`` reset marks a redelivery window (see the
    ``DeliveryEnvelope`` docstring for the exact guarantees and what
    still needs consumer-side keys). Composes with either batch format.
    """
    if batch_format not in ("rows", "tuples", "arrow"):
        raise ValueError(
            f"batch_format must be 'rows', 'tuples' or 'arrow', "
            f"got {batch_format!r}"
        )
    if batch_format == "arrow":
        if on_batch is None:
            raise ValueError("batch_format='arrow' requires on_batch=")
        from pathway_tpu_torch.io._arrow import get_pyarrow

        if get_pyarrow() is None:
            raise ValueError(
                "batch_format='arrow' requires pyarrow to be installed"
            )
    cols = tuple(table.column_names())

    def lower(ctx):
        batch_cb = None
        arrow_cb = None
        if on_batch is not None and batch_format == "arrow":
            # direct columnar delivery; the rows callback below is the
            # fallback leg for tuple-delta batches, converted column-
            # wise so the consumer STILL sees a record batch
            arrow_cb = on_batch

            def batch_cb(stamp, deltas):
                from pathway_tpu_torch.io._arrow import deltas_to_arrow

                on_batch(
                    stamp,
                    deltas_to_arrow(deltas, cols, include_key=include_key),
                )

        elif on_batch is not None and batch_format == "tuples":
            # raw engine batch, zero per-row transformation — the
            # OutputNode's delivery is one callback + nothing else
            batch_cb = on_batch
        elif on_batch is not None:
            if with_envelope:

                def batch_cb(env, deltas):
                    on_batch(
                        env,
                        [
                            (k, dict(zip(cols, row)), d)
                            for k, row, d in deltas
                        ],
                    )

            else:

                def batch_cb(time, deltas):
                    on_batch(
                        time,
                        [
                            (k, dict(zip(cols, row)), d)
                            for k, row, d in deltas
                        ],
                    )

        # dict_cols pushes the row-dict building into the OutputNode's C
        # delivery loop instead of a per-change Python wrapper
        ctx.scope.output(
            ctx.engine_table(table),
            on_change=on_change,
            on_batch=batch_cb,
            on_batch_arrow=arrow_cb,
            arrow_cols=cols,
            arrow_key=include_key,
            on_time_end=on_time_end,
            on_end=on_end,
            dict_cols=cols if on_change is not None else None,
            envelope=with_envelope and on_batch is not None,
        )

    G.add_operator([table], [], lower, "subscribe", is_output=True)
