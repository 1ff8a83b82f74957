"""pw.io.null — sink that discards rows (reference: python/pathway/io/null;
native NullWriter, data_storage.rs:1387). Used to force materialization of
a pipeline without producing output."""

from __future__ import annotations

from pathway_tpu_torch.internals.parse_graph import G


def write(table, *, name: str | None = None, **kwargs) -> None:
    def lower(ctx):
        ctx.scope.output(ctx.engine_table(table), on_change=lambda *a: None)

    G.add_operator([table], [], lower, "null_write", is_output=True)
