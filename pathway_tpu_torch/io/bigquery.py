"""pw.io.bigquery — BigQuery output connector (reference:
python/pathway/io/bigquery — streaming inserts per commit)."""

from __future__ import annotations

from pathway_tpu_torch.internals.parse_graph import G


def write(table, dataset_name: str, table_name: str, *,
          service_user_credentials_file: str | None = None,
          name: str | None = None, **kwargs) -> None:
    from google.cloud import bigquery

    if service_user_credentials_file is not None:
        client = bigquery.Client.from_service_account_json(
            service_user_credentials_file
        )
    else:
        client = bigquery.Client()
    target = f"{dataset_name}.{table_name}"
    cols = table.column_names()
    buffer: list[dict] = []

    def on_change(key, row, time_, diff):
        payload = dict(zip(cols, row))
        payload["time"] = time_
        payload["diff"] = diff
        buffer.append(payload)

    def on_time_end(time_):
        if buffer:
            client.insert_rows_json(target, list(buffer))
            buffer.clear()

    def lower(ctx):
        ctx.scope.output(
            ctx.engine_table(table),
            on_change=on_change,
            on_time_end=on_time_end,
        )

    G.add_operator([table], [], lower, "bigquery_write", is_output=True)
