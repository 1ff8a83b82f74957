"""pw.io.slack — Slack output connector (reference: python/pathway/io/slack
— posts one message per inserted row via chat.postMessage)."""

from __future__ import annotations

import json as _json
import logging

from pathway_tpu_torch.io.http._client import write as _http_write

_log = logging.getLogger("pathway_tpu_torch.io.slack")


def send_alerts(alerts, slack_alert_channel_id: str, slack_alert_token: str,
                *, name: str | None = None, **kwargs) -> None:
    """Post each inserted row as a Slack message (reference: io/slack
    send_alerts — accepts a ColumnReference or a single-column table)."""
    from pathway_tpu_torch.internals.expression import ColumnReference

    if isinstance(alerts, ColumnReference):
        alerts = alerts.table.select(alerts)
    cols = alerts.column_names()

    def payload(data: dict, diff: int):
        if diff <= 0:
            return None  # alerts fire on insertion only
        values = {c: data[c] for c in cols}
        text = (
            str(values[cols[0]])
            if len(cols) == 1
            else _json.dumps(values, default=str)
        )
        return _json.dumps(
            {"channel": slack_alert_channel_id, "text": text}
        ).encode()

    def check(body: bytes) -> None:
        # Slack returns API failures as ok:false over HTTP 200
        try:
            out = _json.loads(body)
        except Exception:
            return
        if not out.get("ok", True):
            _log.warning("slack postMessage failed: %s", out.get("error"))

    _http_write(
        alerts,
        "https://slack.com/api/chat.postMessage",
        method="POST",
        headers={"Authorization": f"Bearer {slack_alert_token}"},
        payload_fn=payload,
        response_check=check,
        n_retries=2,
    )


write = send_alerts
