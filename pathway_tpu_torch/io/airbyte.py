"""pw.io.airbyte — Airbyte-catalog sources (reference:
python/pathway/io/airbyte/__init__.py:1-341 + io/airbyte/logic.py +
vendored third_party/airbyte_serverless).

Docker-less execution is first-class: declarative (YAML-manifest) sources
and plain executables speaking the Airbyte protocol run with the standard
library alone; the venv path installs ``airbyte-<name>`` from PyPI; only
image-only connectors still require a local Docker runtime (the
reference's own constraint for non-Python connectors)."""

from __future__ import annotations

import json
import logging
import time as _time
from typing import Any, Sequence

from pathway_tpu_torch.internals.api import Json
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io._airbyte import (
    AirbyteSourceError,
    DeclarativeAirbyteSource,
    DockerAirbyteSource,
    ExecutableAirbyteSource,
    VenvAirbyteSource,
)


class _AirbyteRecordSchema(Schema):
    data: Json


def _load_connection(config_file_path: str) -> dict:
    from pathway_tpu_torch.internals.yaml_loader import load_yaml

    with open(config_file_path) as f:
        cfg = load_yaml(f)
    if not isinstance(cfg, dict) or "source" not in cfg:
        raise ValueError(
            f"{config_file_path}: expected a connection file with a "
            "'source' section (pathway airbyte create-source layout)"
        )
    return cfg


def _construct_source(
    source_cfg: dict,
    streams: Sequence[str],
    env_vars: dict | None,
    enforce_method: str | None,
    config_dir: str,
):
    import os

    config = source_cfg.get("config")
    if "manifest" in source_cfg or "manifest_path" in source_cfg:
        manifest = source_cfg.get("manifest")
        if manifest is None:
            from pathway_tpu_torch.internals.yaml_loader import load_yaml

            path = source_cfg["manifest_path"]
            if not os.path.isabs(path):
                path = os.path.join(config_dir, path)
            with open(path) as f:
                manifest = load_yaml(f)
        return DeclarativeAirbyteSource(manifest, config=config, streams=streams)
    if "executable" in source_cfg:
        return ExecutableAirbyteSource(
            source_cfg["executable"], config=config, streams=streams,
            env_vars=env_vars,
        )
    image = source_cfg.get("docker_image")
    if image is None:
        raise ValueError(
            "source section needs one of: manifest / manifest_path, "
            "executable, docker_image"
        )
    connector = image.removeprefix("airbyte/").partition(":")[0]
    if enforce_method == "pypi":
        return VenvAirbyteSource(
            connector, config=config, streams=streams, env_vars=env_vars
        )
    if enforce_method == "docker":
        return DockerAirbyteSource(
            image, config=config, streams=streams, env_vars=env_vars
        )
    # auto: prefer the python package when PyPI is reachable, else docker
    try:
        return VenvAirbyteSource(
            connector, config=config, streams=streams, env_vars=env_vars
        )
    except (AirbyteSourceError, OSError) as exc:
        logging.getLogger(__name__).info(
            "airbyte: venv path unavailable (%s); trying docker", exc
        )
        return DockerAirbyteSource(
            image, config=config, streams=streams, env_vars=env_vars
        )


def read(
    config_file_path: str,
    streams: Sequence[str],
    *,
    mode: str = "streaming",
    execution_type: str = "local",
    env_vars: dict | None = None,
    enforce_method: str | None = None,
    refresh_interval_ms: int = 60000,
    name: str | None = None,
    **kwargs,
):
    """Returns a table with a ``data`` Json column per Airbyte record
    (reference: io/airbyte/__init__.py read). Incremental streams carry
    their Airbyte STATE between syncs; with persistence configured the
    state also survives restarts (snapshot_state/seek protocol)."""
    import os

    from pathway_tpu_torch.io import python as io_python

    if execution_type not in ("local", "remote"):
        raise ValueError(
            "pw.io.airbyte: execution_type must be 'local' or 'remote'"
        )
    cfg = _load_connection(config_file_path)
    if execution_type == "local" and (
        "remote_runner_url" in kwargs or "remote_runner_token" in kwargs
    ):
        # a remote runner configured while running locally means data
        # would silently leave the intended execution boundary — refuse
        raise ValueError(
            "remote_runner_url/remote_runner_token were given but "
            "execution_type is 'local'; pass execution_type='remote'"
        )
    if execution_type == "remote":
        # provider-neutral HTTPS runner (the reference's remote mode runs
        # on GCP Cloud Run — python/pathway/io/airbyte/__init__.py); the
        # endpoint comes from the kwarg or the connection file's
        # `remote_runner` section
        from pathway_tpu_torch.io._airbyte import RemoteAirbyteSource

        runner = kwargs.pop("remote_runner_url", None) or (
            cfg.get("remote_runner") or {}
        ).get("url")
        token = kwargs.pop("remote_runner_token", None) or (
            cfg.get("remote_runner") or {}
        ).get("token")
        if not runner:
            raise ValueError(
                "execution_type='remote' needs remote_runner_url= or a "
                "remote_runner: {url: ...} section in the connection file"
            )
        source = RemoteAirbyteSource(
            runner, cfg["source"], streams, env_vars, token
        )
    else:
        source = _construct_source(
            cfg["source"],
            streams,
            env_vars,
            enforce_method,
            os.path.dirname(os.path.abspath(config_file_path)),
        )

    class _AirbyteSubject(io_python.ConnectorSubject):
        _deletions_enabled = False

        def __init__(self):
            super().__init__()
            self._state: Any = None  # LEGACY whole-state blob
            self._stream_states: dict[str, Any] = {}
            # full-refresh streams re-deliver everything each sync; the
            # subject diffs each sync against the previous snapshot so the
            # table stays a faithful mirror instead of accumulating
            # duplicates (content-keyed upsert/retract)
            self._prev_snapshot: dict[Any, dict] = {}
            self._cur_snapshot: dict[Any, dict] = {}

        # persistence protocol: the Airbyte state IS the scan state
        def snapshot_state(self):
            return {
                "state": self._state,
                "streams": self._stream_states,
                "snapshot": dict(self._prev_snapshot),
            }

        def seek(self, state) -> None:
            self._state = state.get("state")
            self._stream_states = dict(state.get("streams") or {})
            self._prev_snapshot = dict(state.get("snapshot") or {})

        def _compose_state(self) -> dict | None:
            if not self._stream_states:
                return self._state
            return {
                "type": "GLOBAL",
                "global": {
                    "stream_states": [
                        {
                            "stream_descriptor": {"name": sname},
                            "stream_state": st,
                        }
                        for sname, st in self._stream_states.items()
                    ],
                },
            }

        def _handle_state(self, payload: dict) -> None:
            # reference: io/airbyte/logic.py — LEGACY / GLOBAL / STREAM
            state_type = payload.get("type", "LEGACY")
            if state_type == "LEGACY":
                self._state = payload.get("data")
            elif state_type == "GLOBAL":
                for entry in payload.get("global", {}).get(
                    "stream_states", []
                ):
                    self._stream_states[
                        entry["stream_descriptor"]["name"]
                    ] = entry.get("stream_state", {})
            elif state_type in ("STREAM", "PER_STREAM"):
                entry = payload.get("stream", {})
                self._stream_states[
                    entry["stream_descriptor"]["name"]
                ] = entry.get("stream_state", {})
            else:
                logging.getLogger(__name__).warning(
                    "airbyte: unknown state type %r ignored", state_type
                )

        def _record_key(self, stream: str, data) -> Any:
            from pathway_tpu_torch.internals.api import ref_scalar

            return ref_scalar(
                "airbyte", stream, json.dumps(data, sort_keys=True, default=str)
            )

        def _one_sync(self) -> int:
            n = 0
            saw_state = False
            self._cur_snapshot = {}
            for message in source.extract(self._compose_state()):
                mtype = message.get("type")
                if mtype == "RECORD":
                    stream = message["record"].get("stream", "")
                    data = message["record"].get("data")
                    key = self._record_key(stream, data)
                    self._cur_snapshot[key] = data
                    if key not in self._prev_snapshot:
                        self._upsert(key, {"data": Json(data)})
                    n += 1
                elif mtype == "STATE":
                    saw_state = True
                    self._handle_state(message["state"])
                    self.commit()
            # snapshot diff: rows the source stopped reporting retract.
            # Incremental (STATE-carrying) sources deliver only new rows
            # per sync, so their previous rows must NOT retract — the
            # union of all syncs is the table.
            if saw_state:
                self._prev_snapshot.update(self._cur_snapshot)
            else:
                for key, data in self._prev_snapshot.items():
                    if key not in self._cur_snapshot:
                        self._remove(key, {"data": Json(data)})
                self._prev_snapshot = self._cur_snapshot
            self.commit()
            return n

        def run(self):
            if mode == "static":
                self._one_sync()
                return
            failures = 0
            while not self._finished:
                try:
                    self._one_sync()
                    failures = 0
                except Exception:
                    # transient source failures retry with the refresh
                    # cadence (reference: io/airbyte MAX_RETRIES=5)
                    failures += 1
                    if failures >= 5:
                        raise
                    logging.getLogger(__name__).warning(
                        "airbyte: sync failed (%d/5), retrying", failures,
                        exc_info=True,
                    )
                _time.sleep(refresh_interval_ms / 1000.0)

        def on_stop(self):
            source.on_stop()

    return io_python.read(
        _AirbyteSubject(),
        schema=_AirbyteRecordSchema,
        autocommit_duration_ms=None,
        name=name or f"airbyte:{os.path.basename(config_file_path)}",
    )
