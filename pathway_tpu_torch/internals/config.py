"""Environment-first configuration (reference:
python/pathway/internals/config.py:57-97 PathwayConfig — PATHWAY_* env
vars; engine mirror src/engine/dataflow/config.rs:88 Config::from_env).

The worker topology (SURVEY §2.9): PATHWAY_THREADS ~ data-parallel shards
within a host, PATHWAY_PROCESSES ~ hosts of the cluster.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_field(name: str, default: str | None = None):
    return field(default_factory=lambda: os.environ.get(name, default))


def _env_bool_field(name: str, default: str = "false"):
    def factory() -> bool:
        # strip() mirrors the knob registry's Knob.check — the two must
        # accept the same value set or _load_config's except-ValueError
        # routing re-raises the raw factory error without a KnobError
        value = os.environ.get(name, default).strip().lower()
        if value in ("1", "true", "yes"):
            return True
        if value in ("0", "false", "no"):
            return False
        raise ValueError(f"unexpected value for {name!r}: {value!r}")

    return field(default_factory=factory)


def _env_int_field(name: str, default: int):
    return field(
        default_factory=lambda: int(os.environ.get(name, str(default)) or default)
    )


@dataclass
class PathwayConfig:
    threads: int = _env_int_field("PATHWAY_THREADS", 1)
    processes: int = _env_int_field("PATHWAY_PROCESSES", 1)
    process_id: int = _env_int_field("PATHWAY_PROCESS_ID", 0)
    first_port: int = _env_int_field("PATHWAY_FIRST_PORT", 10000)
    run_id: str | None = _env_field("PATHWAY_RUN_ID")
    license_key: str | None = _env_field("PATHWAY_LICENSE_KEY")
    monitoring_server: str | None = _env_field("PATHWAY_MONITORING_SERVER")
    replay_storage: str | None = _env_field("PATHWAY_REPLAY_STORAGE")
    snapshot_access: str | None = _env_field("PATHWAY_SNAPSHOT_ACCESS")
    persistence_mode: str | None = _env_field("PATHWAY_PERSISTENCE_MODE")
    continue_after_replay: bool = _env_bool_field("PATHWAY_CONTINUE_AFTER_REPLAY")
    ignore_asserts: bool = _env_bool_field("PATHWAY_IGNORE_ASSERTS")
    runtime_typechecking: bool = _env_bool_field("PATHWAY_RUNTIME_TYPECHECKING")
    terminate_on_error: bool = _env_bool_field(
        "PATHWAY_TERMINATE_ON_ERROR", "true"
    )

    @property
    def replay_config(self):
        if self.replay_storage is None:
            return None
        from pathway_tpu_torch import persistence

        return persistence.Config(
            backend=persistence.Backend.filesystem(self.replay_storage)
        )


# Constructed LAZILY (first get_pathway_config()/attribute access), not
# at import: `python -m pathway_tpu_torch.analysis` must be able to import the
# package and DIAGNOSE a broken environment rather than crash before its
# own error handling runs (runpy imports the package before __main__).
import threading as _threading

_pathway_config: PathwayConfig | None = None
_config_lock = _threading.Lock()


def _load_config() -> PathwayConfig:
    global _pathway_config
    if _pathway_config is None:
        # double-checked under a lock: connector / emulated-rank threads
        # racing the first load must not each build an instance (the
        # loser's would silently discard set_license_key-style mutations
        # made to the winner's)
        with _config_lock:
            if _pathway_config is None:
                try:
                    _pathway_config = PathwayConfig()
                except ValueError:
                    # a config-backed PATHWAY_* var failed to parse —
                    # route the failure through the knob registry so the
                    # user gets the full did-you-mean/range report
                    # (KnobError) instead of a raw ValueError out of a
                    # field factory. knobs.py is stdlib-only, so this
                    # import cannot cycle back here.
                    from pathway_tpu_torch.analysis.knobs import (
                        enforce_environment,
                    )

                    enforce_environment()
                    raise  # registry considered the env valid: as-is
    return _pathway_config


def __getattr__(name: str):
    # module attribute access (tests monkeypatch C.pathway_config.*)
    if name == "pathway_config":
        return _load_config()
    raise AttributeError(name)

# Per-thread overlay used by the emulated-rank CI lane (scripts/
# ci_lanes.sh): companion ranks run as THREADS of one test process, each
# seeing its own process_id/processes/first_port while the global config
# stays untouched. Real multi-process runs never set this.
import contextvars as _contextvars

_thread_overlay: "_contextvars.ContextVar[dict | None]" = (
    _contextvars.ContextVar("pathway_config_overlay", default=None)
)


class _OverlaidConfig:
    __slots__ = ("_base", "_overlay")

    def __init__(self, base: PathwayConfig, overlay: dict):
        self._base = base
        self._overlay = overlay

    def __getattr__(self, name):
        if name in self._overlay:
            return self._overlay[name]
        return getattr(self._base, name)


def push_config_overlay(**kwargs):
    """Set per-thread config fields; returns a token for reset."""
    return _thread_overlay.set(kwargs)


def pop_config_overlay(token) -> None:
    _thread_overlay.reset(token)


def get_pathway_config() -> PathwayConfig:
    overlay = _thread_overlay.get()
    if overlay:
        return _OverlaidConfig(_load_config(), overlay)  # type: ignore
    return _load_config()


def set_license_key(key: str | None) -> None:
    """reference: pw.set_license_key — entitlements are not enforced in
    this build (no keygen.sh round trips); the key is recorded for config
    surface parity."""
    _load_config().license_key = key


def set_monitoring_config(*, server_endpoint: str | None = None, **kwargs) -> None:
    _load_config().monitoring_server = server_endpoint


def _check_entitlements(*entitlements: str) -> bool:
    """reference: internals/config.py:105 — always granted here."""
    return True
