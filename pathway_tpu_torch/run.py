"""pw.run — execute all captured output operators (reference:
python/pathway/internals/run.py:12)."""

from __future__ import annotations

from pathway_tpu_torch.internals.graph_runner import GraphRunner


def run(
    *,
    debug: bool = False,
    monitoring_level=None,
    with_http_server: bool = False,
    default_logging: bool = True,
    persistence_config=None,
    runtime_typechecking: bool | None = None,
    terminate_on_error: bool = True,
    profile: str | None = None,
    _interactive_bypass: bool = False,
    **kwargs,
) -> None:
    """profile: directory path — wraps the run in a ``torch.profiler``
    trace (host events, plus the card's kernel timeline when CUDA is
    available) written there as a Chrome/Perfetto trace file, the
    profiler analog of the reference's DIFFERENTIAL_LOG_ADDR event
    stream (SURVEY §5 tracing). Under ``PATHWAY_TRACE`` the flight
    recorder's tracks (node spans, the serve and ingest paths' spans,
    dispatch records) are added to that file, placed on the profiler's
    clock by the ``pathway.clock`` annotation the device plane emits when
    it is armed."""
    from pathway_tpu_torch.internals.interactive import (
        interactive_mode_enabled,
        start as _interactive_start,
    )

    if interactive_mode_enabled() and not _interactive_bypass:
        _interactive_start(
            persistence_config=persistence_config,
            terminate_on_error=terminate_on_error,
            monitoring_level=monitoring_level,
            with_http_server=with_http_server,
            **kwargs,
        )
        return
    runner = GraphRunner(
        terminate_on_error=terminate_on_error,
        persistence_config=persistence_config,
        with_http_server=with_http_server,
        monitoring_level=monitoring_level,
    )
    if profile is not None:
        import os

        import torch
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as _profile

        # fail loudly on a bad profile path: a trace that cannot be
        # written would otherwise surface only after the whole run, or
        # as a "successful" run with no artifact
        profile = os.path.abspath(profile)
        if os.path.exists(profile) and not os.path.isdir(profile):
            raise NotADirectoryError(
                f"profile={profile!r} exists and is not a directory — "
                "pw.run(profile=...) needs a directory for the "
                "profiler's trace files"
            )
        os.makedirs(profile, exist_ok=True)  # raises on unwritable paths
        if not os.access(profile, os.W_OK):
            raise PermissionError(
                f"profile directory {profile!r} is not writable"
            )
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        from pathway_tpu_torch.internals.flight import (
            merge_into_profiler_trace,
            trace_path,
        )

        with _profile(activities=activities) as prof:
            runner.run_outputs()
        out = os.path.join(profile, f"pw_run.{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(out)
        merge_into_profiler_trace(out, trace_path())
        return
    runner.run_outputs()


def run_all(**kwargs) -> None:
    run(**kwargs)
