"""Plan Doctor — static analysis over the captured dataflow plan.

``pw.analyze(...)`` walks the ParseGraph/operator plan WITHOUT executing
it and emits structured diagnostics (severity, node provenance, fix
hint): fusion blame (which expression/UDF/id= broke the NativeBatch
fused chain), exchange safety (future-time emitters forcing negotiated
frontiers, quiesce-guarded multi-input nodes, elidable gather legs),
replay/retraction safety (non-deterministic UDFs feeding exchanged or
persisted columns), and PATHWAY_* knob validation.

The eligibility predicates in ``analysis.eligibility`` are THE predicates
the executor nodes use at construction time — analyzer and engine cannot
drift (the differential-dataflow stance: operator properties must be
decidable from the plan). The same stance applied to concurrency:
``analysis.meshcheck`` exhaustively model-checks the mesh wave/rollback
protocol by driving the SAME transition table
(``parallel/protocol.py``) the runtime executes, and multi-rank
``pw.analyze`` calls report its distributed-safety verdicts.

The Device Doctor (``analysis.device_plan``) answers the device
questions the same way: it traces the chains the dispatch sites launch
(ingest, index write and search, encoder forward) on meta tensors, with
no launch and no allocation on the card.

CLI: ``python -m pathway_tpu_torch.analysis program.py [--json]
[--processes N] [--require-fused]``, ``--device-plan`` for the Device
Doctor, and ``--bench [--update-artifact PATH]`` to annotate a bench
artifact's entries with plan verdicts.

Attribute access is lazy: engine/nodes.py imports
``analysis.eligibility`` at module load, so this package __init__ must
not pull the analyzer (which needs engine.nodes) eagerly.
"""

from __future__ import annotations

_ATTRS = {
    "Diagnostic": ("pathway_tpu_torch.analysis.analyzer", "Diagnostic"),
    "PlanReport": ("pathway_tpu_torch.analysis.analyzer", "PlanReport"),
    "analyze": ("pathway_tpu_torch.analysis.analyzer", "analyze"),
    "analyze_scope": ("pathway_tpu_torch.analysis.analyzer", "analyze_scope"),
    "audit_runtime": ("pathway_tpu_torch.analysis.analyzer", "audit_runtime"),
    "NBDecision": ("pathway_tpu_torch.analysis.eligibility", "NBDecision"),
    "NBStrictError": ("pathway_tpu_torch.analysis.eligibility", "NBStrictError"),
    "eligibility": ("pathway_tpu_torch.analysis.eligibility", None),
    "knobs": ("pathway_tpu_torch.analysis.knobs", None),
    "bench": ("pathway_tpu_torch.analysis.bench", None),
    "meshcheck": ("pathway_tpu_torch.analysis.meshcheck", None),
    "MeshCheckConfig": (
        "pathway_tpu_torch.analysis.meshcheck", "MeshCheckConfig",
    ),
    "MeshCheckReport": (
        "pathway_tpu_torch.analysis.meshcheck", "MeshCheckReport",
    ),
    "check_mesh": ("pathway_tpu_torch.analysis.meshcheck", "check"),
    "ServeCheckConfig": (
        "pathway_tpu_torch.analysis.meshcheck", "ServeCheckConfig",
    ),
    "ServeCheckReport": (
        "pathway_tpu_torch.analysis.meshcheck", "ServeCheckReport",
    ),
    "check_serving": ("pathway_tpu_torch.analysis.meshcheck", "check_serving"),
    "KNOBS": ("pathway_tpu_torch.analysis.knobs", "KNOBS"),
    "KnobError": ("pathway_tpu_torch.analysis.knobs", "KnobError"),
    "knob_table_markdown": (
        "pathway_tpu_torch.analysis.knobs", "knob_table_markdown",
    ),
    "validate_environment": (
        "pathway_tpu_torch.analysis.knobs", "validate_environment",
    ),
}

__all__ = sorted(_ATTRS)


def __getattr__(name: str):
    import importlib

    try:
        mod_name, attr = _ATTRS[name]
    except KeyError:
        raise AttributeError(
            f"module 'pathway_tpu_torch.analysis' has no attribute {name!r}"
        ) from None
    mod = importlib.import_module(mod_name)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(list(globals().keys()) + list(_ATTRS.keys())))
