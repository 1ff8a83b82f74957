"""Device Doctor — static dispatch-plane analysis, on torch.

Plan Doctor pass 6: for every registered device site reachable from the
lowered plan (``internals/device.py`` site registry — encoder forward,
fused ingest, KNN scan/write, the fused KNN kernel pair, sharded
search/write), the chain is traced with ``make_fx`` on **meta tensors**
under the declared knob/mesh config — a meta tensor has a shape and a
dtype and no storage, so nothing launches, nothing is allocated and CUDA
is never touched — and five checks emit provenance-carrying diagnostics:

1. **in-place audit** (code ``device.donation``, the JAX package's name
   for the same guarantee) — the index write must mutate the buffer
   triple it was given: the traced graph must hold an in-place op
   (``index_copy_`` / ``index_put_``) whose written argument IS each
   buffer input. A write that lands in a copy is blamed with the device
   bytes it copies per dispatch.
2. **host-sync audit** — device→host reads inside the steady chain:
   ``.item()``, ``.tolist()``, ``.cpu()`` or ``bool(t)`` abort a meta
   trace (there is no data to read: ``aten._local_scalar_dense`` or a
   copy out of a meta tensor) — the static cause of the observatory's
   host-bound verdicts. The diagnostic names the read and the fix.
3. **retrace audit** — enumerate the shape-bucket set the declared
   workload implies through the SAME bucket functions the dispatch
   sites pad with (``internals/device.py`` — identity-pinned by tests),
   flag unbounded or excessive sets, and predict
   ``device_site_recompiles_total`` per site. On the card a new bucket at
   ``encoder.forward`` or ``ingest.fused`` is one captured CUDA graph.
   The fused KNN kernel pair (``knn.fused``, the JAX package's
   ``pallas.topk``) is a retrace model only: a kernel bound through
   ctypes does not trace.
4. **static device-memory budget** — per-card footprint (index shards +
   free-lists + double-buffered ingest staging + encoder params +
   snapshot staging) from shapes/dtypes and the mesh layout, vs
   ``device_hbm_bytes()`` (the card's ``total_memory``;
   ``PATHWAY_DEVICE_HBM_BYTES`` on a CPU host) — a layout that cannot
   hold the declared corpus is refused before the runtime OOM path ever
   fires.
5. **mesh-layout check** — shard count vs world vs the pow2 tree-merge
   requirement.

Like eligibility.py, the functions the checks trace are the same
objects the runtime sites call: ``fused_chain`` (ops/ingest.py),
``write_slots``/``search_topk`` (ops/knn.py), ``sharded_write_slots``/
``sharded_topk`` (parallel/sharded_knn.py) and the shared bucket/cost
models in ``internals/device.py``. ``join_profile`` joins measured
recompiles from a ``--profile`` trace onto the static predictions with a
predicted-vs-measured drift verdict.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from pathway_tpu_torch.analysis.analyzer import SEVERITIES, Diagnostic

MUTANTS = ("undonated_write", "host_sync", "unbounded_buckets", "over_budget")

# what a meta trace raises when the chain reads a device value on the host
_HOST_READ_MARKERS = (
    "_local_scalar_dense",       # .item(), bool(t), float(t)
    "cannot copy out of meta",   # .cpu(), .tolist(), .numpy()
)


def _max_buckets() -> int:
    raw = os.environ.get("PATHWAY_DEVICE_PLAN_MAX_BUCKETS", "")
    try:
        v = int(raw) if raw.strip() else 64
    except ValueError:
        v = 64
    return max(1, v)


# -- declared workload -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """The declared steady-state workload the retrace/HBM checks analyze
    under. ``ingest_batches`` are (rows, token_len) per fused-ingest
    dispatch; ``write_batches`` are direct index-write row counts;
    queries arrive in ``query_batches`` sizes asking ``ks`` neighbors,
    searched at ``precision`` ("highest" or "default", the shard's).
    ``bounded=False`` declares the batch/shape distribution unbounded —
    exactly the retrace-storm defect the audit refuses."""

    ingest_batches: tuple = ((64, 40), (64, 72), (32, 40))
    write_batches: tuple = (64, 64)
    query_batches: tuple = (1, 8)
    ks: tuple = (10,)
    corpus_rows: int = 4096
    batch_cap: int = 256          # encoder batch_size (pow2 bucket cap)
    initial_capacity: int = 128
    chunk: int | None = None
    depth: int = 2                # tokenize-ahead staging depth
    bounded: bool = True
    precision: str = "highest"

    def __post_init__(self):
        from pathway_tpu_torch.ops.topk import check_precision

        check_precision(self.precision)


# -- report ------------------------------------------------------------------


@dataclasses.dataclass
class DevicePlanReport:
    """Structured result of one Device Doctor run."""

    verdict: str                  # "device-clean"|"device-degraded"|"device-dirty"
    world: int
    chains: dict = dataclasses.field(default_factory=dict)
    predictions: dict = dataclasses.field(default_factory=dict)
    hbm: dict = dataclasses.field(default_factory=dict)
    diagnostics: list = dataclasses.field(default_factory=list)

    @property
    def device_clean(self) -> bool:
        return self.verdict == "device-clean"

    def errors(self) -> list:
        return [d for d in self.diagnostics if d.severity == "error"]

    def to_dict(self) -> dict:
        counts = {s: 0 for s in SEVERITIES}
        for d in self.diagnostics:
            counts[d.severity] += 1
        return {
            "schema": "pathway_tpu_torch.analysis.device/v1",
            "verdict": self.verdict,
            "world": self.world,
            "chains": self.chains,
            "predictions": {
                site: {
                    "buckets": sorted(map(list, p["buckets"])),
                    "recompiles": p["recompiles"],
                    **({"measured_recompiles": p["measured_recompiles"],
                        "drift": p["drift"]}
                       if "drift" in p else {}),
                    **({"bound_ms": p["bound_ms"]} if "bound_ms" in p else {}),
                }
                for site, p in self.predictions.items()
            },
            "hbm": self.hbm,
            "summary": {"diagnostics": counts},
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def to_json(self, **kwargs) -> str:
        kwargs.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kwargs)

    def render(self) -> str:
        lines = [
            f"device plan verdict: {self.verdict.upper()} "
            f"(world={self.world})"
        ]
        for name, verdict in sorted(self.chains.items()):
            mark = {"clean": "+", "degraded": "!", "dirty": "-"}.get(
                verdict, "?"
            )
            lines.append(f"  [{mark}] chain {name:<10} {verdict}")
        for site, p in sorted(self.predictions.items()):
            drift = (
                f"  measured={p['measured_recompiles']} drift={p['drift']}"
                if "drift" in p else ""
            )
            lines.append(
                f"  site {site:<20} buckets={len(p['buckets'])} "
                f"predicted_recompiles={p['recompiles']}{drift}"
            )
        if self.hbm:
            lines.append(
                f"  hbm: footprint={self.hbm.get('footprint_bytes', 0):.3e} "
                f"budget={self.hbm.get('budget_bytes', 0):.3e} "
                f"({self.hbm.get('share', 0.0):.1%} of one card)"
            )
        for d in self.diagnostics:
            lines.append(d.render())
        return "\n".join(lines)


# -- tracing helpers (meta tensors: no launch, no allocation) ----------------


def meta(shape, dtype) -> Any:
    """A meta tensor: shape and dtype, no storage, no device."""
    import torch

    return torch.empty(shape, dtype=dtype, device="meta")


def trace_chain(fn, args: tuple):
    """``make_fx`` graph of ``fn(*args)`` over meta tensors. Every tensor
    argument is a placeholder of the graph, in order; nothing runs."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    with torch.no_grad():
        return make_fx(fn)(*args)


def _is_host_read(exc: BaseException) -> bool:
    low = f"{type(exc).__name__}: {exc}".lower()
    return any(m in low for m in _HOST_READ_MARKERS)


def written_inputs(graph) -> set[int]:
    """Positions of the placeholders an in-place op of the graph writes:
    an op whose schema marks the argument as written (``Tensor(a!)``)
    and whose value at that argument IS the placeholder — not a copy and
    not a view of it."""
    import torch

    places = [n for n in graph.graph.nodes if n.op == "placeholder"]
    pos = {n: i for i, n in enumerate(places)}
    out: set[int] = set()
    for node in graph.graph.nodes:
        target = node.target
        if node.op != "call_function" or not isinstance(
            target, torch._ops.OpOverload
        ):
            continue
        for i, arg in enumerate(target._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
            if val in pos:
                out.add(pos[val])
    return out


def _host_sync_check(fn, args: tuple, site: str, where: str, diags: list):
    """Trace ``fn`` on meta tensors and audit it for host syncs. Returns
    the graph when the chain traced clean; a host read (a meta tensor has
    no data, so the trace aborts on it) emits the diagnostic and returns
    None."""
    try:
        return trace_chain(fn, args)
    except Exception as exc:
        if not _is_host_read(exc):
            raise
        kind = type(exc).__name__
        diags.append(Diagnostic(
            code="device.host_sync",
            severity="error",
            node=site,
            message=(
                f"the steady chain forces a device->host sync while "
                f"tracing ({kind}): a `.item()` / `.tolist()` / `.cpu()` / "
                f"`bool(t)` on a device value blocks the launch queue "
                f"every call — the static cause of a host-bound roofline "
                f"verdict"
            ),
            hint=(
                "keep the chain on the device: replace host reads with "
                "tensor ops (torch.where, masks), and move scalar "
                "extraction after the chain's last launch"
            ),
            where=where,
        ))
        return None


def _inplace_check(
    graph, buffers: tuple, buffer_bytes: float, site: str, where: str,
    diags: list,
) -> bool:
    """Every buffer input (placeholder positions ``buffers``) must be
    written in place by the traced chain. Returns True when it is; a
    write that lands in a copy is blamed with the per-dispatch device
    copy cost."""
    missing = sorted(set(buffers) - written_inputs(graph))
    if not missing:
        return True
    mb = buffer_bytes / 1e6
    diags.append(Diagnostic(
        code="device.donation",
        severity="error",
        node=site,
        message=(
            "the index/ingest buffer triple is written out of place: "
            f"inputs {missing} of the traced chain are never the target "
            "of an in-place op (the write lands in a copy), so every "
            f"dispatch pays a ~{mb:.2f} MB device copy of the buffer "
            "triple and doubles its steady footprint"
        ),
        hint=(
            "write the index's own tensors in place (index_copy_ / "
            "index_put_, as ops/knn.py write_slots does) — never into a "
            "clone or through a functional index_copy"
        ),
        where=where,
    ))
    return False


# -- retrace audit (shared bucket enumeration) -------------------------------


def simulate_ingest_buckets(
    spec: WorkloadSpec, cfg, *, wire_dtype: str | None = None
) -> set:
    """The ``ingest.fused`` shape set the declared workload implies —
    computed through the SAME bucket functions the pipeline pads with
    (batch_bucket/seq_bucket/pow2_capacity/ingest_bucket)."""
    from pathway_tpu_torch.internals.device import (
        batch_bucket, ingest_bucket, pow2_capacity, seq_bucket,
    )

    if wire_dtype is None:
        wire_dtype = "uint16" if cfg.vocab_size <= 65536 else "int32"
    cap = pow2_capacity(spec.initial_capacity)
    rows = 0
    out: set = set()
    for n, L in spec.ingest_batches:
        nb = batch_bucket(n, 8, spec.batch_cap)
        Lb = seq_bucket(L, cfg.max_len)
        rows += n
        cap = max(cap, pow2_capacity(rows))
        out.add(ingest_bucket(nb, Lb, cap, wire_dtype))
    return out


def simulate_knn_buckets(spec: WorkloadSpec) -> tuple[set, set]:
    """(write, search) shape sets of the declared workload on a
    single-card shard — the same growth schedule and k clamps the
    runtime applies (pow2_capacity/knn_write_bucket/knn_search_bucket)."""
    from pathway_tpu_torch.internals.device import (
        knn_search_bucket, knn_write_bucket, pow2_capacity,
    )

    cap = pow2_capacity(spec.initial_capacity)
    rows = 0
    wb: set = set()
    for b in spec.write_batches:
        rows += b
        cap = max(cap, pow2_capacity(rows))
        wb.add(knn_write_bucket(b, cap))
    sb: set = set()
    for q in spec.query_batches:
        for k in spec.ks:
            sb.add(knn_search_bucket(q, cap, k, spec.chunk))
    return wb, sb


def simulate_fused_buckets(spec: WorkloadSpec, dim: int) -> set:
    """The ``knn.fused`` launch-plan set: one launch of the kernel pair
    per search, keyed by the raw query rows, the index capacity after the
    declared writes, the dimension, the clamped k and the precision —
    what ``KnnShard.search`` and ``QueryEngine`` hand
    ``fused_topk_scores``."""
    from pathway_tpu_torch.internals.device import (
        fused_knn_bucket, knn_search_bucket,
    )

    _, sb = simulate_knn_buckets(spec)
    cap = max((c for _, c, _ in sb), default=spec.initial_capacity)
    return {
        fused_knn_bucket(q, cap, dim, knn_search_bucket(q, cap, k, spec.chunk)[2],
                         spec.precision)
        for q in spec.query_batches for k in spec.ks
    }


def fused_bounds(buckets: set, rates: dict | None) -> list:
    """The ``knn.fused`` roofline of each predicted launch plan: ``[q,
    cap, d, k, precision, least ms, "bytes" or "operations"]`` on a card
    whose data-sheet peaks ``rates`` are (``peak_rates``; none without
    one) -- 3 TF32 passes for "highest", 1 for "default"."""
    if rates is None:
        return []
    from pathway_tpu_torch.ops.fused_knn import fused_knn_bound

    out = []
    for b in sorted(buckets):
        secs, by = fused_knn_bound(*b, rates)
        out.append([*b, 1e3 * secs, by])
    return out


def simulate_sharded_buckets(
    spec: WorkloadSpec, world: int
) -> tuple[set, set]:
    """(write, search) shape sets of the declared workload on a
    ``world``-shard index (local capacity doubles from 128 to hold each
    shard's rows; the merge/k clamps mirror ShardedKnnIndex.search)."""
    from pathway_tpu_torch.internals.device import (
        pow2_capacity, sharded_search_bucket, sharded_write_bucket,
    )

    local = pow2_capacity(max(1, spec.initial_capacity // max(world, 1)))
    rows = 0
    wb: set = set()
    for b in spec.write_batches:
        rows += b
        # evenly-routed model: every shard holds ~rows/world
        local = max(local, pow2_capacity(-(-rows // max(world, 1))))
        wb.add(sharded_write_bucket(b, world * local))
    sb: set = set()
    for q in spec.query_batches:
        for k in spec.ks:
            sb.add(sharded_search_bucket(q, world, local, k, spec.chunk))
    return wb, sb


def _retrace_audit(
    spec: WorkloadSpec, site: str, buckets: set, where: str,
    diags: list, predictions: dict,
) -> None:
    if not spec.bounded:
        diags.append(Diagnostic(
            code="device.retrace.unbounded",
            severity="error",
            node=site,
            message=(
                "the declared workload has no batch/shape bound: every "
                "novel shape is a fresh CUDA graph capture (or launch "
                "plan) — an unbounded graph set (retrace storm) holding "
                "device memory for each"
            ),
            hint=(
                "declare batch/sequence caps so padding buckets the "
                "shape set (encoder pad_batch, pow2 query padding), or "
                "chunk the stream to a fixed batch size upstream"
            ),
            where=where,
        ))
    cap = _max_buckets()
    if len(buckets) > cap:
        diags.append(Diagnostic(
            code="device.retrace.excessive",
            severity="warning",
            node=site,
            message=(
                f"declared workload implies {len(buckets)} shape buckets "
                f"(> PATHWAY_DEVICE_PLAN_MAX_BUCKETS={cap}): capture time "
                "and graph memory scale with every bucket"
            ),
            hint="coarsen the bucket schedule or narrow the declared "
                 "batch/length distribution",
            where=where,
        ))
    predictions[site] = {
        "buckets": set(buckets),
        "recompiles": len(buckets),
    }


# -- the doctor --------------------------------------------------------------


def analyze_device_plan(
    *,
    workload: WorkloadSpec | None = None,
    world: int = 1,
    config: Any = None,
    mutant: str | None = None,
) -> DevicePlanReport:
    """Run the five static checks over every registered device chain at
    the declared ``world``/workload. ``mutant`` seeds one of the four
    defect classes (tests + the CLI's exit-2 contract); None analyzes
    the shipped chains. Zero execution: chains are traced on meta
    tensors — nothing is launched or allocated, on the card or off it."""
    import numpy as np
    import torch

    from pathway_tpu_torch.internals import device as dev
    from pathway_tpu_torch.models.encoder import (
        EncoderConfig,
        TransformerEncoder,
        encoder_param_bytes,
    )
    from pathway_tpu_torch.ops.ingest import fused_chain
    from pathway_tpu_torch.ops.knn import search_topk, write_slots
    from pathway_tpu_torch.parallel.sharded_knn import (
        sharded_topk,
        sharded_write_slots,
    )

    if mutant is not None and mutant not in MUTANTS:
        raise ValueError(f"unknown device mutant {mutant!r}; one of {MUTANTS}")
    spec = workload or WorkloadSpec()
    if mutant == "unbounded_buckets":
        spec = dataclasses.replace(spec, bounded=False)
    if mutant == "over_budget":
        # a corpus no single card can hold at the declared layout
        spec = dataclasses.replace(spec, corpus_rows=2**31)
    cfg = config or EncoderConfig.tiny()
    world = max(1, int(world))
    diags: list[Diagnostic] = []
    predictions: dict = {}
    chains: dict = {}
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def chain_verdict(before: int) -> str:
        new = diags[before:]
        if any(d.severity == "error" for d in new):
            return "dirty"
        if any(d.severity == "warning" for d in new):
            return "degraded"
        return "clean"

    # the encoder's parameters as meta tensors: its shapes, no weights
    with torch.device("meta"):
        model = TransformerEncoder(cfg).eval()
    d_model = cfg.hidden
    nb = dev.batch_bucket(
        max((n for n, _ in spec.ingest_batches), default=8), 8, spec.batch_cap
    )
    Lb = dev.seq_bucket(
        max((L for _, L in spec.ingest_batches), default=16), cfg.max_len
    )
    cap0 = dev.pow2_capacity(spec.initial_capacity)
    compact = cfg.vocab_size <= 65536

    def triple(cap: int) -> tuple:
        return meta((cap, d_model), f32), meta((cap,), torch.bool), meta((cap,), f32)

    # -- chain: ingest.fused ------------------------------------------------
    mark = len(diags)
    wire = (
        (meta((nb, Lb), torch.int16), meta((nb,), i32)) if compact
        else (meta((nb, Lb), i32), meta((nb, Lb), i32))
    )

    def fused(ids, lengths, idx, vectors, valid, sq_norms):
        if mutant == "undonated_write":
            # the seeded defect: the write lands in copies of the buffers
            vectors, valid, sq_norms = vectors.clone(), valid.clone(), sq_norms.clone()
        emb = fused_chain(
            model, (ids, lengths), compact, nb,
            lambda rows: write_slots(vectors, valid, sq_norms, idx, rows, True),
        )
        if mutant == "host_sync":
            # the seeded defect: a mid-chain scalar read forces a
            # device->host sync on every dispatch
            emb = emb * emb.sum().item()
        return emb

    ingest_where = "pathway_tpu_torch/ops/ingest.py:fused_chain"
    graph = _host_sync_check(
        fused, (*wire, meta((nb,), i64), *triple(cap0)), "ingest.fused",
        ingest_where, diags,
    )
    if graph is not None:
        _inplace_check(
            graph, (3, 4, 5), dev.index_shard_bytes(cap0, d_model),
            "ingest.fused", ingest_where, diags,
        )
    _retrace_audit(
        spec, "ingest.fused",
        simulate_ingest_buckets(spec, cfg), ingest_where, diags, predictions,
    )
    chains["ingest"] = chain_verdict(mark)

    # -- chain: knn.write / knn.search --------------------------------------
    mark = len(diags)
    knn_where = "pathway_tpu_torch/ops/knn.py"
    wb, sb = simulate_knn_buckets(spec)
    write_rows = max(spec.write_batches, default=64)

    def write(vectors, valid, sq_norms, idx, rows):
        write_slots(vectors, valid, sq_norms, idx, rows, True, normalize=True)

    graph = _host_sync_check(
        write,
        (*triple(cap0), meta((write_rows,), i64), meta((write_rows, d_model), f32)),
        "knn.write", knn_where + ":write_slots", diags,
    )
    if graph is not None:
        _inplace_check(
            graph, (0, 1, 2), dev.index_shard_bytes(cap0, d_model),
            "knn.write", knn_where + ":write_slots", diags,
        )
    if sb:
        qn, scap, k_eff = max(sb)
        _host_sync_check(
            lambda q, v, m, s: search_topk(q, v, m, s, k_eff, "dot", spec.precision),
            (meta((qn, d_model), f32), *triple(scap)),
            "knn.search", knn_where + ":search_topk", diags,
        )
    _retrace_audit(spec, "knn.write", wb, knn_where + ":KnnShard.add",
                   diags, predictions)
    _retrace_audit(spec, "knn.search", sb, knn_where + ":KnnShard.search",
                   diags, predictions)
    chains["knn"] = chain_verdict(mark)

    # -- chain: sharded write/search + mesh layout --------------------------
    mark = len(diags)
    sh_where = "pathway_tpu_torch/parallel/sharded_knn.py"
    swb, ssb = simulate_sharded_buckets(spec, world)
    # the traced chain is one shard's (the chain is the same function per
    # shard); the declared-world checks below are pure-model
    slots = np.arange(write_rows, dtype=np.int64) % cap0

    def sharded_write(vectors, valid, sq_norms, rows):
        sharded_write_slots(
            [vectors], [valid], [sq_norms], cap0, slots, rows, True,
            normalize=True,
        )

    graph = _host_sync_check(
        sharded_write, (*triple(cap0), meta((write_rows, d_model), f32)),
        "knn.sharded_write", sh_where + ":sharded_write_slots", diags,
    )
    if graph is not None:
        _inplace_check(
            graph, (0, 1, 2), dev.index_shard_bytes(cap0, d_model),
            "knn.sharded_write", sh_where + ":sharded_write_slots", diags,
        )
    if ssb:
        qn, _, k_eff = max(ssb)
        k_s = min(k_eff, cap0)
        _host_sync_check(
            lambda q, v, m: sharded_topk(
                q, [v], [m], k_s, merge="gather", local_cap=cap0
            ),
            (meta((qn, d_model), f32), *triple(cap0)[:2]),
            "knn.sharded_search", sh_where + ":sharded_topk", diags,
        )
    # declared-world mesh model (pure — no device needed)
    merge_raw = str(
        os.environ.get("PATHWAY_INDEX_MERGE", "auto")
    ).strip().lower()
    pow2 = world & (world - 1) == 0
    if merge_raw == "tree" and not pow2:
        diags.append(Diagnostic(
            code="device.mesh.merge",
            severity="warning",
            node="knn.sharded_search",
            message=(
                f"PATHWAY_INDEX_MERGE=tree requires a pow2 shard count; "
                f"world={world} silently degrades to gather (one merge of "
                f"every shard's partial on the first card)"
            ),
            hint="use a pow2 world for the index axis or set "
                 "PATHWAY_INDEX_MERGE=auto",
            where=sh_where + ":ShardedKnnIndex.search",
        ))
    _retrace_audit(spec, "knn.sharded_write", swb,
                   sh_where + ":ShardedKnnIndex.add", diags, predictions)
    _retrace_audit(spec, "knn.sharded_search", ssb,
                   sh_where + ":ShardedKnnIndex.search", diags, predictions)
    chains["sharded"] = chain_verdict(mark)

    # -- chain: encoder.forward ---------------------------------------------
    mark = len(diags)
    enc_where = ("pathway_tpu_torch/models/encoder.py:"
                 "SentenceEncoder.encode_tokens_device")
    _host_sync_check(
        lambda ids, mask: model(ids, mask),
        (meta((nb, Lb), i64), meta((nb, Lb), i32)),
        "encoder.forward", enc_where, diags,
    )
    enc_buckets = {
        dev.encoder_bucket(
            dev.batch_bucket(n, 8, spec.batch_cap),
            dev.seq_bucket(L, cfg.max_len),
            compact,
        )
        for n, L in spec.ingest_batches
    }
    _retrace_audit(spec, "encoder.forward", enc_buckets, enc_where, diags,
                   predictions)
    chains["encoder"] = chain_verdict(mark)

    # -- chain: knn.fused (retrace model only — the kernel pair is bound
    # through ctypes and does not trace; its plain twin is knn.search's) --
    mark = len(diags)
    fused = simulate_fused_buckets(spec, d_model)
    _retrace_audit(
        spec, "knn.fused", fused,
        "pathway_tpu_torch/ops/fused_knn.py:fused_topk_scores", diags,
        predictions,
    )
    bounds = fused_bounds(fused, dev.peak_rates())
    if bounds:
        predictions["knn.fused"]["bound_ms"] = bounds
    chains["fused"] = chain_verdict(mark)

    # -- static device-memory budget ----------------------------------------
    per_chip_rows = -(-spec.corpus_rows // world)
    per_chip_cap = dev.pow2_capacity(per_chip_rows)
    donation_ok = not any(
        d.code == "device.donation" for d in diags
    )
    index_b = dev.index_shard_bytes(
        per_chip_cap, d_model, donated=donation_ok
    )
    freelist_b = 8.0 * per_chip_cap  # host slot free-list + freed-epoch
    staging_b = dev.ingest_staging_bytes(
        nb, Lb, 2 if compact else 4, depth=spec.depth
    )
    params_b = encoder_param_bytes(cfg)
    snap_b = dev.snapshot_staging_bytes(per_chip_cap, d_model)
    footprint = index_b + freelist_b + staging_b + params_b + snap_b
    budget = float(dev.device_hbm_bytes())
    hbm = {
        "world": world,
        "per_chip_capacity": per_chip_cap,
        "index_bytes": index_b,
        "freelist_bytes": freelist_b,
        "ingest_staging_bytes": staging_b,
        "encoder_param_bytes": params_b,
        "snapshot_staging_bytes": snap_b,
        "footprint_bytes": footprint,
        "budget_bytes": budget,
        "share": footprint / budget if budget else 0.0,
        "donated": donation_ok,
    }
    if footprint > budget:
        diags.append(Diagnostic(
            code="device.hbm.over_budget",
            severity="error",
            node="knn.write" if world == 1 else "knn.sharded_write",
            message=(
                f"declared corpus of {spec.corpus_rows} rows needs "
                f"{footprint:.3e} bytes/card (index {index_b:.3e} + "
                f"staging {staging_b:.3e} + params {params_b:.3e} + "
                f"snapshot {snap_b:.3e}) but the device budget is "
                f"{budget:.3e} bytes — this layout OOMs before serving"
            ),
            hint=(
                "shard over more cards (capacity scales with the mesh), "
                "shrink the declared corpus, or raise "
                "PATHWAY_DEVICE_HBM_BYTES if the budget model is wrong "
                "for this hardware"
            ),
            where=sh_where + ":ShardedKnnIndex",
        ))
        chains["sharded" if world > 1 else "knn"] = "dirty"

    # -- registry coverage ---------------------------------------------------
    for name, site in sorted(dev.registered_sites().items()):
        if not callable(site.cost_model) or not isinstance(
            site.dtypes, tuple
        ):
            diags.append(Diagnostic(
                code="device.registry",
                severity="error",
                node=name,
                message="registered device site lacks a callable cost "
                        "model / dtype tuple (registry drift)",
                hint="register via device_site(name, cost_model=..., "
                     "dtypes=...) next to the dispatch",
                where=site.where or None,
            ))

    if any(d.severity == "error" for d in diags):
        verdict = "device-dirty"
    elif any(d.severity == "warning" for d in diags):
        verdict = "device-degraded"
    else:
        verdict = "device-clean"
    diags.sort(key=lambda d: -SEVERITIES.index(d.severity))
    return DevicePlanReport(
        verdict=verdict, world=world, chains=chains,
        predictions=predictions, hbm=hbm, diagnostics=diags,
    )


# -- predicted vs measured drift (--profile join) ----------------------------


def join_profile(report: DevicePlanReport, trace: dict | str) -> DevicePlanReport:
    """Join measured per-site recompile counters from a flight-recorder
    trace (its ``pathway.device_recompiles`` block) onto the static
    predictions. A site whose measured recompiles exceed the predicted
    bucket count is DRIFT — the static model missed shapes the runtime
    actually captured; measured <= predicted is ok (a run need not visit
    every declared bucket)."""
    if isinstance(trace, str):
        with open(trace, "r", encoding="utf-8") as fh:
            trace = json.load(fh)
    doc = trace.get("pathway", trace) if isinstance(trace, dict) else {}
    measured = doc.get("device_recompiles") or {}
    for site, p in report.predictions.items():
        if site not in measured:
            continue
        got = int(measured[site])
        p["measured_recompiles"] = got
        p["drift"] = "ok" if got <= p["recompiles"] else "exceeded"
        if p["drift"] == "exceeded":
            report.diagnostics.append(Diagnostic(
                code="device.retrace.drift",
                severity="error",
                node=site,
                message=(
                    f"measured device recompiles ({got}) exceed the "
                    f"static prediction ({p['recompiles']}): the runtime "
                    "captured shapes the declared workload did not imply"
                ),
                hint="re-declare the workload (batch/length caps) or fix "
                     "the site's bucket schedule",
            ))
            report.verdict = "device-dirty"
    return report
