"""Hot-path blame: join a flight-recorder trace back onto the plan.

``python -m pathway_tpu_torch.analysis --profile trace.json`` turns the Plan
Doctor's static verdicts into measured ones: the trace's per-node spans
carry each node's runtime NBDecision verdict (the SAME objects the
executor gates its columnar paths on — internals/flight.py embeds them
at dump time), so the profile can say not just "stream_join#7 is 61% of
self-time" but whether it ran fused, degraded to the tuple path (and
which expression is to blame), or is a row-expanding sink whose cost is
materialization, not compute (ROADMAP item 2's `value_incl_capture`
gap, measured per node).

Also the home of the trace-schema validator shared by the tests and the
CI trace-smoke lane (scripts/trace_smoke.py): Chrome-trace shape,
non-negative durations, monotonic per-track timestamps, span nesting.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any

TOP_K_DEFAULT = 10


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(
            f"{path}: not a flight-recorder trace (no traceEvents)"
        )
    return doc


def validate_trace(doc: dict) -> list[str]:
    """Trace-schema check; returns problems (empty = valid).

    Pins the invariants the tests and the CI smoke lane rely on:
    * every complete ("X") event carries numeric pid/tid/ts and a
      non-negative dur;
    * per (pid, tid) track, timestamps are monotone in file order (the
      exporter time-sorts, and the merger's clock-offset shift must not
      reorder a track);
    * per track, spans nest — a span either contains the next one or is
      disjoint from it; partial overlap means broken timing. ``native``
      spans are exempt: ring slot 0 collects duration samples from
      WHICHEVER thread entered a GIL-free region (main thread encodes
      while a receiver thread decodes), so its track is a sample stream,
      not a call stack;
    * node spans carry the args the profile joins on (node/rows/rep).
    """
    problems: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    pw = doc.get("pathway", {})
    if pw.get("schema") != 1:
        problems.append(f"unknown pathway.schema {pw.get('schema')!r}")
    last_ts: dict[tuple, float] = {}
    stacks: dict[tuple, list] = defaultdict(list)
    eps = 2e-3  # µs: json round-trip slack on span edges
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph == "M":
            continue
        key = (e.get("pid"), e.get("tid"))
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: non-numeric ts")
            continue
        if ts < last_ts.get(key, float("-inf")) - eps:
            problems.append(
                f"event {i}: track {key} timestamps not monotonic"
            )
        last_ts[key] = ts
        if ph != "X":
            continue
        dur = e.get("dur")
        if not isinstance(dur, (int, float)) or dur < 0:
            problems.append(f"event {i}: bad dur {dur!r}")
            continue
        if e.get("cat") == "node":
            args = e.get("args", {})
            if "node" not in args or "rows" not in args or (
                "rep" not in args
            ):
                problems.append(
                    f"event {i}: node span missing node/rows/rep args"
                )
        if e.get("cat") == "device":
            # device dispatch spans: concurrent async
            # dispatches legitimately overlap on a site's track — a
            # sample stream like `native`, exempt from nesting — but
            # every span must carry the dispatch id the correlation
            # pin joins on
            if "dispatch" not in (e.get("args") or {}):
                problems.append(
                    f"event {i}: device span missing dispatch arg"
                )
            continue
        if e.get("cat") == "native":
            continue  # sample stream, not a call stack (see docstring)
        stack = stacks[key]
        while stack and ts >= stack[-1][1] - eps:
            stack.pop()
        if stack and ts + dur > stack[-1][1] + eps:
            problems.append(
                f"event {i}: span ({ts}, +{dur}) partially overlaps an "
                f"enclosing span on track {key}"
            )
        stack.append((ts, ts + dur))
    return problems


def aggregate_node_spans(
    events, by_rank: bool = False
) -> dict:
    """Per-node span aggregation shared by the profile and the wave
    critical-path analyzer (analysis/critical_path.py): key is the node
    id (across ranks) or ``(pid, node)`` with ``by_rank``. Malformed
    node events (already reported by validate_trace) are skipped so the
    CLIs keep their documented exit-2 path instead of a KeyError."""
    agg: dict = {}
    for e in events:
        if e.get("cat") != "node":
            continue
        args = e.get("args") or {}
        nid = args.get("node")
        if nid is None:
            continue
        key = (e.get("pid", 0), nid) if by_rank else nid
        a = agg.setdefault(
            key,
            {"self_s": 0.0, "rows": 0, "batches": 0, "nb_batches": 0},
        )
        a["self_s"] += e.get("dur", 0.0) / 1e6
        a["rows"] += max(0, args.get("rows", 0))
        a["batches"] += 1
        if args.get("rep") == "nb":
            a["nb_batches"] += 1
    return agg


def aggregate_device_spans(events, by_rank: bool = False) -> dict:
    """Per-dispatch-site aggregation of the trace's device spans,
    shared by the profile and the wave critical-path
    analyzer: key is the site name (or ``(pid, site)`` with
    ``by_rank``) -> {dispatches, wall_s, device_s, flops,
    bytes_accessed, transfer_bytes, nodes: {node id -> device_s}}.
    ``device_s`` is the CUDA-event-bounded device share each
    span's args carry; wall - device = host assembly time."""
    agg: dict = {}
    for e in events:
        if e.get("cat") != "device" or e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        site = str(e.get("name", "?"))
        key = (e.get("pid", 0), site) if by_rank else site
        a = agg.setdefault(
            key,
            {
                "dispatches": 0, "wall_s": 0.0, "device_s": 0.0,
                "flops": 0.0, "flops_effective": 0.0,
                "bytes_accessed": 0.0,
                "transfer_bytes": 0, "nodes": {},
            },
        )
        dev_s = max(0.0, args.get("device_us", 0.0)) / 1e6
        flops = max(0.0, args.get("flops", 0.0) or 0.0)
        a["dispatches"] += 1
        a["wall_s"] += e.get("dur", 0.0) / 1e6
        a["device_s"] += dev_s
        a["flops"] += flops
        # older traces carry no flops_effective — such spans
        # read as fully effective, never as a schema error
        eff = args.get("flops_effective")
        a["flops_effective"] += (
            flops if eff is None else max(0.0, min(float(eff), flops))
        )
        a["bytes_accessed"] += max(
            0.0, args.get("bytes_accessed", 0.0) or 0.0
        )
        a["transfer_bytes"] += int(args.get("transfer_bytes", 0) or 0)
        node = args.get("node")
        if node is not None:
            a["nodes"][node] = a["nodes"].get(node, 0.0) + dev_s
    return agg


def trace_platform(doc: dict) -> dict | None:
    """The platform stamp of a trace (what hardware rank 0 measured):
    single-rank dumps carry it at ``pathway.platform``, merged files per
    rank under ``rank_meta`` — peak rates from here keep offline
    roofline verdicts consistent with the recording host."""
    pw = doc.get("pathway", {})
    plat = pw.get("platform")
    if plat:
        return plat
    meta = pw.get("rank_meta") or {}
    for rank_key in sorted(meta):
        plat = (meta[rank_key] or {}).get("platform")
        if plat:
            return plat
    return None


def device_report(doc: dict, sites: dict | None = None) -> dict | None:
    """The --profile device section: per-site dispatch totals, MFU and
    the roofline verdict (compute-bound / bandwidth-bound / host-bound),
    computed through the SAME pure ``roofline_verdict`` the live plane
    uses (internals/device.py — no drift). None when the trace carries
    no device spans (a pure relational run). ``sites`` lets a caller
    that already ran ``aggregate_device_spans`` skip the second
    full-event pass (profile_trace needs the per-node seconds too)."""
    from pathway_tpu_torch.internals.device import (
        mfu as _mfu,
        peak_bandwidth,
        peak_flops,
        roofline_verdict,
    )

    if sites is None:
        sites = aggregate_device_spans(doc.get("traceEvents", ()))
    if not sites:
        return None
    plat = trace_platform(doc) or {}
    pk_flops = plat.get("peak_flops") or peak_flops()
    pk_bw = plat.get("peak_bandwidth") or peak_bandwidth()
    rows = []
    tot_flops = 0.0
    tot_flops_eff = 0.0
    tot_dev_s = 0.0
    for site in sorted(
        sites, key=lambda s: sites[s]["wall_s"], reverse=True
    ):
        a = sites[site]
        flops_eff = a.get("flops_effective", a["flops"])
        verdict = roofline_verdict(
            a["wall_s"], a["device_s"], a["flops"], a["bytes_accessed"],
            pk_flops, pk_bw,
        )
        tot_flops += a["flops"]
        tot_flops_eff += flops_eff
        tot_dev_s += a["device_s"]
        rows.append(
            {
                "site": site,
                "dispatches": a["dispatches"],
                "wall_s": round(a["wall_s"], 6),
                "device_s": round(a["device_s"], 6),
                "device_share": round(
                    a["device_s"] / a["wall_s"], 4
                ) if a["wall_s"] > 0 else 0.0,
                "flops": a["flops"],
                "flops_effective": flops_eff,
                "transfer_bytes": a["transfer_bytes"],
                # mfu is EFFECTIVE (real rows); mfu_padded is what the
                # hardware executed, bucket padding included
                "mfu": round(
                    _mfu(flops_eff, a["device_s"], pk_flops), 6
                ),
                "mfu_padded": round(
                    _mfu(a["flops"], a["device_s"], pk_flops), 6
                ),
                "verdict": verdict,
                "nodes": sorted(a["nodes"]),
            }
        )
    return {
        "backend": plat.get("backend"),
        "device_kind": plat.get("device_kind"),
        "peak_flops": pk_flops,
        "peak_bandwidth": pk_bw,
        "mfu": round(_mfu(tot_flops_eff, tot_dev_s, pk_flops), 6),
        "mfu_padded": round(_mfu(tot_flops, tot_dev_s, pk_flops), 6),
        "sites": rows,
    }


def measured_verdict(meta_entry: dict, agg_entry: dict) -> str:
    """Join a node's measured batches onto its static NBDecision verdict
    (embedded at dump time — the SAME objects the executor gates on)."""
    verdict = meta_entry.get("verdict")
    tuple_batches = agg_entry["batches"] - agg_entry["nb_batches"]
    if meta_entry.get("row_expanding"):
        return "row-expanding sink"
    if meta_entry.get("sink"):
        # the egress leg: keyed on the consumer's declared
        # capability, same decision the runtime counters audit
        if meta_entry.get("egress") == "columnar":
            return "columnar egress (arrow)"
        return "rows egress"
    if verdict == "fused" and tuple_batches == 0 and agg_entry["batches"]:
        return "fused"
    if verdict == "fused":
        # the static verdict said fused but batches executed on the
        # tuple path: a MEASURED degradation the static pass missed
        return (
            f"degraded at runtime ({tuple_batches}/"
            f"{agg_entry['batches']} tuple batches)"
        )
    if verdict == "degraded":
        return "degraded"
    return "no fused path"


def profile_trace(path: str, top_k: int = TOP_K_DEFAULT) -> dict:
    """Aggregate the trace per node (across ranks) and join the plan
    metadata. Returns the report dict (render_profile prints it)."""
    doc = load_trace(path)
    problems = validate_trace(doc)
    meta = doc.get("pathway", {}).get("nodes", {})
    agg: dict[int, dict] = aggregate_node_spans(doc["traceEvents"])
    wall_per_pid: dict[int, float] = defaultdict(float)
    native_s: dict[str, float] = defaultdict(float)
    lag_max: dict[str, float] = {}
    waves = 0
    wave_s = 0.0
    for e in doc["traceEvents"]:
        cat = e.get("cat")
        if cat == "step":
            wall_per_pid[e.get("pid", 0)] += e.get("dur", 0.0) / 1e6
        elif cat == "native":
            # region-entry spans only (tid 100): with PATHWAY_THREADS>1
            # the per-worker sub-spans (tid 101+) run INSIDE the entry
            # span — summing both would double-count the phase wall time
            if e.get("tid") == 100:
                native_s[e.get("name", "?")] += e.get("dur", 0.0) / 1e6
        elif cat == "wave":
            waves += 1
            wave_s += e.get("dur", 0.0) / 1e6
        elif cat == "lag":
            name = e.get("name", "?")
            lag = e.get("args", {}).get("lag_ms", 0.0)
            lag_max[name] = max(lag_max.get(name, 0.0), lag)
    total_self = sum(a["self_s"] for a in agg.values()) or 1e-12
    # device plane: per-site roofline verdicts + the
    # node -> dominant-site join, so a slow ExternalIndexNode says
    # whether it needs a kernel or needs its host path fixed. The
    # dominant site for a node is the one that spent the most device
    # time INSIDE that node (per-node seconds from the span args) —
    # not the site's whole-trace total, which would let a busy
    # elsewhere site claim nodes it barely touched (and drift from
    # --critical-path's _node_device_verdict, which already joins
    # per-node)
    per_site = aggregate_device_spans(doc.get("traceEvents", ()))
    device = device_report(doc, sites=per_site)
    node_device: dict = {}
    if device is not None:
        site_rows = {row["site"]: row for row in device["sites"]}
        node_best: dict = {}  # nid -> (device_s inside nid, site)
        for site, a in per_site.items():
            for nid, dev_s in a["nodes"].items():
                best = node_best.get(nid)
                if best is None or dev_s > best[0]:
                    node_best[nid] = (dev_s, site)
        node_device = {
            nid: site_rows[site]
            for nid, (_s, site) in node_best.items()
            if site in site_rows
        }
    rows_out = []
    for nid, a in agg.items():
        m = meta.get(str(nid), {})
        measured = measured_verdict(m, a)
        drow = node_device.get(nid)
        rows_out.append(
            {
                "node": nid,
                "label": m.get("label", f"node#{nid}"),
                "provenance": m.get("provenance"),
                "self_s": round(a["self_s"], 6),
                "share": round(a["self_s"] / total_self, 4),
                "rows": a["rows"],
                "batches": a["batches"],
                "nb_batches": a["nb_batches"],
                "verdict": measured,
                **(
                    {
                        "device_verdict": drow["verdict"],
                        "device_site": drow["site"],
                    }
                    if drow is not None
                    else {}
                ),
                **({"blame": m["blame"]} if m.get("blame") else {}),
            }
        )
    rows_out.sort(key=lambda r: r["self_s"], reverse=True)
    return {
        "path": path,
        "valid": not problems,
        "problems": problems,
        "ranks": doc.get("pathway", {}).get("merged_ranks", [0]),
        "wall_s": round(max(wall_per_pid.values(), default=0.0), 6),
        "total_self_s": round(total_self, 6),
        "waves": waves,
        "wave_s": round(wave_s, 6),
        "native_s": {k: round(v, 6) for k, v in sorted(native_s.items())},
        "lag_max_ms": {k: round(v, 3) for k, v in sorted(lag_max.items())},
        "device": device,
        "top": rows_out[:top_k],
    }


def render_profile(report: dict) -> str:
    lines = [
        f"flight-recorder profile: {report['path']}",
        f"  ranks {report['ranks']}  wall {report['wall_s']:.3f}s  "
        f"node self-time {report['total_self_s']:.3f}s  "
        f"waves {report['waves']} ({report['wave_s']:.3f}s)",
    ]
    if report["problems"]:
        lines.append("  SCHEMA PROBLEMS:")
        lines.extend(f"    {p}" for p in report["problems"][:10])
    lines.append("  top nodes by self-time:")
    for r in report["top"]:
        prov = f"  [{r['provenance']}]" if r.get("provenance") else ""
        dev = (
            f"  device: {r['device_verdict']} ({r['device_site']})"
            if r.get("device_verdict")
            else ""
        )
        lines.append(
            f"    {r['share']:>6.1%}  {r['self_s']:>9.4f}s  "
            f"{r['label']:<24} rows={r['rows']:<9} "
            f"nb={r['nb_batches']}/{r['batches']}  {r['verdict']}"
            f"{dev}{prov}"
        )
        for b in r.get("blame", ()):
            lines.append(f"            blame: {b}")
    dev = report.get("device")
    if dev:
        lines.append(
            f"  device dispatches ({dev.get('backend') or '?'} "
            f"{dev.get('device_kind') or ''}, "
            f"MFU {dev['mfu']:.4f} @ peak {dev['peak_flops']:.3g} "
            "FLOP/s):"
        )
        for s in dev["sites"]:
            lines.append(
                f"    {s['site']:<18} n={s['dispatches']:<6} "
                f"wall={s['wall_s']:.4f}s dev={s['device_s']:.4f}s "
                f"({s['device_share']:.0%})  flops={s['flops']:.3g} "
                f"mfu={s['mfu']:.4f}  {s['verdict']}"
            )
    if report["native_s"]:
        native = "  ".join(
            f"{k}={v:.4f}s" for k, v in report["native_s"].items()
        )
        lines.append(f"  native (GIL-free): {native}")
    if report["lag_max_ms"]:
        lag = "  ".join(
            f"{k.replace('freshness ', '')}={v:g}ms"
            for k, v in report["lag_max_ms"].items()
        )
        lines.append(f"  event-time lag (max): {lag}")
    return "\n".join(lines)
