"""Wave critical-path analysis over a merged multi-rank flight trace.

``python -m pathway_tpu_torch.analysis --critical-path trace.json`` answers
the question the per-node profile cannot: *where did the mesh's
wall-clock actually go, and which rank is holding everyone up?* The
flight recorder (internals/flight.py) emits one wave span per rank per
exchange rendezvous plus the send / recv-wait / decode legs inside it,
and the merger aligns all ranks onto one timebase (tsync offsets,
resampled at epoch commits) — so the merged trace contains, for every
wave, the full cross-rank timeline this module walks:

* **legs** — each rank's wave wall split into compute (slice/merge),
  send, recv-wait (per upstream peer) and receiver-thread decode;
* **per-wave skew** — every wave ends in a rendezvous, so the spread of
  per-rank *ready times* (when a rank's own pre-send work finished) is
  exactly the wall-clock the fast ranks lost to the slowest;
  ``mesh_skew_seconds`` sums it over the run (the metrics plane's
  cumulative recv-wait-spread gauge approximates the same number from
  scrapes — this is the exact trace-side derivation);
* **straggler attribution** — the dominant (waiting rank → upstream
  peer) recv-wait cell names the rank the mesh is waiting on, joined
  with that rank's hottest node and its NBDecision verdict (shared
  machinery with analysis/profile.py: the same aggregation and the same
  measured-verdict join), e.g. ``rank 0 recv-wait 41% of wave wall,
  upstream: rank 2 GroupByNode#5 (fused)``;
* **speedup-if-balanced** — the predicted wall-clock ratio if every
  wave's per-rank pre-send work were equalized (each wave saves
  ``max(busy) − mean(busy)``): the number that says whether rebalancing
  beats adding ranks.

The straggler lanes make this deterministic: a ``mesh.slow`` fault rule
(internals/faults.py, ``delay`` action, rank-scoped) injects a seeded
per-rank delay and this analyzer must name that exact rank — pinned by
tests/test_cluster_observatory.py and the scripts/cluster_smoke.py CI
lane.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

from pathway_tpu_torch.analysis.profile import (
    aggregate_device_spans,
    aggregate_node_spans,
    device_report,
    load_trace,
    measured_verdict,
    trace_platform,
    validate_trace,
)

TOP_WAVES_DEFAULT = 5
# below this share of wave wall, no single recv-wait cell dominates and
# the verdict is "balanced" instead of naming a straggler
BALANCED_SHARE = 0.05


def _peer_of(e: dict) -> int | None:
    peer = (e.get("args") or {}).get("peer")
    return int(peer) if peer is not None else None


def _node_device_verdict(
    per_rank_devices: dict, rank: int, nid, doc: dict
) -> tuple[str, str] | None:
    """(roofline verdict, site) of the dispatch site that spent the most
    device time inside node `nid` on `rank` — through the same pure
    ``roofline_verdict`` the live plane and --profile use. None when the
    node issued no recorded dispatches."""
    from pathway_tpu_torch.internals.device import (
        peak_bandwidth,
        peak_flops,
        roofline_verdict,
    )

    best = None
    for (pid, site), a in per_rank_devices.items():
        if pid != rank or nid not in a["nodes"]:
            continue
        if best is None or a["nodes"][nid] > best[1]["nodes"][nid]:
            best = (site, a)
    if best is None:
        return None
    site, a = best
    plat = trace_platform(doc) or {}
    return (
        roofline_verdict(
            a["wall_s"], a["device_s"], a["flops"], a["bytes_accessed"],
            plat.get("peak_flops") or peak_flops(),
            plat.get("peak_bandwidth") or peak_bandwidth(),
        ),
        site,
    )


def critical_path(path: str, top_waves: int = TOP_WAVES_DEFAULT) -> dict:
    """Walk the merged trace's wave spans; returns the report dict
    (render_critical_path prints it)."""
    doc = load_trace(path)
    problems = validate_trace(doc)
    events = doc["traceEvents"]
    meta = doc.get("pathway", {}).get("nodes", {})

    # wave instances: (commit t, wave name) -> rank -> legs
    waves: dict[tuple, dict[int, dict]] = {}
    mesh_tid0: dict[int, list[dict]] = defaultdict(list)
    decode_s: dict[int, float] = defaultdict(float)
    # decompress sub-legs: the codec's share of each rank's
    # decode leg, plus the byte ratio over compressed segments — the
    # trace-side answer to "did compression help"
    decomp_s: dict[int, float] = defaultdict(float)
    # egress leg: per-rank seconds in the GIL-free Arrow
    # capture/export regions (exec.cpp T_ARROW_EXPORT) — the columnar
    # sink cost, reported next to compute so "capture is now free" is
    # auditable from the trace
    egress_s: dict[int, float] = defaultdict(float)
    codec_wire = 0
    codec_raw = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        pid = e.get("pid", 0)
        if cat == "native" and str(e.get("name", "")) == "arrow_export":
            egress_s[pid] += e.get("dur", 0.0) / 1e6
            continue
        if cat == "wave":
            args = e.get("args") or {}
            key = (args.get("t"), e.get("name"))
            waves.setdefault(key, {})[pid] = {
                "start": e.get("ts", 0.0),
                "end": e.get("ts", 0.0) + e.get("dur", 0.0),
                "sends": [],
                "waits": [],
            }
        elif cat == "mesh":
            name = str(e.get("name", ""))
            if name.startswith("decompress"):
                # nested inside a decode span on the receiver track:
                # split out so the decode leg reads codec-vs-merge
                decomp_s[pid] += e.get("dur", 0.0) / 1e6
                args = e.get("args") or {}
                codec_wire += int(args.get("bytes") or 0)
                codec_raw += int(args.get("raw") or 0)
            elif name.startswith("decode"):
                # receiver-thread decodes overlap the engine track:
                # accounted per rank, not on the wave's critical path
                decode_s[pid] += e.get("dur", 0.0) / 1e6
            elif name.startswith(("send", "recv-wait")):
                mesh_tid0[pid].append(e)

    # assign each rank's send/recv-wait spans to its enclosing wave
    # (waves never overlap on a rank's engine track)
    eps = 2e-3
    by_rank_waves: dict[int, list[tuple[float, dict]]] = defaultdict(list)
    for insts in waves.values():
        for rank, w in insts.items():
            by_rank_waves[rank].append((w["start"], w))
    for rank in by_rank_waves:
        by_rank_waves[rank].sort(key=lambda sw: sw[0])
    for rank, evs in mesh_tid0.items():
        rw = by_rank_waves.get(rank)
        if not rw:
            continue
        starts = [s for s, _ in rw]
        for e in evs:
            ts = e.get("ts", 0.0)
            i = bisect_right(starts, ts + eps) - 1
            if i < 0:
                continue
            w = rw[i][1]
            if ts > w["end"] + eps:
                continue  # between waves (shouldn't happen)
            leg = (
                "sends"
                if str(e.get("name", "")).startswith("send")
                else "waits"
            )
            w[leg].append(e)

    # per-wave walk
    legs: dict[int, dict[str, float]] = defaultdict(
        lambda: {"compute_s": 0.0, "send_s": 0.0, "recv_wait_s": 0.0}
    )
    wait_matrix: dict[tuple[int, int], float] = defaultdict(float)
    wall_total = 0.0
    skew_total = 0.0
    balance_save = 0.0
    wave_rows = []
    for (t, name), insts in sorted(
        waves.items(),
        key=lambda kv: min(w["start"] for w in kv[1].values()),
    ):
        wall = max(w["end"] for w in insts.values()) - min(
            w["start"] for w in insts.values()
        )
        busy = {}
        for rank, w in insts.items():
            send_s = sum(e.get("dur", 0.0) for e in w["sends"]) / 1e6
            wait_s = sum(e.get("dur", 0.0) for e in w["waits"]) / 1e6
            span = max(0.0, w["end"] - w["start"]) / 1e6
            legs[rank]["send_s"] += send_s
            legs[rank]["recv_wait_s"] += wait_s
            legs[rank]["compute_s"] += max(
                0.0, span - send_s - wait_s
            )
            for e in w["waits"]:
                peer = _peer_of(e)
                if peer is not None:
                    wait_matrix[(rank, peer)] += e.get("dur", 0.0) / 1e6
            # ready time: when this rank's own pre-send work finished —
            # the end of its last send, or everything-but-waiting when a
            # leg-elided rank shipped nothing this wave
            if w["sends"]:
                ready = max(
                    e.get("ts", 0.0) + e.get("dur", 0.0)
                    for e in w["sends"]
                )
                busy[rank] = max(0.0, ready - w["start"]) / 1e6
            else:
                busy[rank] = max(0.0, span - wait_s)
        wall_s = wall / 1e6
        wall_total += wall_s
        skew = (
            max(busy.values()) - min(busy.values())
            if len(busy) >= 2
            else 0.0
        )
        skew_total += skew
        if len(busy) >= 2:
            mx = max(busy.values())
            mean = sum(busy.values()) / len(busy)
            balance_save += max(0.0, mx - mean)
        wave_rows.append(
            {
                "t": t,
                "wave": name,
                "wall_s": round(wall_s, 6),
                "skew_s": round(skew, 6),
                "busy_s": {r: round(b, 6) for r, b in sorted(busy.items())},
                "slowest_rank": (
                    max(busy, key=busy.get) if busy else None
                ),
            }
        )
    wave_rows.sort(key=lambda r: r["skew_s"], reverse=True)

    # device plane: per-rank device-busy leg (the
    # CUDA-event-bounded share of each dispatch's wall) + the
    # site aggregation the straggler verdict joins against
    per_rank_devices = aggregate_device_spans(events, by_rank=True)
    dev_busy: dict[int, float] = defaultdict(float)
    for (pid, _site), a in per_rank_devices.items():
        dev_busy[pid] += a["device_s"]

    # straggler verdict: the dominant (waiter -> upstream) cell, joined
    # with the upstream rank's hottest node (shared profile machinery)
    per_rank_nodes = aggregate_node_spans(events, by_rank=True)
    straggler = None
    verdict = "no exchange waves in trace (single-rank run?)"
    if waves:
        verdict = "balanced: no dominant recv-wait cell"
    if wait_matrix and wall_total > 0:
        (waiter, upstream), wait_s = max(
            wait_matrix.items(), key=lambda kv: kv[1]
        )
        share = wait_s / wall_total
        up_nodes = {
            nid: a
            for (pid, nid), a in per_rank_nodes.items()
            if pid == upstream
        }
        top_node = None
        if up_nodes:
            nid = max(up_nodes, key=lambda n: up_nodes[n]["self_s"])
            m = meta.get(str(nid), {})
            top_node = {
                "node": nid,
                "label": m.get("label", f"node#{nid}"),
                "provenance": m.get("provenance"),
                "self_s": round(up_nodes[nid]["self_s"], 6),
                "verdict": measured_verdict(m, up_nodes[nid]),
                **({"blame": m["blame"]} if m.get("blame") else {}),
            }
            # host-vs-device verdict: when the straggler's
            # hottest node issued device dispatches, say whether it is
            # compute/bandwidth/host-bound — "needs a kernel" vs "needs
            # the host path fixed" from one --critical-path line
            dev_verdict = _node_device_verdict(
                per_rank_devices, upstream, nid, doc
            )
            if dev_verdict is not None:
                top_node["device_verdict"] = dev_verdict[0]
                top_node["device_site"] = dev_verdict[1]
        straggler = {
            "rank": upstream,
            "waiter": waiter,
            "wait_s": round(wait_s, 6),
            "share": round(share, 4),
            "upstream_node": top_node,
        }
        if share >= BALANCED_SHARE:
            up = (
                f"{top_node['label']} ({top_node['verdict']})"
                if top_node
                else "idle/untraced"
            )
            verdict = (
                f"rank {waiter} recv-wait {share:.0%} of wave wall, "
                f"upstream: rank {upstream} {up}"
            )
            if top_node and top_node.get("device_verdict"):
                verdict += (
                    f"; device: {top_node['device_verdict']} "
                    f"({top_node['device_site']})"
                )
        else:
            verdict = (
                f"balanced: worst recv-wait cell is rank {waiter} on "
                f"rank {upstream} at {share:.1%} of wave wall"
            )

    # codec verdict suffix: join the byte ratio onto the
    # straggler verdict so "compression helped/hurt" is readable from
    # one line of --critical-path output
    codec = None
    if codec_wire > 0:
        ratio = codec_raw / codec_wire
        codec = {
            "raw_bytes": codec_raw,
            "wire_bytes": codec_wire,
            "ratio": round(ratio, 3),
            "decompress_s": round(sum(decomp_s.values()), 6),
        }
        if waves:
            verdict += (
                f"; codec ratio {ratio:.2f}x "
                f"({codec_raw - codec_wire} wire bytes saved, "
                f"{sum(decomp_s.values()):.4f}s decompress)"
            )
    elif waves:
        verdict += "; compression off (no compressed segments in trace)"

    speedup = 1.0
    if wall_total > 0 and balance_save > 0:
        speedup = wall_total / max(1e-12, wall_total - balance_save)

    for rank, d in decode_s.items():
        dz = decomp_s.get(rank, 0.0)
        # the decode span wraps its decompress sub-span: report the
        # merge/typed-decode share and the codec share separately
        legs[rank]["decode_s"] = round(max(0.0, d - dz), 6)
        if dz:
            legs[rank]["decompress_s"] = round(dz, 6)
    for rank, dz in decomp_s.items():
        if rank not in decode_s:
            legs[rank]["decompress_s"] = round(dz, 6)
    for rank, s in egress_s.items():
        if s > 0:
            legs[rank]["egress_s"] = round(s, 6)
    # device leg: CUDA-event-bounded device-busy
    # seconds per rank — read next to compute to see which ranks' wall
    # is accelerator time vs host time
    for rank, s in dev_busy.items():
        if s > 0:
            legs[rank]["device_s"] = round(s, 6)
    return {
        "path": path,
        "valid": not problems,
        "problems": problems,
        "ranks": doc.get("pathway", {}).get("merged_ranks", [0]),
        "waves": len(waves),
        "wave_wall_s": round(wall_total, 6),
        "mesh_skew_seconds": round(skew_total, 6),
        "legs": {
            rank: {k: round(v, 6) for k, v in sorted(d.items())}
            for rank, d in sorted(legs.items())
        },
        "wait_matrix": [
            {"rank": r, "upstream": p, "wait_s": round(s, 6)}
            for (r, p), s in sorted(
                wait_matrix.items(), key=lambda kv: kv[1], reverse=True
            )
        ],
        "straggler": straggler,
        "codec": codec,
        "verdict": verdict,
        "speedup_if_balanced": round(speedup, 3),
        "top_waves": wave_rows[:top_waves],
        # the device plane's per-site MFU and roofline verdicts over the
        # whole trace (profile.device_report): a single-rank trace has
        # no waves, and its device story still reads here
        "device": device_report(doc),
    }


def render_critical_path(report: dict) -> str:
    lines = [
        f"wave critical path: {report['path']}",
        f"  ranks {report['ranks']}  waves {report['waves']}  "
        f"wave wall {report['wave_wall_s']:.3f}s  "
        f"skew {report['mesh_skew_seconds']:.3f}s  "
        f"speedup-if-balanced {report['speedup_if_balanced']:.2f}x",
    ]
    if report["problems"]:
        lines.append("  SCHEMA PROBLEMS:")
        lines.extend(f"    {p}" for p in report["problems"][:10])
    lines.append(f"  verdict: {report['verdict']}")
    if report["legs"]:
        lines.append("  per-rank legs [s]:")
        for rank, d in report["legs"].items():
            lines.append(
                f"    rank {rank}: compute={d.get('compute_s', 0.0):.4f} "
                f"send={d.get('send_s', 0.0):.4f} "
                f"recv-wait={d.get('recv_wait_s', 0.0):.4f}"
                + (
                    f" decode={d['decode_s']:.4f}"
                    if "decode_s" in d
                    else ""
                )
                + (
                    f" decompress={d['decompress_s']:.4f}"
                    if "decompress_s" in d
                    else ""
                )
                + (
                    f" egress={d['egress_s']:.4f}"
                    if "egress_s" in d
                    else ""
                )
                + (
                    f" device={d['device_s']:.4f}"
                    if "device_s" in d
                    else ""
                )
            )
    c = report.get("codec")
    if c:
        lines.append(
            f"  codec: {c['raw_bytes']} raw -> {c['wire_bytes']} wire "
            f"bytes ({c['ratio']:.2f}x), "
            f"{c['decompress_s']:.4f}s decompress"
        )
    if report["wait_matrix"]:
        lines.append("  recv-wait matrix (rank waits on upstream):")
        for cell in report["wait_matrix"][:8]:
            lines.append(
                f"    rank {cell['rank']} ← rank {cell['upstream']}: "
                f"{cell['wait_s']:.4f}s"
            )
    s = report.get("straggler")
    if s and s.get("upstream_node"):
        n = s["upstream_node"]
        prov = f"  [{n['provenance']}]" if n.get("provenance") else ""
        dev = (
            f"  device: {n['device_verdict']} ({n['device_site']})"
            if n.get("device_verdict")
            else ""
        )
        lines.append(
            f"  straggler rank {s['rank']} hottest node: {n['label']} "
            f"{n['self_s']:.4f}s ({n['verdict']}){dev}{prov}"
        )
        for b in n.get("blame", ()):
            lines.append(f"      blame: {b}")
    dev = report.get("device")
    if dev:
        lines.append(
            f"  device sites ({dev.get('device_kind') or '?'}, MFU "
            f"{dev['mfu']:.4f} @ peak {dev['peak_flops']:.3g} FLOP/s):"
        )
        for s_ in dev["sites"]:
            lines.append(
                f"    {s_['site']:<18} n={s_['dispatches']:<6} "
                f"dev={s_['device_s']:.4f}s mfu={s_['mfu']:.4f}  "
                f"{s_['verdict']}"
            )
    if report["top_waves"]:
        lines.append("  worst waves by skew:")
        for w in report["top_waves"]:
            lines.append(
                f"    t={w['t']} {w['wave']}: wall={w['wall_s']:.4f}s "
                f"skew={w['skew_s']:.4f}s slowest=rank "
                f"{w['slowest_rank']} busy={w['busy_s']}"
            )
    return "\n".join(lines)
