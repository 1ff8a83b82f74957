"""Incremental HMM decoding (reference: python/pathway/stdlib/ml/hmm.py:210
— create_hmm_reducer over a networkx DiGraph whose nodes carry
`calc_emission_log_ppb` and edges `log_transition_ppb`; used inside
windowby/reduce to maintain the decoded state as observations stream in)."""

from __future__ import annotations

import math
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.reducers import Reducer, _entries


def create_hmm_reducer(
    graph,
    beam_size: int | None = None,
    num_results_kept: int | None = None,
):
    """Returns a reducer decoding the most likely CURRENT state via Viterbi
    over the group's observations in arrival order."""
    states = list(graph.nodes)
    emission = {s: graph.nodes[s]["calc_emission_log_ppb"] for s in states}
    transitions: dict[Any, list[tuple[Any, float]]] = {s: [] for s in states}
    for u, v, data in graph.edges(data=True):
        transitions[u].append((v, data["log_transition_ppb"]))

    def factory(**kw):
        def fn(ms, slot):
            pairs = [
                (combo[-2], combo[0])
                for combo, count in _entries(ms, slot)
                for _ in range(max(count, 0))
            ]
            try:
                obs = sorted(pairs, key=lambda t: t[0])
            except TypeError:  # mixed-type order tokens
                obs = sorted(pairs, key=lambda t: repr(t[0]))
            if not obs:
                return None
            # Viterbi with backpointers and optional beam pruning
            scores = {s: emission[s](obs[0][1]) for s in states}
            back: list[dict[Any, Any]] = []
            for _, observation in obs[1:]:
                nxt: dict[Any, float] = {}
                prev: dict[Any, Any] = {}
                for s, sc in scores.items():
                    for t, logp in transitions[s]:
                        cand = sc + logp + emission[t](observation)
                        if t not in nxt or cand > nxt[t]:
                            nxt[t] = cand
                            prev[t] = s
                if beam_size is not None and len(nxt) > beam_size:
                    keep = sorted(nxt, key=nxt.get, reverse=True)[:beam_size]
                    nxt = {s: nxt[s] for s in keep}
                    prev = {s: prev[s] for s in keep}
                if not nxt:
                    nxt = {s: float("-inf") for s in states}
                    prev = {s: s for s in states}
                scores = nxt
                back.append(prev)
            current = max(scores, key=scores.get)
            if num_results_kept is None:
                return current
            # decode the tail of the most likely path (reference:
            # num_results_kept — keep the last N decoded states)
            path = [current]
            s = current
            for prev in reversed(back):
                s = prev.get(s, s)
                path.append(s)
            path.reverse()
            return tuple(path[-num_results_kept:])

        return fn

    return Reducer("hmm", factory, lambda ts: dt.ANY)
