"""pw.io.python — custom Python connectors (reference:
python/pathway/io/python/__init__.py:49 ConnectorSubject with
next()/commit()/close() protocol and *COMMIT*/*FINISH* literals :43-46)."""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import _KEY_MASK, Pointer, ref_scalar
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe

COMMIT_LITERAL = "*COMMIT*"
FINISH_LITERAL = "*FINISH*"


class ConnectorSubject:
    """Subclass and implement run(); push rows with next()/next_json()/...

    The runtime runs ``run()`` on a dedicated thread per source (reference:
    connector thread, src/connectors/mod.rs:91) and stamps a commit timestamp
    per flush.
    """

    _deletions_enabled: bool = True

    def __init__(self, datasource_name: str = "python"):
        self._emit = None
        self._flush = None
        self._finished = False

    # wired by the engine runtime
    def _attach(self, emit, flush) -> None:
        self._emit = emit
        self._flush = flush

    def run(self) -> None:
        raise NotImplementedError

    def on_stop(self) -> None:
        pass

    def start(self) -> None:
        self.run()

    # -- producer API ------------------------------------------------------
    def next(self, **kwargs) -> None:
        if self._finished:
            return
        self._emit(("upsert", kwargs))

    def next_json(self, message: dict) -> None:
        self.next(**message)

    def next_batch(self, rows: list[dict]) -> None:
        """Push many rows in one producer call. The whole list reaches the
        flush as a single message and (for keyless append-only subjects)
        is parsed by one C call — the engine-bound ingestion door for
        sources that already hold rows in memory."""
        if self._finished or not rows:
            return
        # copy list AND row dicts: parsing is deferred to flush time on
        # the connector thread, so neither a caller-reused list buffer nor
        # a caller-reused row dict may alias the queued message
        self._emit(("upsert_batch", [dict(r) for r in rows]))

    def next_str(self, message: str) -> None:
        if message == COMMIT_LITERAL:
            self.commit()
            return
        if message == FINISH_LITERAL:
            # end-of-stream sentinel (reference: io/python/__init__.py:43-46):
            # later messages are dropped and the final batch is flushed.
            self._finished = True
            self.commit()
            return
        self.next(data=message)

    def next_bytes(self, message: bytes) -> None:
        self.next(data=message)

    def _upsert(self, key: Pointer, values: dict) -> None:
        """Insert/update with an explicit stable key (used by connectors
        that track object identity themselves, e.g. fs path+line)."""
        if self._finished:
            return
        self._emit(("upsert", values, key))

    def _remove(self, key: Pointer, values: dict) -> None:
        self._emit(("remove", values, key))

    def remove(self, **kwargs) -> None:
        self._emit(("remove", kwargs, None))

    def commit(self) -> None:
        if self._flush is not None:
            self._flush()

    def close(self) -> None:
        self.commit()


_parser_seq = [0]


def _make_parser(schema: type[Schema], subject=None):
    from pathway_tpu_torch.engine.stream import freeze_row

    cols = schema.column_names()
    pkeys = schema.primary_key_columns()
    defaults = schema.default_values()
    seq = [0]
    # keyless rows mint salt+counter pointers: deterministic given arrival
    # order (restart replay preserves it via the journal) and two orders of
    # magnitude cheaper than hashing row content per row. The salt includes
    # a per-parser ordinal so same-schema sources in one program never
    # collide (graph construction order is deterministic per program).
    _parser_seq[0] += 1
    key_base = int(
        ref_scalar("py-connector", _parser_seq[0], *sorted(cols))
    )
    col_defaults = [(c, defaults.get(c)) for c in cols]
    # content->key stacks exist only to serve remove()-by-content; subjects
    # that declare they never remove skip the bookkeeping entirely
    track_removals = getattr(subject, "_deletions_enabled", True)
    # primary-keyed sources are upsert sessions (reference: SessionType::
    # Upsert, connectors/adaptors.rs:176): re-inserting a live key must
    # retract the previous row first, or multiset operators double-count
    live_rows: dict[Pointer, tuple] = {}
    # content -> stack of keys minted for it, so remove() retracts the row
    # actually inserted (schemas without primary keys mint per-row keys).
    live_keys: dict[tuple, list] = {}

    def parse(message) -> list[tuple]:
        kind, values = message[0], message[1]
        if kind == "upsert_batch":
            out: list[tuple] = []
            for row_values in values:
                out.extend(parse(("upsert", row_values)))
            return out
        explicit_key = message[2] if len(message) > 2 else None
        row = tuple(values.get(c, d) for c, d in col_defaults)
        if pkeys:
            key = ref_scalar(*(values[c] for c in pkeys))
            if kind == "remove":
                prev = live_rows.pop(key, None)
                return [(key, prev if prev is not None else row, -1)]
            out = []
            prev = live_rows.get(key)
            if prev is not None:
                out.append((key, prev, -1))
            live_rows[key] = row
            out.append((key, row, 1))
            return out
        if kind == "remove":
            if explicit_key is not None:
                key = explicit_key
            else:
                stack = live_keys.get(freeze_row(row))
                if not stack:
                    return []  # nothing to retract
                key = stack.pop()
        elif explicit_key is not None:
            # explicit-key rows are removed by key, never by content — they
            # must not enter the content->key stacks (leak + mis-retraction)
            key = explicit_key
        else:
            seq[0] += 1
            key = Pointer((key_base + seq[0]) & _KEY_MASK)
            if track_removals:
                live_keys.setdefault(freeze_row(row), []).append(key)
        diff = -1 if kind == "remove" else 1
        return [(key, row, diff)]

    # batch parsing: runs of keyless simple upserts (the append-only
    # streaming hot path) are parsed by one C call per run — row tuples,
    # defaults and minted keys all built without the per-row closure
    from pathway_tpu_torch.engine.stream import get_fp

    fp = get_fp()
    simple = fp is not None and not pkeys and not track_removals
    # columnar fast path: a flush that is entirely simple upserts parses
    # into a C-owned NativeBatch (exec.cpp) that the group-by executor
    # consumes with zero per-row Python objects (the fused-chain door)
    nb_parse = None
    if simple:
        try:
            from pathway_tpu_torch.native import get_pwexec

            nb_parse = getattr(get_pwexec(), "parse_upserts_nb", None)
        except Exception:
            nb_parse = None
    # primary-keyed upsert sessions take their own C pass (key mint from
    # pk values + retract-previous against the shared live_rows session
    # dict) — the CDC/connector hot path
    pk_fast = (
        fp is not None and bool(pkeys) and hasattr(fp, "parse_pk_upserts")
    )
    # columnar pk fast path: deletions-disabled pk sources own their
    # upsert session in C (exec.cpp PkStore) and emit NativeBatches while
    # every key is fresh — the fused parse→join/groupby chain for
    # CDC-shaped sources. The first retraction-needing or non-columnar
    # batch dumps the C session into live_rows and permanently falls back
    # to the tuple pk path (one-way demotion, state never splits).
    pk_nb = None
    pk_nb_state = None
    pk_nb_dump = None
    if pk_fast and not track_removals:
        try:
            from pathway_tpu_torch.native import get_pwexec

            _ex = get_pwexec()
            if _ex is not None and hasattr(_ex, "parse_pk_upserts_nb"):
                pk_nb_state = _ex.pk_session_new()
                pk_nb_dump = _ex.pk_session_dump
                pk_nb = _ex.parse_pk_upserts_nb
        except Exception:
            pk_nb = None
    cols_t = tuple(cols)
    pkeys_t = tuple(pkeys or ())
    defaults_t = tuple(defaults.get(c) for c in cols)

    def _all_upsert_dicts(messages: list):
        """The flush's row dicts when EVERY message is an upsert (single
        rows or any number of upsert_batch runs, in order) — the shapes
        the columnar parsers ingest whole; None otherwise."""
        if len(messages) == 1 and messages[0][0] == "upsert_batch":
            return messages[0][1]
        dicts: list = []
        for m in messages:
            if m[0] == "upsert_batch":
                dicts.extend(m[1])
            elif m[0] == "upsert" and len(m) == 2:
                dicts.append(m[1])
            else:
                return None
        return dicts

    def parse_batch(messages: list) -> list[tuple]:
        nonlocal pk_nb
        from pathway_tpu_torch.engine.stream import ConsolidatedList

        if nb_parse is not None and messages:
            dicts = _all_upsert_dicts(messages)
            if dicts is not None:
                res = nb_parse(
                    dicts, 0, cols_t, defaults_t, key_base, seq[0], Pointer
                )
                if res is not None:  # None: value outside the columnar set
                    nb, seq[0] = res
                    return nb
        if pk_nb is not None and messages:
            dicts = _all_upsert_dicts(messages)
            if dicts is not None:
                nb = pk_nb(
                    dicts, cols_t, defaults_t, pkeys_t, pk_nb_state,
                    live_rows, Pointer,
                )
                if nb is not None:
                    return nb
                # demoted: session state now lives in live_rows; the
                # tuple pk path below re-parses this batch against it
                pk_nb = None
            else:
                # a flush carrying non-upsert messages consults live_rows
                # — move the C session there first, then stay demoted
                pk_nb_dump(pk_nb_state, live_rows, Pointer, len(cols_t))
                pk_nb = None
        out: list[tuple] = []
        i, n = 0, len(messages)
        pure = simple
        while i < n:
            m = messages[i]
            if (simple or pk_fast) and m[0] == "upsert_batch":
                # pre-batched rows: one C call for the whole list
                if simple:
                    deltas, seq[0] = fp.parse_upserts(
                        m[1], 0, cols_t, defaults_t, key_base, seq[0],
                        _KEY_MASK, Pointer,
                    )
                else:
                    deltas = fp.parse_pk_upserts(
                        m[1], cols_t, defaults_t, pkeys_t, live_rows
                    )
                out.extend(deltas)
                i += 1
            elif (simple or pk_fast) and m[0] == "upsert" and len(m) == 2:
                j = i + 1
                while j < n:
                    mj = messages[j]
                    if mj[0] != "upsert" or len(mj) != 2:
                        break
                    j += 1
                dicts = [messages[t][1] for t in range(i, j)]
                if simple:
                    deltas, seq[0] = fp.parse_upserts(
                        dicts, 0, cols_t, defaults_t, key_base, seq[0],
                        _KEY_MASK, Pointer,
                    )
                else:
                    deltas = fp.parse_pk_upserts(
                        dicts, cols_t, defaults_t, pkeys_t, live_rows
                    )
                out.extend(deltas)
                i = j
            else:
                pure = False
                out.extend(parse(m))
                i += 1
        if pure:
            # every row minted a fresh key with diff +1: already net form,
            # the source node's consolidate passes it through untouched
            return ConsolidatedList(out)
        return out

    parse.parse_batch = parse_batch
    # primary-keyed sources are upsert sessions. Rescans after a
    # supervised restart are idempotent ONLY while the subject never
    # removes (re-inserting a live key retracts the previous row; a
    # re-scanned remove would retract twice), and the session state makes
    # ledger compensation unsound either way — the supervisor keys its
    # restart strategy off both flags.
    parse.is_pk = bool(pkeys)
    parse.is_upsert = bool(pkeys) and not track_removals
    # static fused-chain capability for pw.analyze + the runtime's
    # fallback accounting (analysis/eligibility.py source_nb_capability):
    # can this source emit columnar NativeBatches, and if not, why —
    # the door exists only for upsert flushes over columnar value types
    from pathway_tpu_torch.analysis.eligibility import schema_nb_blame

    nb_blame: list[str] = []
    if nb_parse is None and pk_nb is None:
        if track_removals:
            nb_blame.append(
                "subject allows remove()-by-content (set "
                "_deletions_enabled = False for the columnar parser)"
            )
        elif pkeys and not pk_fast:
            nb_blame.append("no native toolchain (C parser unavailable)")
        elif not simple and not pkeys:
            nb_blame.append("no native toolchain (C parser unavailable)")
        else:
            nb_blame.append("columnar parser door unavailable")
    nb_blame.extend(schema_nb_blame(schema))
    parse.nb_capable = not nb_blame
    parse.nb_blame = tuple(nb_blame)
    return parse


def read(
    subject: ConnectorSubject,
    *,
    schema: type[Schema] | None = None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs,
) -> Table:
    if schema is None:
        raise ValueError("pw.io.python.read requires a schema")
    subject._autocommit_duration_ms = autocommit_duration_ms
    out = Table(schema, Universe())
    parser = _make_parser(schema, subject)
    width = len(schema.column_names())
    persistent_name = name or kwargs.get("persistent_id")

    def lower(ctx):
        ctx.set_engine_table(
            out,
            ctx.scope.connector_table(
                subject, parser, width, name=persistent_name
            ),
        )

    G.add_operator([], [out], lower, "python_connector")
    return out
