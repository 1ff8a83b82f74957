"""Columnar egress — NativeBatch → Arrow record batches.

The engine's fused chain keeps batches as C-owned typed column buffers
(``pwexec.NativeBatch``) all the way to the egress nodes; this module is
the boundary where those buffers become *Arrow record batches* through
the Arrow C data interface (``exec.cpp nb_export_arrow`` — GIL-free
assembly, buffer donation, one ``pa.RecordBatch._import_from_c`` on this
side), so sinks and ``on_batch`` subscribers consume columns without the
engine ever expanding rows into Python objects.

Two builders, one contract:

* :func:`nb_to_arrow` — the zero-copy path for NativeBatches. Returns
  ``None`` when a column mixes value tags (only reachable through
  untyped object sources); the caller falls back to the row path and the
  ``capture_rows_expanded_total`` counter makes the degradation visible.
* :func:`deltas_to_arrow` — the graceful fallback for tuple-delta
  batches (retractions, object columns, no toolchain): builds the batch
  column-wise in Python; cells outside the Arrow scalar set are PICKLED
  into a binary column tagged with ``pw_pickled`` field metadata (see
  :func:`unpickle_columns`), so an Arrow-mode subscriber still receives
  *every* delivery as a record batch.

Shared schema shape: the table's value columns (nullable), then a
``diff`` int64 column (±1; NativeBatches are insert-only net form, so
the zero-copy path emits a constant +1), and optionally a ``_key``
fixed_size_binary(16) column carrying the engine's 128-bit row keys
little-endian (``key_to_bytes``/``key_from_bytes`` round-trip them to
``Pointer``).
"""

from __future__ import annotations

import pickle
from typing import Any, Iterable

_PICKLED_META = b"pw_pickled"

_pa_cached: Any = False


def get_pyarrow():
    """pyarrow, or None when not importable (cached; the egress then
    stays on the row path — a missing wheel must degrade, not crash)."""
    global _pa_cached
    if _pa_cached is False:
        try:
            import pyarrow as pa

            _pa_cached = pa
        except Exception:
            _pa_cached = None
    return _pa_cached


def arrow_capable() -> bool:
    """Can this process export columnar egress batches at all?
    (pyarrow + the native toolchain + the knob not forcing rows)."""
    from pathway_tpu_torch.analysis.eligibility import nb_capture_forced_off

    if nb_capture_forced_off() or get_pyarrow() is None:
        return False
    return _pwexec() is not None


def _pwexec():
    try:
        from pathway_tpu_torch.native import get_pwexec

        ex = get_pwexec()
    except Exception:
        return None
    if ex is None or not hasattr(ex, "nb_export_arrow"):
        return None
    return ex


def key_to_bytes(key: Any) -> bytes:
    """128-bit row key → the 16 little-endian bytes the C export emits
    for ``_key`` (shared by the row-path builder so rows-vs-arrow parity
    holds bit-identically on the key column too)."""
    return (int(key) & ((1 << 128) - 1)).to_bytes(16, "little")


def key_from_bytes(raw: bytes) -> int:
    return int.from_bytes(raw, "little")


def nb_to_arrow(
    nb, cols: Iterable[str], *, include_key: bool = False,
    include_diff: bool = True,
):
    """Zero-copy export of one NativeBatch as a ``pa.RecordBatch``.
    ``None`` = not exportable this batch (mixed-tag column / toolchain
    or pyarrow missing) — the caller falls back to the row path."""
    pa = get_pyarrow()
    ex = _pwexec()
    if pa is None or ex is None:
        return None
    out = ex.nb_export_arrow(
        nb, tuple(cols), bool(include_key), bool(include_diff)
    )
    if out is None:
        return None
    s_addr, a_addr = out
    try:
        return pa.RecordBatch._import_from_c(a_addr, s_addr)
    finally:
        # the import MOVES the shell contents and marks them released;
        # arrow_shells_free returns the malloc'd shells (and releases
        # the donation if the import never ran)
        ex.arrow_shells_free(s_addr, a_addr)


_ARROW_SCALARS = (bool, int, float, str)


def deltas_to_arrow(
    deltas, cols, *, include_key: bool = False, pickle_objects: bool = True,
):
    """Row-fallback builder: tuple deltas ``[(key, row, diff), ...]`` →
    one record batch, column-wise. Cells outside the Arrow scalar set
    (Json, tuples, ndarrays, >64-bit ints) pickle into a binary column
    with ``pw_pickled`` field metadata when ``pickle_objects`` — sinks
    that must serialize *values* (csv/parquet) pass ``False`` and take
    ``None`` as their row-path verdict instead.

    Hot-path discipline: this runs per delivered batch on egress nodes
    whose input chain is NOT columnar (e.g. groupby output), so the
    per-row work is kept to one slice comprehension per column plus
    C-speed bulk ops — ``set(map(type, ...))`` for the type scan, one
    typed ``pa.array`` per column — never a per-cell Python type check
    unless the column actually pickles. (NOT ``zip(*rows)``: splatting
    a 395k-row batch into a call is slower than the comprehensions.)"""
    pa = get_pyarrow()
    if pa is None:
        return None
    cols = list(cols)
    col_vals = [[row[j] for _k, row, _d in deltas] for j in range(len(cols))]
    arrays = []
    fields = []
    for name, vals in zip(cols, col_vals):
        arr, field = _build_column(pa, name, vals, pickle_objects)
        if arr is None:
            return None
        arrays.append(arr)
        fields.append(field)
    # column order mirrors the C export: value columns, _key, diff
    if include_key:
        keys = list(map(key_to_bytes, (k for k, _row, _d in deltas)))
        arrays.append(pa.array(keys, pa.binary(16)))
        fields.append(pa.field("_key", pa.binary(16), nullable=False))
    diffs = [d for _k, _row, d in deltas]
    arrays.append(pa.array(diffs, pa.int64()))
    fields.append(pa.field("diff", pa.int64(), nullable=False))
    return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))


def _build_column(pa, name, vals, pickle_objects):
    """(array, field) for one column; (None, None) = not representable
    without pickling and the caller vetoed it. Typing mirrors the C
    export exactly: one EXACT scalar type per column plus nulls (bool is
    final; Pointer/IntEnum/tagged-str subclasses must keep identity →
    pickle; a mixed int/float column would silently promote under
    pa.array inference, diverging from the zero-copy path, so it routes
    to pickle too) — same policy as exec.cpp nb_put."""
    types = set(map(type, vals))
    types.discard(type(None))
    if not types:
        typ = pa.null()
        return pa.array(vals, typ), pa.field(name, typ)
    if len(types) == 1:
        t = next(iter(types))
        if t in _ARROW_TYPE_MAP:
            typ = _ARROW_TYPE_MAP[t](pa)
            try:
                return pa.array(vals, typ), pa.field(name, typ)
            except (OverflowError, pa.lib.ArrowInvalid):
                pass  # >64-bit ints and friends: pickle below
    if not pickle_objects:
        return None, None
    blobs = [
        None if v is None else pickle.dumps(v, protocol=4) for v in vals
    ]
    return (
        pa.array(blobs, pa.binary()),
        pa.field(name, pa.binary(), metadata={_PICKLED_META: b"1"}),
    )


_ARROW_TYPE_MAP = {
    bool: lambda pa: pa.bool_(),
    int: lambda pa: pa.int64(),
    float: lambda pa: pa.float64(),
    str: lambda pa: pa.string(),
}


def is_pickled_field(field) -> bool:
    meta = field.metadata or {}
    return meta.get(_PICKLED_META) == b"1"


def unpickle_columns(rb):
    """Materialize a record batch's pickled columns back into Python
    objects: ``{name: [values...]}`` for exactly the ``pw_pickled``
    columns (empty dict when none — the common all-columnar case)."""
    out = {}
    for i, field in enumerate(rb.schema):
        if is_pickled_field(field):
            out[field.name] = [
                None if v is None else pickle.loads(v)
                for v in rb.column(i).to_pylist()
            ]
    return out


def record_batch_rows(rb, cols):
    """Iterate a record batch back as ``(row_tuple, diff)`` — the
    universal consumer-side adapter (tests, TUI, legacy callbacks).
    Pickled columns are unpickled; ``_key`` is skipped unless asked for
    via ``cols``."""
    names = list(cols)
    pickled = unpickle_columns(rb)
    data = {}
    for name in names + ["diff"]:
        if name in pickled:
            data[name] = pickled[name]
        else:
            data[name] = rb.column(rb.schema.get_field_index(name)).to_pylist()
    for i in range(rb.num_rows):
        yield tuple(data[c][i] for c in names), data["diff"][i]
