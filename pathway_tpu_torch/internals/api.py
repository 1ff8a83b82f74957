"""Engine-facing value types: Pointer keys, Json, PyObjectWrapper, errors.

Rebuild of the reference's value system (reference: src/engine/value.rs:207
``enum Value``; key type at value.rs:507).  Keys are 128-bit in the reference;
we use 128-bit ints derived from blake2b so that derived ids are stable across
runs and processes (required for persistence and multi-host determinism).
"""

from __future__ import annotations

import hashlib
import json as _json
import struct
from typing import Any, Iterable

import numpy as np

_KEY_MASK = (1 << 128) - 1


class Pointer(int):
    """Row id — 128-bit key (reference: value.rs Key).

    Subclasses int so it hashes/sorts natively and is cheap to shard
    (``key % n_shards``) while printing like a pathway pointer.
    """

    __slots__ = ()

    def __repr__(self) -> str:
        return f"^{int(self):032X}"[:12] + "..."

    def __str__(self) -> str:
        return self.__repr__()


def _hash_bytes(data: bytes) -> Pointer:
    digest = hashlib.blake2b(data, digest_size=16).digest()
    return Pointer(int.from_bytes(digest, "little") & _KEY_MASK)


def _value_to_bytes(value: Any) -> bytes:
    if value is None:
        return b"\x00"
    if isinstance(value, Pointer):
        return b"P" + int(value).to_bytes(16, "little")
    if isinstance(value, bool):
        return b"B" + (b"\x01" if value else b"\x00")
    if isinstance(value, int):
        return b"I" + value.to_bytes((value.bit_length() + 8) // 8 + 1, "little", signed=True)
    if isinstance(value, float):
        return b"F" + struct.pack("<d", value)
    if isinstance(value, str):
        return b"S" + value.encode("utf-8")
    if isinstance(value, bytes):
        return b"Y" + value
    if isinstance(value, tuple):
        return b"T" + _concat_lp([_value_to_bytes(v) for v in value])
    if isinstance(value, np.ndarray):
        # dtype + shape + data: keeps [1,2] distinct from [[1],[2]] etc.
        return b"A" + _concat_lp(
            [
                value.dtype.str.encode(),
                np.asarray(value.shape, dtype=np.int64).tobytes(),
                value.tobytes(),
            ]
        )
    if isinstance(value, Json):
        return b"J" + _json.dumps(value.value, sort_keys=True, default=str).encode()
    return b"O" + repr(value).encode()


def _concat_lp(parts: list[bytes]) -> bytes:
    """Length-prefixed concatenation — injective, unlike separator joins."""
    return struct.pack("<I", len(parts)) + b"".join(
        struct.pack("<I", len(p)) + p for p in parts
    )


_fp_mod: Any = False


def _fp():
    """Shared lazy accessor for the native fastpath module (resolution
    itself delegates to pathway_tpu_torch.engine.stream.get_fp; the result is
    memoized here to keep the key-mint hot path import-free)."""
    global _fp_mod
    if _fp_mod is False:
        try:
            from pathway_tpu_torch.engine.stream import get_fp

            _fp_mod = get_fp()
        except Exception:
            _fp_mod = None
    return _fp_mod


def _args_bytes(args: tuple) -> bytes:
    fp = _fp()
    if fp is not None:
        return fp.value_bytes(args)
    return _concat_lp([_value_to_bytes(a) for a in args])


def ref_scalar(*args: Any, optional: bool = False) -> Pointer:
    """Deterministic pointer from values (reference: python_api ref_scalar).
    The native fast path (fastpath.ref_scalar) mints byte-identical keys:
    same serialization, same blake2b-128 — verified by
    tests/test_native_keys.py."""
    if optional and any(a is None for a in args):
        return None  # type: ignore[return-value]
    fp = _fp()
    if fp is not None:
        return fp.ref_scalar(args)
    return _hash_bytes(_args_bytes(args))


_unsafe_counter = [0]


def unsafe_make_pointer(arg: int) -> Pointer:
    return Pointer(int(arg) & _KEY_MASK)


def sequential_pointer() -> Pointer:
    _unsafe_counter[0] += 1
    return Pointer(_unsafe_counter[0])


_NAV_MISSING = object()


def json_navigate(value: Any, index: Any):
    """TOTAL JSON navigation (reference: test_json.py pins — missing
    keys, out-of-range AND negative indices, and non-container values
    all yield null, never an error; no Python-style wraparound).
    Returns the raw inner value or _NAV_MISSING. The single source of
    truth for both expression-level ``j[i]``/``.get`` (engine
    eval_get) and ``Json`` object accessors."""
    if isinstance(index, bool):
        return _NAV_MISSING
    if isinstance(value, dict):
        if isinstance(index, (str, int)):
            return value.get(index, _NAV_MISSING)
        return _NAV_MISSING
    if isinstance(value, list):
        if isinstance(index, int) and 0 <= index < len(value):
            return value[index]
        return _NAV_MISSING
    return _NAV_MISSING


class Json:
    """JSON value wrapper (reference: Value::Json)."""

    __slots__ = ("value", "_hash")

    def __init__(self, value: Any):
        if isinstance(value, Json):
            value = value.value
        self.value = value

    # -- navigation ------------------------------------------------------
    def __getitem__(self, key):
        v = json_navigate(self.value, key)
        return Json(None if v is _NAV_MISSING else v)

    def get(self, key, default=None):
        out = json_navigate(self.value, key)
        if out is _NAV_MISSING:
            out = default
        return Json(out) if not isinstance(out, Json) else out

    def as_int(self) -> int:
        return int(self.value)

    def as_float(self) -> float:
        return float(self.value)

    def as_str(self) -> str:
        return str(self.value)

    def as_bool(self) -> bool:
        return bool(self.value)

    def as_list(self) -> list:
        return list(self.value)

    def as_dict(self) -> dict:
        return dict(self.value)

    def to_json_string(self) -> str:
        return _json.dumps(self.value, default=str)

    @staticmethod
    def parse(s: str | bytes) -> "Json":
        return Json(_json.loads(s))

    def __eq__(self, other):
        if isinstance(other, Json):
            return self.value == other.value
        return self.value == other

    def __hash__(self):
        # the hash encodes the whole value, and the engine re-hashes a row
        # at every operator that consolidates it: a document's Json is
        # hashed once per step of every join and reduce it reaches, so it
        # is computed once and kept (a Json value is never mutated)
        try:
            return self._hash
        except AttributeError:
            h = self._hash = hash(_json.dumps(self.value, sort_keys=True, default=str))
            return h

    def __reduce__(self):
        # str hashes are salted per process: the kept hash does not travel
        return (Json, (self.value,))

    def __repr__(self):
        return _json.dumps(self.value, default=str)

    def __bool__(self):
        return bool(self.value)

    def __iter__(self):
        return (Json(v) for v in self.value)

    def __len__(self):
        return len(self.value)


class PyObjectWrapper:
    """Opaque python object carried through the dataflow (reference: Value::PyObjectWrapper)."""

    __slots__ = ("value", "_serializer")

    def __init__(self, value: Any, *, serializer: Any = None):
        self.value = value
        self._serializer = serializer

    def __eq__(self, other):
        return isinstance(other, PyObjectWrapper) and self.value == other.value

    def __hash__(self):
        try:
            return hash(self.value)
        except TypeError:
            return hash(id(self.value))

    def __repr__(self):
        return f"PyObjectWrapper({self.value!r})"


def wrap_py_object(value: Any, *, serializer: Any = None) -> PyObjectWrapper:
    return PyObjectWrapper(value, serializer=serializer)


class Error:
    """Poison value (reference: Value::Error, src/engine/error.rs)."""

    _instance: "Error | None" = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "Error"

    def __bool__(self):
        raise ValueError("cannot convert Error value to bool")


ERROR = Error()


def is_error(value: Any) -> bool:
    return value is ERROR


class Pending:
    """Placeholder for not-yet-computed Future values (reference: Value::Pending)."""

    _instance: "Pending | None" = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "Pending"


PENDING = Pending()


class EngineError(Exception):
    pass


class EngineErrorWithTrace(Exception):
    def __init__(self, error: Exception, trace: Any = None):
        msg = str(error)
        if trace is not None:
            msg = f"{msg}\noccurred in operator declared at {trace}"
        super().__init__(msg)
        self.error = error
        self.trace = trace


def hash_any(value: Any) -> int:
    """Stable 64-bit hash of any engine value (sharding, LSH buckets)."""
    return int.from_bytes(
        hashlib.blake2b(_value_to_bytes(value), digest_size=8).digest(), "little"
    )


def combine_pointers(*ptrs: Iterable[Pointer]) -> Pointer:
    return ref_scalar(*ptrs)
