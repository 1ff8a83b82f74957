"""UDF cache strategies (reference: python/pathway/internals/udfs/caches.py
:23-139 — CacheStrategy ABC, DiskCache, InMemoryCache, DefaultCache)."""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
from abc import ABC, abstractmethod
from typing import Any, Callable


class CacheStrategy(ABC):
    @abstractmethod
    def wrap_async(self, fn: Callable) -> Callable: ...

    def wrap_sync(self, fn: Callable) -> Callable:
        raise NotImplementedError

    @staticmethod
    def _key(name: str, args, kwargs) -> str:
        payload = pickle.dumps((args, sorted(kwargs.items())), protocol=4)
        return name + "-" + hashlib.sha256(payload).hexdigest()


class InMemoryCache(CacheStrategy):
    def __init__(self):
        self._data: dict[str, Any] = {}

    def wrap_async(self, fn):
        name = getattr(fn, "__name__", "udf")

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            key = self._key(name, args, kwargs)
            if key not in self._data:
                self._data[key] = await fn(*args, **kwargs)
            return self._data[key]

        return wrapper

    def wrap_sync(self, fn):
        name = getattr(fn, "__name__", "udf")

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            key = self._key(name, args, kwargs)
            if key not in self._data:
                self._data[key] = fn(*args, **kwargs)
            return self._data[key]

        return wrapper


class DiskCache(CacheStrategy):
    """Durable pickle-per-key cache (reference uses diskcache keyed by pickled
    args hash; doubles as the UDF-caching persistence mode)."""

    def __init__(self, name: str | None = None, directory: str | None = None):
        self._name = name or "udf"
        self._dir = directory or os.environ.get(
            "PATHWAY_PERSISTENT_STORAGE", os.path.join(".pathway-cache", "udf")
        )

    def _path(self, key: str) -> str:
        return os.path.join(self._dir, key + ".pkl")

    def _get(self, key: str):
        path = self._path(key)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return True, pickle.load(f)
        return False, None

    def _put(self, key: str, value) -> None:
        os.makedirs(self._dir, exist_ok=True)
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, self._path(key))

    def wrap_async(self, fn):
        name = getattr(fn, "__name__", self._name)

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            key = self._key(name, args, kwargs)
            hit, value = self._get(key)
            if hit:
                return value
            value = await fn(*args, **kwargs)
            self._put(key, value)
            return value

        return wrapper

    def wrap_sync(self, fn):
        name = getattr(fn, "__name__", self._name)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            key = self._key(name, args, kwargs)
            hit, value = self._get(key)
            if hit:
                return value
            value = fn(*args, **kwargs)
            self._put(key, value)
            return value

        return wrapper


class DefaultCache(DiskCache):
    """Routes to the persistence layer when enabled; disk cache otherwise
    (reference: DefaultCache → PersistenceMode.UDF_CACHING)."""


def with_cache_strategy(fn, cache_strategy: CacheStrategy | None, is_async: bool):
    if cache_strategy is None:
        return fn
    return cache_strategy.wrap_async(fn) if is_async else cache_strategy.wrap_sync(fn)
