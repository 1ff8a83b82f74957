"""pw.udf — user-defined functions (reference:
python/pathway/internals/udfs/__init__.py:68 UDF class, :290 @pw.udf;
executors.py:36,92,132).

Differences from the reference, by design (SURVEY §7 stage 4): UDFs may be
*batched* (``max_batch_size``) — the engine hands whole logical-time batches
as lists, which is the ≥10k docs/s embedding-ingest lever; the reference
calls UDFs one row at a time.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
)
from pathway_tpu_torch.udfs.caches import (
    CacheStrategy,
    DefaultCache,
    DiskCache,
    InMemoryCache,
    with_cache_strategy,
)
from pathway_tpu_torch.udfs.retries import (
    AsyncRetryStrategy,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    NoRetryStrategy,
    RetryPolicy,
)

__all__ = [
    "UDF",
    "udf",
    "auto_executor",
    "sync_executor",
    "async_executor",
    "AutoExecutor",
    "SyncExecutor",
    "AsyncExecutor",
    "CacheStrategy",
    "DefaultCache",
    "DiskCache",
    "InMemoryCache",
    "AsyncRetryStrategy",
    "ExponentialBackoffRetryStrategy",
    "FixedDelayRetryStrategy",
    "NoRetryStrategy",
    "RetryPolicy",
    "coerce_async",
    "async_options",
]


class Executor:
    pass


class AutoExecutor(Executor):
    pass


class SyncExecutor(Executor):
    pass


class AsyncExecutor(Executor):
    def __init__(
        self,
        *,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
    ):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy

    def wrap(self, fn: Callable) -> Callable:
        capacity = self.capacity
        timeout = self.timeout
        retry = self.retry_strategy
        semaphore_holder: list[asyncio.Semaphore | None] = [None]

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            async def call():
                if retry is not None:
                    coro = retry.invoke(fn, *args, **kwargs)
                else:
                    coro = fn(*args, **kwargs)
                if timeout is not None:
                    return await asyncio.wait_for(coro, timeout)
                return await coro

            if capacity is not None:
                if semaphore_holder[0] is None:
                    semaphore_holder[0] = asyncio.Semaphore(capacity)
                async with semaphore_holder[0]:
                    return await call()
            return await call()

        return wrapper


def auto_executor() -> AutoExecutor:
    return AutoExecutor()


def sync_executor() -> SyncExecutor:
    return SyncExecutor()


def async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
) -> AsyncExecutor:
    return AsyncExecutor(capacity=capacity, timeout=timeout, retry_strategy=retry_strategy)


def fully_async_executor(**kwargs) -> AsyncExecutor:
    return AsyncExecutor(**kwargs)


def coerce_async(fn: Callable) -> Callable:
    if inspect.iscoroutinefunction(fn):
        return fn

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapper


def async_options(**options):
    """Decorator adding executor options to a plain coroutine."""

    def decorator(fn):
        return udf(fn, executor=async_executor(**options))

    return decorator


class UDF:
    """Wraps a function (or subclasses override __wrapped__) into a callable
    producing Apply expressions."""

    def __init__(
        self,
        func: Callable | None = None,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        max_batch_size: int | None = None,
    ):
        self.func = func if func is not None else self.__wrapped__
        self.return_type = return_type
        self.deterministic = deterministic
        self.propagate_none = propagate_none
        self.executor = executor or AutoExecutor()
        self.cache_strategy = cache_strategy
        self.max_batch_size = max_batch_size
        functools.update_wrapper(self, self.func)

    # subclasses may define __wrapped__ as a method
    def __wrapped__(self, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError

    def _resolved_return_type(self) -> Any:
        if self.return_type is not None:
            return self.return_type
        hints = None
        try:
            hints = inspect.signature(self.func).return_annotation
        except (TypeError, ValueError):
            pass
        if hints is inspect.Signature.empty or hints is None:
            return dt.ANY
        return hints

    def __call__(self, *args, **kwargs):
        fn = self.func
        is_async = inspect.iscoroutinefunction(fn)
        use_async = is_async or isinstance(self.executor, AsyncExecutor)
        ret = self._resolved_return_type()
        if use_async:
            afn = coerce_async(fn)
            if isinstance(self.executor, AsyncExecutor):
                afn = self.executor.wrap(afn)
            afn = with_cache_strategy(afn, self.cache_strategy, is_async=True)
            return AsyncApplyExpression(
                afn, ret, self.propagate_none, self.deterministic, args, kwargs
            )
        sfn = with_cache_strategy(fn, self.cache_strategy, is_async=False)
        return ApplyExpression(
            sfn,
            ret,
            self.propagate_none,
            self.deterministic,
            args,
            kwargs,
            max_batch_size=self.max_batch_size,
        )


def udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
    max_batch_size: int | None = None,
):
    """@pw.udf decorator (reference: udfs/__init__.py:290)."""

    def wrapper(f):
        return UDF(
            f,
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
        )

    if fun is not None:
        return wrapper(fun)
    return wrapper
