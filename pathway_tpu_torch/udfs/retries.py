"""Retry strategies for async UDFs (reference:
python/pathway/internals/udfs/retries.py) plus the sync-capable
RetryPolicy the connector supervision layer shares with them
(engine/runtime.py + io/_connector.py)."""

from __future__ import annotations

import asyncio
import random
import time
from abc import ABC, abstractmethod
from typing import Callable


def is_retryable(
    exc: Exception, retry_on: Callable[[Exception], bool] | None = None
) -> bool:
    """Shared failure classification (RetryPolicy + the connector
    supervisor): an explicit ``retry_on`` wins; otherwise honor the
    exception's ``retryable`` attribute, defaulting to True."""
    if retry_on is not None:
        return bool(retry_on(exc))
    return getattr(exc, "retryable", True)


class RetryPolicy:
    """Retry schedule usable from sync and async callers.

    ``retry_on(exc) -> bool`` classifies exceptions: returning False
    fails fast (auth failures, schema mismatches); the default honors an
    exception's ``retryable`` attribute when present (e.g.
    internals/faults.InjectedFault) and retries everything else. ``rng``
    seeds the jitter so backoff schedules replay deterministically;
    ``max_delay_ms`` caps exponential growth.
    """

    def __init__(
        self,
        max_retries: int = 3,
        initial_delay_ms: float = 1_000,
        backoff_factor: float = 2.0,
        jitter_ms: float = 300,
        retry_on: Callable[[Exception], bool] | None = None,
        rng: random.Random | None = None,
        max_delay_ms: float | None = None,
    ):
        self.max_retries = max_retries
        self._initial = initial_delay_ms / 1000
        self._factor = backoff_factor
        self._jitter = jitter_ms / 1000
        self.retry_on = retry_on
        self._rng = rng if rng is not None else random
        self._max_delay = None if max_delay_ms is None else max_delay_ms / 1000

    def retryable(self, exc: Exception) -> bool:
        return is_retryable(exc, self.retry_on)

    def should_retry(self, exc: Exception, attempt: int) -> bool:
        """``attempt``: 0-based count of retries already taken."""
        return attempt < self.max_retries and self.retryable(exc)

    def delay_s(self, attempt: int) -> float:
        delay = self._initial * self._factor**attempt
        if self._max_delay is not None:
            delay = min(delay, self._max_delay)
        return delay + self._rng.random() * self._jitter

    def invoke_sync(self, fn, /, *args, **kwargs):
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                if not self.should_retry(exc, attempt):
                    raise
                time.sleep(self.delay_s(attempt))
                attempt += 1


class AsyncRetryStrategy(ABC):
    @abstractmethod
    async def invoke(self, async_fn, /, *args, **kwargs): ...


class NoRetryStrategy(AsyncRetryStrategy):
    async def invoke(self, async_fn, /, *args, **kwargs):
        return await async_fn(*args, **kwargs)


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1_000,
        backoff_factor: float = 2.0,
        jitter_ms: int = 300,
        retry_on: Callable[[Exception], bool] | None = None,
    ):
        # retry_on=None preserves the historical behavior exactly: every
        # exception retries until the budget runs out (retry_on short-
        # circuits RetryPolicy's retryable-attribute default too)
        self._policy = RetryPolicy(
            max_retries=max_retries,
            initial_delay_ms=initial_delay,
            backoff_factor=backoff_factor,
            jitter_ms=jitter_ms,
            retry_on=retry_on if retry_on is not None else (lambda exc: True),
        )

    async def invoke(self, async_fn, /, *args, **kwargs):
        attempt = 0
        while True:
            try:
                return await async_fn(*args, **kwargs)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if not self._policy.should_retry(exc, attempt):
                    raise
                await asyncio.sleep(self._policy.delay_s(attempt))
                attempt += 1


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    def __init__(
        self,
        max_retries: int = 3,
        delay_ms: int = 1_000,
        retry_on: Callable[[Exception], bool] | None = None,
    ):
        super().__init__(
            max_retries=max_retries,
            initial_delay=delay_ms,
            backoff_factor=1.0,
            jitter_ms=0,
            retry_on=retry_on,
        )
