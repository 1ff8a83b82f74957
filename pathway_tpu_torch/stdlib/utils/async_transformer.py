"""AsyncTransformer (reference:
python/pathway/stdlib/utils/async_transformer.py:282 — table-in/table-out
async transform with completion tracking; the mechanism behind
serve_callable).

Subclass, define ``output_schema`` and ``async def invoke(**input_row) ->
dict``. Per logical-time batch all rows run concurrently on one event loop
(reference: _AsyncConnector semantics); outputs are memoized so retractions
replay the original values."""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from typing import Any, ClassVar

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ERROR
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema, schema_from_types
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe

_ASYNC_STATUS_COLUMN = "_async_status"


class AsyncTransformer(ABC):
    output_schema: ClassVar[type[Schema]]

    def __init_subclass__(cls, /, output_schema: type[Schema] | None = None, **kwargs):
        super().__init_subclass__(**kwargs)
        if output_schema is not None:
            cls.output_schema = output_schema

    def __init__(self, input_table: Table, *, instance=None, **kwargs):
        self._input_table = input_table
        self._retry_strategy = None
        self._cache_strategy = None
        self._capacity = None
        self._timeout = None
        self._results: Table | None = None

    @abstractmethod
    async def invoke(self, *args, **kwargs) -> dict[str, Any]:
        ...

    def with_options(
        self,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy=None,
        cache_strategy=None,
    ) -> "AsyncTransformer":
        self._capacity = capacity
        self._timeout = timeout
        self._retry_strategy = retry_strategy
        self._cache_strategy = cache_strategy
        return self

    def open(self) -> None:  # lifecycle hooks (reference parity)
        pass

    def close(self) -> None:
        pass

    # -- result tables -----------------------------------------------------
    @property
    def finished(self) -> Table:
        if self._results is None:
            self._results = self._build()
        return self._results

    @property
    def result(self) -> Table:
        return self.successful

    @property
    def successful(self) -> Table:
        fin = self.finished
        ok = fin.filter(fin[_ASYNC_STATUS_COLUMN] == "-SUCCESS-")
        return ok.without(_ASYNC_STATUS_COLUMN)

    @property
    def failed(self) -> Table:
        fin = self.finished
        return fin.filter(fin[_ASYNC_STATUS_COLUMN] == "-FAILURE-").without(
            _ASYNC_STATUS_COLUMN
        )

    # -- lowering ----------------------------------------------------------
    def _build(self) -> Table:
        input_table = self._input_table
        out_cols = list(self.output_schema.column_names())
        schema = schema_from_types(
            **{
                **dict(self.output_schema.typehints()),
                _ASYNC_STATUS_COLUMN: dt.STR,
            }
        )
        out = Table(schema, input_table._universe)
        in_cols = input_table.column_names()
        transformer = self
        sem_capacity = self._capacity
        timeout = self._timeout
        retry = self._retry_strategy

        def lower(ctx):
            et = ctx.engine_table(input_table)

            def batch_fn(keys, rows):
                async def one(row):
                    kwargs = dict(zip(in_cols, row))

                    async def call():
                        res = transformer.invoke(**kwargs)
                        if asyncio.iscoroutine(res):
                            res = await res
                        return res

                    async def timed():
                        if timeout is not None:
                            return await asyncio.wait_for(call(), timeout)
                        return await call()

                    try:
                        if retry is not None:
                            result = await retry.invoke(timed)
                        else:
                            result = await timed()
                        return tuple(
                            result.get(c) for c in out_cols
                        ) + ("-SUCCESS-",)
                    except Exception:
                        return tuple(ERROR for _ in out_cols) + ("-FAILURE-",)

                async def run_all():
                    if sem_capacity is not None:
                        sem = asyncio.Semaphore(sem_capacity)

                        async def guarded(row):
                            async with sem:
                                return await one(row)

                        return await asyncio.gather(
                            *(guarded(r) for r in rows)
                        )
                    return await asyncio.gather(*(one(r) for r in rows))

                loop = ctx.runtime.async_loop
                return list(loop.run_until_complete(run_all()))

            ctx.set_engine_table(
                out, ctx.scope.rowwise_memoized(et, batch_fn, len(out_cols) + 1)
            )

        G.add_operator([input_table], [out], lower, "async_transformer")
        return out
