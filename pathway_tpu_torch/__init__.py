"""pathway_tpu_torch — the PyTorch / CUDA port of pathway_tpu, an
incremental streaming dataflow framework, for NVIDIA Hopper (H100).

The capabilities of Pathway (github.com/pathwaycom/pathway): a declarative
Table DSL, unified batch+streaming semantics with retractions, IO
connectors, temporal operators, vector indexes and an LLM/RAG xpack. The
dense hot path runs on the card: the bge-small sentence encoder in
PyTorch, and the device-resident KNN index whose search is a fused KNN
kernel written by hand in CUDA C++ for ``sm_90a`` (``csrc/fused_knn.cu``),
built with ``nvcc`` at first use. Entry points that touch the device run
on the card unless the caller passes ``device="cpu"``.

Use as: ``import pathway_tpu_torch as pw``. The live-RAG device path is
exported beside the dataflow names (``KnnShard``, ``SentenceEncoder``,
``IngestPipeline``, ``QueryEngine``, ...).

This package imports ``torch`` and numpy, never JAX or the JAX package.
"""

from __future__ import annotations

from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.api import (
    ERROR,
    PENDING,
    Json,
    Pointer,
    PyObjectWrapper,
    unsafe_make_pointer,
    wrap_py_object,
)
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply,
    apply_async,
    apply_with_type,
    assert_table_has_columns,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    make_tuple,
    require,
    unwrap,
)
from pathway_tpu_torch.internals.groupbys import GroupedTable
from pathway_tpu_torch.internals.iterate import iterate
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult
from pathway_tpu_torch.internals.parse_graph import G, ParseGraph
from pathway_tpu_torch.internals.schema import (
    ColumnDefinition,
    Schema,
    column_definition,
    schema_builder,
    schema_from_dict,
    schema_from_pandas,
    schema_from_types,
)
from pathway_tpu_torch.internals.table import Table, TableLike
from pathway_tpu_torch.internals.thisclass import left, right, this
from pathway_tpu_torch.internals.universe import SOLVER, Universe
from pathway_tpu_torch.run import run, run_all
from pathway_tpu_torch.udfs import UDF, udf

# user-facing datetime classes (reference: internals/datetime_types.py) —
# usable as schema annotations AND constructors (pw.Duration(days=1));
# the dtype resolver maps them onto DATE_TIME_NAIVE/UTC/DURATION
from pathway_tpu_torch.internals.datetime_types import (  # noqa: E402
    DateTimeNaive,
    DateTimeUtc,
    Duration,
)

from pathway_tpu_torch import debug, io, udfs  # noqa: E402
from pathway_tpu_torch.internals.config import (  # noqa: E402
    PathwayConfig,
    get_pathway_config,
    set_license_key,
    set_monitoring_config,
)
from pathway_tpu_torch.internals.monitoring import MonitoringLevel  # noqa: E402
from pathway_tpu_torch.internals.yaml_loader import load_yaml  # noqa: E402
from pathway_tpu_torch.internals.compat import (  # noqa: E402
    BaseCustomAccumulator,
    PersistenceMode,
    SchemaProperties,
    Type,
    assert_table_has_schema,
    groupby,
    iterate_universe,
    join,
    join_inner,
    join_left,
    join_outer,
    join_right,
    local_error_log,
    schema_from_csv,
    table_transformer,
)
from pathway_tpu_torch.internals.error_log import (  # noqa: E402
    global_error_log,
    remove_errors_from_table,
)
from pathway_tpu_torch.internals.interactive import (  # noqa: E402
    enable_interactive_mode,
    live,
)
from pathway_tpu_torch.internals import interactive  # noqa: E402
from pathway_tpu_torch.internals.row_transformer import (  # noqa: E402
    attribute,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)
from pathway_tpu_torch.sql_module import sql  # noqa: E402
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer  # noqa: E402
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer  # noqa: E402
from pathway_tpu_torch import udfs as asynchronous  # noqa: E402  (reference alias)
from pathway_tpu_torch.internals.interactive import LiveTableHandle as LiveTable  # noqa: E402

# UDF aliases (reference: udf_async/UDFAsync/UDFSync deprecated spellings)
UDFSync = UDF
UDFAsync = UDF


def udf_async(fun=None, **kwargs):
    """reference: pw.udf_async — async-executor UDF decorator."""
    from pathway_tpu_torch.udfs import AsyncExecutor, udf as _udf

    kwargs.setdefault("executor", AsyncExecutor())
    return _udf(fun, **kwargs) if fun is not None else _udf(**kwargs)

# the live-RAG device path (the port's first slices)
from pathway_tpu_torch.internals.device import resolve_device  # noqa: E402
from pathway_tpu_torch.models import (  # noqa: E402
    EncoderConfig,
    SentenceEncoder,
    TransformerEncoder,
    flax_params_to_torch,
    get_tokenizer,
    init_params,
)
from pathway_tpu_torch.ops import (  # noqa: E402
    IngestPipeline,
    KnnShard,
    Metric,
    MicroBatcher,
    QueryEngine,
    chunked_topk_scores,
    fused_topk_scores,
    masked_topk,
    merge_topk,
)

__version__ = "0.1.0"

_LAZY_ATTRS = {
    # plan doctor (static dataflow-plan analysis)
    "analyze": ("pathway_tpu_torch.analysis.analyzer", "analyze"),
    "PlanReport": ("pathway_tpu_torch.analysis.analyzer", "PlanReport"),
    # join-result classes exposed at top level (reference __all__)
    "IntervalJoinResult": ("pathway_tpu_torch.stdlib.temporal", "IntervalJoinResult"),
    "AsofJoinResult": ("pathway_tpu_torch.stdlib.temporal", "AsofJoinResult"),
    "WindowJoinResult": (
        "pathway_tpu_torch.stdlib.temporal._window_join", "WindowJoinResult",
    ),
    "Joinable": ("pathway_tpu_torch.internals.table", "Table"),
    "OuterJoinResult": ("pathway_tpu_torch.internals.joins", "JoinResult"),
    "GroupedJoinResult": ("pathway_tpu_torch.internals.groupbys", "GroupedTable"),
    "TableSlice": ("pathway_tpu_torch.internals.table", "_TableSlice"),
    "viz": ("pathway_tpu_torch.stdlib.viz", None),
    "window": ("pathway_tpu_torch.stdlib.temporal", None),
}

_LAZY_MODULES = {
    "analysis": "pathway_tpu_torch.analysis",
    "demo": "pathway_tpu_torch.demo",
    "indexing": "pathway_tpu_torch.stdlib.indexing",
    "temporal": "pathway_tpu_torch.stdlib.temporal",
    "ml": "pathway_tpu_torch.stdlib.ml",
    "stateful": "pathway_tpu_torch.stdlib.stateful",
    "statistical": "pathway_tpu_torch.stdlib.statistical",
    "ordered": "pathway_tpu_torch.stdlib.ordered",
    "graphs": "pathway_tpu_torch.stdlib.graphs",
    "utils": "pathway_tpu_torch.stdlib.utils",
    "xpacks": "pathway_tpu_torch.xpacks",
    "universes": "pathway_tpu_torch.universes",
    "persistence": "pathway_tpu_torch.persistence",
    "sql_module": "pathway_tpu_torch.sql_module",
}


def __getattr__(name: str):
    import importlib

    if name in _LAZY_MODULES:
        mod = importlib.import_module(_LAZY_MODULES[name])
        globals()[name] = mod
        return mod
    if name in _LAZY_ATTRS:
        mod_name, attr = _LAZY_ATTRS[name]
        mod = importlib.import_module(mod_name)
        value = mod if attr is None else getattr(mod, attr)
        globals()[name] = value
        return value
    if name == "sql":
        from pathway_tpu_torch.sql_module import sql as _sql

        globals()["sql"] = _sql
        return _sql
    if name == "iterate":
        from pathway_tpu_torch.internals.iterate import iterate as _iterate

        globals()["iterate"] = _iterate
        return _iterate
    raise AttributeError(f"module 'pathway_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_LAZY_MODULES.keys()) + ["sql", "iterate"])
