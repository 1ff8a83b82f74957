"""Global graph capture (reference: python/pathway/internals/parse_graph.py:104,
global instance ``G`` at :244; operator hierarchy internals/operator.py).

Nothing executes at declaration time: every Table method appends an
``Operator`` to ``G``.  ``pw.run()`` / ``pw.debug.compute_and_print`` lower
the reachable subgraph onto an engine Runtime (graph_runner.py).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import TYPE_CHECKING, Any, Callable

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class Operator:
    """A captured graph node.

    ``lower_fn(ctx)`` is responsible for computing engine tables for every
    output table and registering them via ``ctx.set_engine_table``.
    """

    _ids = itertools.count()

    def __init__(
        self,
        inputs: list["Table"],
        outputs: list["Table"],
        lower_fn: Callable[[Any], None],
        name: str,
        is_output: bool = False,
    ):
        self.id = next(Operator._ids)
        self.inputs = inputs
        self.outputs = outputs
        self.lower_fn = lower_fn
        self.name = name
        self.is_output = is_output
        self.trace = _user_frame()
        for t in outputs:
            t._source = self

    def __repr__(self):
        return f"Operator#{self.id}({self.name})"


class ParseGraph:
    def __init__(self):
        self.operators: list[Operator] = []
        self.cache: dict[Any, Any] = {}

    def add_operator(
        self,
        inputs: list["Table"],
        outputs: list["Table"],
        lower_fn: Callable[[Any], None],
        name: str,
        is_output: bool = False,
    ) -> Operator:
        op = Operator(inputs, outputs, lower_fn, name, is_output)
        self.operators.append(op)
        return op

    def output_operators(self) -> list[Operator]:
        return [op for op in self.operators if op.is_output]

    def reachable_operators(self, targets: list[Operator]) -> list[Operator]:
        """Tree-shake: ancestors of targets, in creation (topological) order."""
        needed: set[int] = set()
        stack = list(targets)
        while stack:
            op = stack.pop()
            if op.id in needed:
                continue
            needed.add(op.id)
            for t in op.inputs:
                if t._source is not None:
                    stack.append(t._source)
        return [op for op in self.operators if op.id in needed]

    def clear(self) -> None:
        self.operators.clear()
        self.cache.clear()

    @contextlib.contextmanager
    def scoped(self):
        """Capture operators declared inside the block into a private list
        instead of the global graph (reference: iterate subscopes,
        parse_graph.py Scope :27). Yields the list; on exit the global
        operator list is restored."""
        saved = self.operators
        self.operators = []
        try:
            yield self.operators
        finally:
            self.operators = saved


G = ParseGraph()


def _user_frame():
    """First stack frame outside this package — the user line that declared
    the operator (reference: internals/trace.py; re-raise at
    graph_runner/__init__.py:217-229)."""
    import traceback

    pkg = __name__.split(".")[0]
    for frame in reversed(traceback.extract_stack()[:-2]):
        fname = frame.filename.replace("\\", "/")
        if f"/{pkg}/" not in fname and "<frozen" not in fname:
            return frame
    return None


def clear_graph() -> None:
    G.clear()
