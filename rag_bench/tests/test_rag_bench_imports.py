"""Nothing the harness runs imports JAX or the JAX package, by top-level
module names compared whole; the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from rag_bench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "pathway_tpu"}
SOURCES = [os.path.join(d, f) for d, _, fs in os.walk(run.HERE) for f in fs
           if f.endswith(".py")]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, run.HERE))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_names_compare_whole():
    # the port's name begins with the JAX package's and must not match it
    saved = dict(sys.modules)
    try:
        sys.modules.pop("pathway_tpu", None)
        sys.modules["pathway_tpu_torch_lookalike"] = sys
        assert "pathway_tpu" not in run.forbidden_modules()
        sys.modules["pathway_tpu.sub"] = sys
        assert "pathway_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


REFERENCE = [os.path.join(run.HERE, "reference", f)
             for f in os.listdir(os.path.join(run.HERE, "reference")) if f.endswith(".py")]


@pytest.mark.parametrize("path", REFERENCE, ids=os.path.basename)
def test_reference_sources_import_nothing_of_the_program(path):
    assert "pathway_tpu_torch" not in set(_imports(path))


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; import rag_bench.reference.bert, rag_bench.reference.knn, "
            "rag_bench.reference.tokenizer, rag_bench.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'pathway_tpu_torch', 'pathway_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == "[]"


def test_a_run_loads_no_jax_in_a_fresh_process():
    """A whole tiny serve run in its own interpreter: ``run.execute``
    exits 3 if the program pulled in JAX or the JAX package."""
    code = ("import sys, time, torch; from rag_bench import run; "
            "from rag_bench.tests import tiny; "
            "m, a, c, t = tiny.cell('msmarco-serve', seconds=0.5); "
            "sys.exit(run.execute(m, a, c, t, torch.device('cpu'), 'cpu', "
            "time.perf_counter()))")
    res = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert '"correct": true' in res.stdout.strip().splitlines()[-1]
