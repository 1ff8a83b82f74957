"""The PyTorch port's package contract: it imports neither JAX nor the JAX
package (not by statement, not by a module path in a string, not after a
run), its entry points run on the card unless asked for the CPU, its
``pw`` namespace is the JAX package's, the kernel wrapper has no silent
path, and ``chip_smoke.py`` refuses to run without a card or without the
package beside it."""

import io
import os
import re
import shutil
import subprocess
import sys
import tokenize

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pathway_tpu_torch")


def _run(code_or_args, cwd=REPO, timeout=120, env=None):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_import_loads_no_jax_and_no_jax_package():
    out = _run(
        "import sys, pathway_tpu_torch, pathway_tpu_torch.ops._build\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'pathway_tpu')\n"
        "       or m.startswith(('jax.', 'flax.', 'pathway_tpu.'))]\n"
        "print('BAD', bad)"
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("module", [
    "pathway_tpu_torch.models.hf_loader",
    "pathway_tpu_torch.cli",
    "pathway_tpu_torch.demo",
    "pathway_tpu_torch.parallel.distributed",
])
def test_modules_of_the_launcher_and_the_loader_load_no_jax(module):
    out = _run(
        f"import sys, importlib; importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'pathway_tpu')\n"
        "       or m.startswith(('jax.', 'flax.', 'pathway_tpu.'))]\n"
        "print('BAD', bad)"
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("module", [
    "pathway_tpu_torch.analysis",
    "pathway_tpu_torch.analysis.analyzer",
    "pathway_tpu_torch.analysis.__main__",
    "pathway_tpu_torch.analysis.bench",
    "pathway_tpu_torch.analysis.critical_path",
    "pathway_tpu_torch.analysis.meshcheck",
    "pathway_tpu_torch.analysis.profile",
    "pathway_tpu_torch.analysis.device_plan",
])
def test_modules_of_the_plan_doctor_load_no_jax(module):
    out = _run(
        f"import sys, importlib; importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'pathway_tpu')\n"
        "       or m.startswith(('jax.', 'flax.', 'pathway_tpu.'))]\n"
        "print('BAD', bad)"
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_doctors_run_without_jax():
    """``pw.analyze`` with the Device Doctor and the CLI's device plan and
    mesh modes run through without loading JAX or the JAX package."""
    out = _run(
        "import sys\n"
        "import pathway_tpu_torch as pw\n"
        "from pathway_tpu_torch.analysis.__main__ import main\n"
        "t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])\n"
        "print('VERDICT', pw.analyze(t, device=True).device['verdict'])\n"
        "print('RC', main(['--device-plan']), main(['--mesh', '--processes', '2',"
        " '--mesh-rounds', '1']))\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'pathway_tpu')\n"
        "       or m.startswith(('jax.', 'flax.', 'pathway_tpu.'))]\n"
        "print('BAD', bad)",
        timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert "VERDICT device-clean" in out.stdout and "RC 0 0" in out.stdout
    assert "BAD []" in out.stdout, out.stdout


def test_python_m_pathway_tpu_torch_is_the_cli():
    out = _run(["-m", "pathway_tpu_torch", "--help"])
    assert out.returncode == 0, out.stderr
    for command in ("spawn", "replay", "spawn-from-env", "airbyte"):
        assert command in out.stdout


RUN_SCRIPT = """
import sys
import pathway_tpu_torch as pw
from pathway_tpu_torch.xpacks.llm.mocks import DeterministicMockEmbedder
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

docs = pw.debug.table_from_markdown(
    '''
    data | meta
    the cat sat on the mat | a.txt
    dogs are loyal pets | b.txt
    '''
).select(
    data=pw.this.data,
    _metadata=pw.apply_with_type(
        lambda p: pw.Json({"path": p}), pw.Json, pw.this.meta
    ),
)
server = VectorStoreServer(
    docs, embedder=DeterministicMockEmbedder(8), index_params={"device": "cpu"}
)
queries = pw.debug.table_from_markdown(
    '''
    query | k
    the cat sat on the mat | 1
    ''',
    schema=server.RetrieveQuerySchema,
)
got = []
pw.io.subscribe(
    server.retrieve_query(queries),
    on_change=lambda key, row, time, is_addition: got.extend(
        r["text"] for r in row["result"].value
    ),
)
pw.run()
print("GOT", got[0] if got else None)
bad = [m for m in sys.modules if m in ("jax", "flax", "pathway_tpu")
       or m.startswith(("jax.", "flax.", "pathway_tpu."))]
print("BAD", bad)
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    out = _run(RUN_SCRIPT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "GOT the cat sat on the mat" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


def _port_sources():
    for root, _, files in os.walk(PKG):
        if "_build" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_string_names_a_jax_package_module():
    module_path = re.compile(r"\bpathway_tpu\.[A-Za-z_]")
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.STRING and module_path.search(tok.string):
                offenders.append(f"{os.path.relpath(path, REPO)}:{tok.start[0]}")
    assert offenders == []


def test_no_history_tags_or_tpu_generations_in_the_port():
    tag = re.compile(r"\bISSUE[ -]\d+|\bv5e\b|v5 lite", re.I)
    offenders = []
    for path in [*_port_sources(), os.path.join(PKG, "csrc", "fused_knn.cu")]:
        with open(path, encoding="utf-8") as fh:
            for n, line in enumerate(fh, 1):
                if tag.search(line):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{n}")
    assert offenders == []


def test_every_registered_knob_is_read_by_the_port():
    """The knob gate accepts a registered PATHWAY_* variable silently, so a
    knob that nothing reads would be a setting that does nothing."""
    from pathway_tpu_torch.analysis.knobs import KNOBS

    registry = os.path.join(PKG, "analysis", "knobs.py")
    sources = "\n".join(
        open(p, encoding="utf-8").read() for p in _port_sources() if p != registry
    )
    # the registry reads its own escape hatch
    unread = [n for n in KNOBS if n not in sources and n != "PATHWAY_KNOB_CHECK"]
    assert unread == []


NATIVE_JAX_PACKAGE = """
import pathway_tpu.native as native
print("FASTPATH", native.get_fastpath().__file__)
"""

NATIVE_PORT = '''
import sys
import pathway_tpu_torch as pw
from pathway_tpu_torch import native
print("FASTPATH", native.get_fastpath().__file__)
t = pw.debug.table_from_markdown("""
k | v
a | 1
a | 2
b | 3
""")
pw.debug.compute_and_print(
    t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v)),
    include_id=False,
)
print("BAD", [m for m in sys.modules if m == "pathway_tpu" or m.startswith("pathway_tpu.")])
'''


def test_native_build_dir_override_keeps_the_packages_apart(tmp_path):
    """Under PATHWAY_NATIVE_BUILD_DIR, which both packages read, the port
    builds its extensions into a subdirectory of its own: the two
    packages' extensions share file names but import different engine
    modules. The JAX package builds first; the port then loads its own
    build and runs a pipeline without importing the JAX package."""
    env = {"PATHWAY_NATIVE_BUILD_DIR": str(tmp_path)}
    first = _run(NATIVE_JAX_PACKAGE, env=env, timeout=300)
    assert first.returncode == 0, first.stderr
    second = _run(NATIVE_PORT, env=env, timeout=300)
    assert second.returncode == 0, second.stderr
    jax_so = first.stdout.split("FASTPATH ")[1].split()[0]
    port_so = second.stdout.split("FASTPATH ")[1].split()[0]
    assert os.path.dirname(jax_so) == str(tmp_path)
    assert os.path.dirname(port_so) == os.path.join(str(tmp_path), "torch")
    assert "BAD []" in second.stdout, second.stdout
    assert "a | 3" in second.stdout and "b | 3" in second.stdout, second.stdout


# names of ``pathway_tpu`` that come with a later slice of the port: none
# is left
DEFERRED: set = set()


def test_pw_namespace_matches_the_jax_package():
    import json

    import pathway_tpu_torch

    # each package's namespace as a fresh import declares it: in this
    # process, submodules other tests imported appear as attributes too
    out = _run(
        "import json, pathway_tpu, pathway_tpu_torch\n"
        "print(json.dumps([dir(pathway_tpu), dir(pathway_tpu_torch)]))",
        timeout=240,
    )
    assert out.returncode == 0, out.stderr
    jax_names, port_names = json.loads(out.stdout.strip().splitlines()[-1])
    want = {n for n in jax_names if not n.startswith("_")} - DEFERRED
    got = {n for n in port_names if not n.startswith("_")}
    assert want - got == set()
    for name in sorted(want):
        value = getattr(pathway_tpu_torch, name)  # lazy names resolve
        mod = getattr(value, "__module__", None) or getattr(value, "__name__", "")
        if isinstance(mod, str) and mod.startswith("pathway_tpu"):
            assert mod.startswith("pathway_tpu_torch"), (name, mod)


@pytest.mark.parametrize("module", [
    "pathway_tpu_torch.parallel.ring_attention",
    "pathway_tpu_torch.parallel.train",
])
def test_ring_attention_and_training_load_no_jax(module):
    out = _run(
        f"import sys, importlib; importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', 'pathway_tpu')\n"
        "       or m.startswith(('jax.', 'flax.', 'optax.', 'pathway_tpu.'))]\n"
        "print('BAD', bad)"
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_parallel_namespace_covers_the_jax_package():
    import json

    out = _run(
        "import json, pathway_tpu.parallel as a, pathway_tpu_torch.parallel as b\n"
        "print(json.dumps([a.__all__, dir(b)]))",
        timeout=240,
    )
    assert out.returncode == 0, out.stderr
    jax_all, port_dir = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(jax_all) - set(port_dir) == set()
    import pathway_tpu_torch.parallel as port

    for name in jax_all:
        assert getattr(port, name).__module__.startswith("pathway_tpu_torch.parallel"), name
    from pathway_tpu_torch.parallel import ring_attention

    assert ring_attention.__name__ == "pathway_tpu_torch.parallel.ring_attention"


# modules of the JAX package that the port deliberately has under another
# name or not at all: the Pallas kernel's module became the CUDA kernel's
# wrapper, and the shard_map version shim has nothing to shim
RENAMED = {"ops/pallas_knn.py": "ops/fused_knn.py", "parallel/_compat.py": None}


def test_every_module_of_the_jax_package_has_a_counterpart():
    def tree(root):
        return {
            os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")
        }

    jax_files, port_files = tree(os.path.join(REPO, "pathway_tpu")), tree(PKG)
    missing = jax_files - port_files
    assert missing == set(RENAMED)
    for renamed in RENAMED.values():
        assert renamed is None or renamed in port_files


def test_no_source_file_imports_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(pathway_tpu(\.|\s|$)|jax\b|flax\b|optax\b)", re.M
    )
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


@pytest.mark.parametrize(
    "make",
    [
        "resolve_device(None)",
        "SentenceEncoder(EncoderConfig.tiny())",
        "SentenceEncoder(checkpoint='no-such-checkpoint')",
        "KnnShard(8)",
        "IngestPipeline(SentenceEncoder(EncoderConfig.tiny(), device='cpu'),"
        " KnnShard(64, device='cpu'))",
        "QueryEngine(SentenceEncoder(EncoderConfig.tiny(), device='cpu'),"
        " KnnShard(64, device='cpu'))",
    ],
)
def test_entry_points_refuse_to_drop_to_cpu(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import pathway_tpu_torch as pt

    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval(make, vars(pt))


def _one_vector_column(pt):
    return pt.debug.table_from_markdown("v\n1").select(
        v=pt.apply_with_type(lambda x: (1.0, 0.0, 0.0, 0.0), tuple, pt.this.v)
    ).v


DEVICE_ENTRY_POINTS = {
    "SentenceTransformerEmbedder": lambda pt, kw: (
        pt.xpacks.llm.embedders.SentenceTransformerEmbedder("tiny", **kw)
    ),
    "BruteForceKnnFactory": lambda pt, kw: (
        pt.indexing.BruteForceKnnFactory(dimensions=4, **kw)
        .build_inner_index(_one_vector_column(pt))
        .make_adapter()
    ),
    "CrossEncoder": lambda pt, kw: pt.models.CrossEncoder(
        pt.EncoderConfig.tiny(), **kw
    ),
    "CrossEncoderReranker": lambda pt, kw: (
        pt.xpacks.llm.rerankers.CrossEncoderReranker("tiny", **kw)
    ),
}


@pytest.mark.parametrize("name", sorted(DEVICE_ENTRY_POINTS))
def test_dataflow_entry_points_refuse_to_drop_to_cpu(name):
    import pathway_tpu_torch as pt
    import pathway_tpu_torch.models  # noqa: F401
    import pathway_tpu_torch.xpacks.llm.embedders  # noqa: F401
    import pathway_tpu_torch.xpacks.llm.rerankers  # noqa: F401

    make = DEVICE_ENTRY_POINTS[name]
    assert make(pt, {"device": "cpu"}) is not None
    if torch.cuda.is_available():
        return  # a CUDA device is present: the default device is valid
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(pt, {})


def test_cpu_is_taken_when_asked():
    import pathway_tpu_torch as pt

    assert pt.resolve_device("cpu") == torch.device("cpu")
    assert pt.KnnShard(8, device="cpu").vectors.device.type == "cpu"


@pytest.mark.parametrize("k", [8193, 10000, 0])
def test_fused_topk_scores_rejects_k_out_of_range(k):
    from pathway_tpu_torch.ops.fused_knn import fused_topk_scores

    q, db = torch.zeros(1, 8), torch.zeros(256, 8)
    with pytest.raises(ValueError, match="k <= 8192"):
        fused_topk_scores(q, db, torch.ones(256, dtype=torch.bool), k)


def test_kernel_sources_and_flags():
    from pathway_tpu_torch.ops import _build

    assert _build.sources() == ["fused_knn"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
    assert "use_fast_math" not in flags  # the kernel's scores are IEEE fp32
    with open(os.path.join(_build.CSRC, "fused_knn.cu"), encoding="utf-8") as f:
        src = f.read()
    assert "pathway_tpu/ops/pallas_knn.py:_knn_kernel" in src
    assert "3.35 TB/s" in src
    assert "torch" not in src  # a plain C interface, bound with ctypes


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    from pathway_tpu_torch.ops import _build

    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("fused_knn")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# keywords of the JAX package's public functions and classes that the port
# deliberately does not take, each with its reason ("module:name" -> names)
KEYWORD_EXEMPT = {
    # Flax's module fields: the port's models are torch.nn.Modules
    "models/cross_encoder.py:CrossEncoderModel": {"name", "parent"},
    "models/encoder.py:TransformerEncoder": {"name", "parent"},
    # shard_map's axis plumbing: torch has no shard_map, and the port's
    # recursive doubling takes the per-shard lists themselves
    "ops/topk.py:tree_merge_topk": {"axis", "axis_size"},
    # the port's sharded_topk takes a list of per-device shards (a mesh of
    # torch devices holds no global sharded array to pass)
    "parallel/sharded_knn.py:sharded_topk": {"mesh", "axis", "database", "valid"},
    # Flax's parameter tree (path, leaf) and its sharding map: the port
    # shards nn.Module parameters by name
    "parallel/train.py:param_sharding_rules": {"path", "leaf"},
    "parallel/train.py:make_param_shardings": {"params"},
    # the Pallas kernel's wrapper became the CUDA kernel's: a bool mask in
    # place of the additive one, and no TPU block or interpret mode (the
    # kernel plans its own tiles; the CPU runs the plain version)
    "ops/pallas_knn.py:pallas_topk_scores": {"add_mask", "block", "interpret"},
}
# public names the port has under another name, and the jit idioms it has
# not at all (PyTorch runs eagerly: there is no executable to build)
RENAMED_NAMES = {
    "ops/pallas_knn.py:pallas_topk_scores": "fused_topk_scores",
    "ops/pallas_knn.py:pallas_knn_cost": "fused_knn_cost",
    "ops/ingest.py:make_fused": None,
    "parallel/sharded_knn.py:make_sharded_write": None,
}


def _keywords(obj):
    """(the names a caller may pass by keyword, whether **kwargs is taken),
    or None where Python cannot read a signature."""
    import inspect

    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    params = sig.parameters.values()
    return (
        {p.name for p in params if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)},
        any(p.kind is p.VAR_KEYWORD for p in params),
    )


def test_public_signatures_accept_the_jax_keywords():
    """For every public function and class of the JAX package's modules
    that import JAX, the port's counterpart accepts every keyword the JAX
    one accepts, but for the exemptions above."""
    import importlib
    import inspect

    jax_import = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    root = os.path.join(REPO, "pathway_tpu")
    modules = sorted(
        os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
        for d, _, fs in os.walk(root) for f in fs
        if f.endswith(".py") and jax_import.search(open(os.path.join(d, f), encoding="utf-8").read())
    )
    assert "ops/knn.py" in modules and "parallel/sharded_knn.py" in modules
    missing, compared, used = [], 0, set()
    for rel in modules:
        port_rel = RENAMED.get(rel, rel)
        if port_rel is None:
            continue
        name_of = lambda r: r[:-3].replace("/", ".").removesuffix(".__init__")  # noqa: E731
        jmod = importlib.import_module("pathway_tpu." + name_of(rel))
        pmod = importlib.import_module("pathway_tpu_torch." + name_of(port_rel))
        for name, obj in vars(jmod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != jmod.__name__:
                continue
            if not (inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            key = f"{rel}:{name}"
            port_name = RENAMED_NAMES.get(key, name)
            if port_name is None:
                used.add(key)
                continue
            if key in RENAMED_NAMES:
                used.add(key)
            want, got = _keywords(obj), _keywords(getattr(pmod, port_name, None))
            if want is None:
                continue
            assert got is not None, f"{key}: the port has no {port_name}"
            compared += 1
            if got[1]:
                continue
            lost = want[0] - got[0] - KEYWORD_EXEMPT.get(key, set())
            if key in KEYWORD_EXEMPT:
                used.add(key)
            if lost:
                missing.append(f"{key}: {sorted(lost)}")
    assert missing == []
    assert compared > 50
    # every exemption still names something the JAX package has
    assert used == set(KEYWORD_EXEMPT) | set(RENAMED_NAMES)
