"""The PyTorch port's package contract: it imports neither JAX nor the JAX
package, its entry points run on the card unless asked for the CPU, the
kernel wrapper has no silent path, and ``chip_smoke.py`` refuses to run
without a card or without the package beside it."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pathway_tpu_torch")


def _run(code_or_args, cwd=REPO, timeout=120):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = dict(os.environ, PYTHONPATH=REPO)
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


def test_no_source_file_imports_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(pathway_tpu(\.|\s|$)|jax\b|flax\b)", re.M
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
