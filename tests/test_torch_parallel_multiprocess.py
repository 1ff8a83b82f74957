"""The process-group paths of ``parallel/train.py`` and
``parallel/ring_attention.py`` on two gloo CPU ranks, started in one
``python -m pathway_tpu_torch spawn -n 2``: a dp step across the ranks
(each rank its own rows, the document embeddings all-gathered, the
gradients summed) equals the single-process step on the whole batch, and
the ring over the ranks (``batch_isend_irecv``) equals full attention
over the whole sequence."""

import dataclasses
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import grad_mismatches
from pathway_tpu_torch.models import EncoderConfig
from pathway_tpu_torch.parallel import create_train_state, make_mesh, make_sharded_train_step
from pathway_tpu_torch.parallel.ring_attention import reference_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 180
SEED = 3
F32_TINY = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)

RANK_PROGRAM = """
import dataclasses
import numpy as np
import torch
from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.models import EncoderConfig
from pathway_tpu_torch.parallel import (
    create_train_state, global_mesh, initialize_from_env, make_sharded_train_step)
from pathway_tpu_torch.parallel.ring_attention import ring_attention

rank = get_pathway_config().process_id
assert initialize_from_env(device="cpu")
world = torch.distributed.get_world_size()

batch = np.load("batch.npz")
n = batch["q_ids"].shape[0] // world
local = {k: batch[k][rank * n:(rank + 1) * n] for k in batch.files}
mesh = global_mesh(device="cpu")
cfg = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)
state, model, tx = create_train_state(cfg, mesh, seed=SEED)
state, loss = make_sharded_train_step(model, tx, mesh)(state, local)

qkv = np.load("qkv.npz")
s = qkv["q"].shape[2] // world
blocks = [torch.from_numpy(qkv[x][:, :, rank * s:(rank + 1) * s]) for x in "qkv"]
ring = global_mesh(axes=("sp",), device="cpu")
torch.save({
    "world": world, "step": state.step, "loss": loss,
    "grads": {name: p.grad for name, p in model.named_parameters()},
    "full": ring_attention(*blocks, ring),
    "causal": ring_attention(*blocks, ring, causal=True),
}, f"rank{rank}.pt")
""".replace("SEED", str(SEED))


def _batch(rng, n=8, L=16):
    lens = rng.integers(4, L + 1, size=(2, n))
    masks = [(np.arange(L)[None, :] < ln[:, None]).astype(np.int32) for ln in lens]
    ids = [rng.integers(3, 512, size=(n, L)).astype(np.int32) * m for m in masks]
    return {"q_ids": ids[0], "q_mask": masks[0], "d_ids": ids[1], "d_mask": masks[1]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of two ranks; each test reads what they saved."""
    from tests.test_torch_multiprocess import _free_port_base

    work = tmp_path_factory.mktemp("pg")
    rng = np.random.default_rng(SEED)
    batch = _batch(rng)
    np.savez(work / "batch.npz", **batch)
    qkv = {x: rng.standard_normal((2, 3, 32, 8)).astype(np.float32) for x in "qkv"}
    np.savez(work / "qkv.npz", **qkv)
    (work / "prog.py").write_text(RANK_PROGRAM)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("PATHWAY_COORDINATOR", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch", "spawn", "-n", "2",
         "--first-port", str(_free_port_base()), "prog.py"],
        env=env, cwd=str(work), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err.decode()[-4000:]
    saved = [torch.load(work / f"rank{r}.pt") for r in range(2)]
    assert [s["world"] for s in saved] == [2, 2]
    return batch, qkv, saved


def test_dp_step_across_ranks_equals_the_whole_batch_step(ranks):
    batch, _, saved = ranks
    mesh = make_mesh(devices=["cpu"], axes=("dp", "tp"), shape=(1, 1))
    state, model, tx = create_train_state(F32_TINY, mesh, seed=SEED)
    state, loss = make_sharded_train_step(model, tx, mesh)(state, batch)
    want = {name: p.grad for name, p in model.named_parameters()}
    for rank in saved:
        assert rank["step"] == 1
        np.testing.assert_allclose(float(rank["loss"]), float(loss), rtol=1e-5)
        assert grad_mismatches(rank["grads"], want, 1e-5) == []


def test_ring_over_ranks_equals_full_attention(ranks):
    _, qkv, saved = ranks
    q, k, v = (torch.from_numpy(qkv[x]) for x in "qkv")
    for key, causal in (("full", False), ("causal", True)):
        got = torch.cat([rank[key] for rank in saved], dim=2)
        want = reference_attention(q, k, v, causal=causal)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
