"""Tensor parallelism across ranks, against the JAX package: one
``python -m pathway_tpu_torch spawn -n 8`` of gloo CPU ranks on the mesh
``global_mesh()`` lays out, (dp = 4, tp = 2) with rank r at
(r // 2, r % 2), runs two f32 steps of the InfoNCE train step from the
JAX package's seeded parameters; each dp row of ranks passes its 2 rows
of the batch. The reference is the JAX package's own
``make_sharded_train_step`` on the 8-device CPU mesh (4, 2) over the
whole batch, and ``jax.value_and_grad`` for the step-1 gradients."""

import dataclasses
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from chip_smoke import grad_mismatches
from pathway_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from pathway_tpu.parallel.train import (
    contrastive_loss as jax_contrastive_loss,
    create_train_state as jax_create_train_state,
    make_sharded_train_step as jax_make_sharded_train_step,
)
from pathway_tpu_torch.models import EncoderConfig, flax_params_to_torch
from pathway_tpu_torch.parallel.train import param_sharding_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, DP, TP = 8, 4, 2
SPAWN_TIMEOUT_S = 110
SEED = 5
F32_TINY = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)
JAX_F32_TINY = dataclasses.replace(JaxEncoderConfig.tiny(), dtype=jnp.float32)

RANK_PROGRAM = """
import dataclasses
import numpy as np
import torch
from pathway_tpu_torch.models import EncoderConfig
from pathway_tpu_torch.parallel import (
    create_train_state, global_mesh, initialize_from_env, make_sharded_train_step)
from pathway_tpu_torch.parallel.train import gather_state_dict, shard_state_dict

assert initialize_from_env(device="cpu")
rank = torch.distributed.get_rank()
mesh = global_mesh(device="cpu")
at = mesh.coords()
batch = np.load("batch.npz")
n = batch["q_ids"].shape[0] // mesh.global_shape["dp"]
local = {k: batch[k][at["dp"] * n:(at["dp"] + 1) * n] for k in batch.files}
cfg = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)
state, model, tx = create_train_state(cfg, mesh)
tp = model.tp
model.load_state_dict(shard_state_dict(torch.load("params.pt"), tp.size, tp.rank))
step = make_sharded_train_step(model, tx, mesh)
losses, reduces = [], []
for i in range(2):
    before = tp.all_reduces
    state, loss = step(state, local)
    reduces.append(tp.all_reduces - before)
    losses.append(float(loss))
    if i == 0:
        grads = gather_state_dict(
            {name: p.grad for name, p in model.named_parameters()}, tp)
torch.save({
    "world": torch.distributed.get_world_size(), "coords": at,
    "global_shape": mesh.global_shape, "tp_ranks": mesh.axis_ranks("tp"),
    "dp_ranks": mesh.axis_ranks("dp"), "step": state.step, "losses": losses,
    "all_reduces": reduces, "grads": grads,
    "params": {name: p.detach().clone() for name, p in model.named_parameters()},
    "adam": {name: {k: tuple(v.shape) for k, v in tx.state[p].items() if torch.is_tensor(v) and v.dim()}
             for name, p in model.named_parameters()},
}, f"rank{rank}.pt")
torch.distributed.destroy_process_group()
"""


def _batch(rng, n=8, L=16):
    lens = rng.integers(4, L + 1, size=(2, n))
    masks = [(np.arange(L)[None, :] < ln[:, None]).astype(np.int32) for ln in lens]
    ids = [rng.integers(3, 512, size=(n, L)).astype(np.int32) * m for m in masks]
    return {"q_ids": ids[0], "q_mask": masks[0], "d_ids": ids[1], "d_mask": masks[1]}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_reference(batch):
    """The JAX package's (dp = 4, tp = 2) step, twice, from its seeded
    parameters: those parameters, the step-1 gradients and both losses."""
    mesh = JaxMesh(np.array(jax.devices("cpu")[:RANKS]).reshape(DP, TP), ("dp", "tp"))
    state, model, tx = jax_create_train_state(JAX_F32_TINY, mesh, seed=SEED)
    params = _numpy(state.params)

    def loss_fn(p):
        q = model.apply({"params": p}, batch["q_ids"], batch["q_mask"])
        d = model.apply({"params": p}, batch["d_ids"], batch["d_mask"])
        return jax_contrastive_loss(q, d)

    _, grads = jax.value_and_grad(loss_fn)(state.params)
    step = jax_make_sharded_train_step(model, tx, mesh)
    losses = []
    for _ in range(2):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return (flax_params_to_torch(params, F32_TINY),
            flax_params_to_torch(_numpy(grads), F32_TINY), losses)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of eight ranks; each test reads what they saved."""
    from tests.test_torch_multiprocess import _free_port_base

    if len(jax.devices("cpu")) < RANKS:
        pytest.skip("needs 8 virtual devices (conftest sets XLA_FLAGS)")
    work = tmp_path_factory.mktemp("tp")
    batch = _batch(np.random.default_rng(SEED))
    np.savez(work / "batch.npz", **batch)
    params, grads, losses = _jax_reference(batch)
    torch.save(params, work / "params.pt")
    (work / "prog.py").write_text(RANK_PROGRAM)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("PATHWAY_COORDINATOR", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch", "spawn", "-n", str(RANKS),
         "--first-port", str(_free_port_base(RANKS + 1)), "prog.py"],
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
    saved = [torch.load(work / f"rank{r}.pt") for r in range(RANKS)]
    return params, grads, losses, saved


def _tp_dim(name):
    spec = param_sharding_rules(name, ())
    return spec.index("tp") if "tp" in spec else None


def test_ranks_lie_on_the_reference_layout(ranks):
    *_, saved = ranks
    for r, s in enumerate(saved):
        assert s["world"] == RANKS and s["global_shape"] == {"dp": DP, "tp": TP}
        assert s["coords"] == {"dp": r // TP, "tp": r % TP}
        row, col = r // TP, r % TP
        assert s["tp_ranks"] == list(range(row * TP, row * TP + TP))
        assert s["dp_ranks"] == list(range(col, RANKS, TP))


@pytest.mark.parametrize("step", [0, 1])
def test_loss_matches_the_jax_sharded_step(ranks, step):
    _, _, losses, saved = ranks
    for s in saved:
        assert s["step"] == 2
        np.testing.assert_allclose(s["losses"][step], losses[step], rtol=1e-5)


def test_step_one_gradients_gathered_over_tp_match_jax(ranks):
    _, grads, _, saved = ranks
    for s in saved:
        assert grad_mismatches(s["grads"], grads, 1e-4) == []


def test_each_rank_holds_only_its_shards_and_their_adam_state(ranks):
    params, _, _, saved = ranks
    h, mlp = F32_TINY.hidden, F32_TINY.mlp
    want = {"attention.query": (h // TP, h), "attention.key": (h // TP, h),
            "attention.value": (h // TP, h), "attention.out": (h, h // TP),
            "mlp_in": (mlp // TP, h), "mlp_out": (h, mlp // TP)}
    for s in saved:
        assert s["params"].keys() == params.keys()
        for name, p in s["params"].items():
            layer = name.split(".", 2)[-1].rsplit(".", 1)[0]
            if name.endswith(".weight") and layer in want:
                assert tuple(p.shape) == want[layer], name
            else:
                assert p.shape == params[name].shape, name
            assert s["adam"][name] == {"exp_avg": tuple(p.shape), "exp_avg_sq": tuple(p.shape)}, name


def test_replicated_parameters_bit_equal_everywhere_and_shards_over_dp(ranks):
    *_, saved = ranks
    for name in saved[0]["params"]:
        if _tp_dim(name) is None:
            for s in saved[1:]:
                assert torch.equal(s["params"][name], saved[0]["params"][name]), name
            continue
        for col in range(TP):
            column = [saved[r]["params"][name] for r in range(col, RANKS, TP)]
            assert all(torch.equal(p, column[0]) for p in column[1:]), name
        assert not torch.equal(saved[0]["params"][name], saved[1]["params"][name]), name


def test_megatron_all_reduces_per_step(ranks):
    """Per block, g after the two row-parallel layers forward and f before
    the two column-parallel ones backward, for the queries and the
    documents; and one sum of the sliced bias gradients."""
    *_, saved = ranks
    want = 2 * F32_TINY.layers * 4 + 1
    for s in saved:
        assert s["all_reduces"] == [want, want]
