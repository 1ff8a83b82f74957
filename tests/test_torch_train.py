"""``pathway_tpu_torch/parallel/train.py`` against the JAX package's
InfoNCE step: the Megatron sharding rules re-keyed to the port's
state-dict names, the loss and every gradient of one f32 step (JAX's
parameters and gradients carried across by ``flax_params_to_torch``),
AdamW against ``optax.adamw``, dp on a single-process mesh against
dp = 1, and the refusal of a mesh over distinct cards."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh as JaxMesh

from pathway_tpu.models.encoder import (
    EncoderConfig as JaxEncoderConfig,
    TransformerEncoder as JaxTransformerEncoder,
)
from pathway_tpu.parallel.train import (
    contrastive_loss as jax_contrastive_loss,
    make_param_shardings as jax_make_param_shardings,
)
from chip_smoke import grad_mismatches
from pathway_tpu_torch.models import EncoderConfig, TransformerEncoder, flax_params_to_torch
from pathway_tpu_torch.parallel import (
    TrainState,
    contrastive_train_step,
    create_train_state,
    make_mesh,
    make_sharded_train_step,
)
from pathway_tpu_torch.parallel.train import adamw, make_param_shardings

F32_TINY = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)
JAX_F32_TINY = dataclasses.replace(JaxEncoderConfig.tiny(), dtype=jnp.float32)


def _cpu_mesh(dp=1, tp=1):
    return make_mesh(devices=["cpu"] * (dp * tp), axes=("dp", "tp"), shape=(dp, tp))


def _batch(seed, n=8, lq=16, ld=16, vocab=512):
    rng = np.random.default_rng(seed)

    def ids_mask(L):
        lens = rng.integers(4, L + 1, size=n)
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
        return rng.integers(3, vocab, size=(n, L)).astype(np.int32) * mask, mask

    q_ids, q_mask = ids_mask(lq)
    d_ids, d_mask = ids_mask(ld)
    return {"q_ids": q_ids, "q_mask": q_mask, "d_ids": d_ids, "d_mask": d_mask}


def _jax_params(cfg, seed=0):
    model = JaxTransformerEncoder(cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32))["params"]
    return model, params


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_state(cfg, params, mesh=None):
    state, model, tx = create_train_state(cfg, mesh or _cpu_mesh())
    model.load_state_dict(flax_params_to_torch(_to_numpy(params), cfg))
    return state, model, tx


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


# -- the sharding rules ---------------------------------------------------------

# the Flax kernel's input and output dimensions; an nn.Linear weight is
# [out, in]
_KERNEL_DIMS = {"query": ((0,), (1, 2)), "key": ((0,), (1, 2)),
                "value": ((0,), (1, 2)), "out": ((0, 1), (2,))}


def _port_name(path):
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias"}[path[-1]]
    mods = [f"blocks.{p[len('block_'):]}" if p.startswith("block_") else p
            for p in path[:-1]]
    return ".".join(mods + [leaf])


def _normalise(spec):
    spec = tuple(spec)
    return () if all(a is None for a in spec) else spec


def _translate(path, shape, spec):
    """JAX's spec of a Flax leaf -> the spec of the port's parameter."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if path[-1] != "kernel":
        return _normalise(spec)
    ins, outs = _KERNEL_DIMS.get(path[-2], ((0,), (1,)))

    def axis(dims):
        return next((spec[d] for d in dims if spec[d] is not None), None)

    return _normalise((axis(outs), axis(ins)))


@pytest.mark.parametrize("which", ["tiny", "bge_small"])
def test_sharding_rules_match_jax_with_the_transposition(which):
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs 8 virtual devices (conftest sets XLA_FLAGS)")
    jcfg = getattr(JaxEncoderConfig, which)()
    shapes = jax.eval_shape(
        JaxTransformerEncoder(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    jmesh = JaxMesh(np.array(jax.devices("cpu")[:8]).reshape(4, 2), ("dp", "tp"))
    jspecs = jax_make_param_shardings(jmesh, shapes)
    with torch.device("meta"):
        model = TransformerEncoder(getattr(EncoderConfig, which)())
    got = make_param_shardings(_cpu_mesh(4, 2), model)
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(jspecs)[0]:
        keys = tuple(str(p.key) for p in path)
        leaf = shapes
        for k in keys:
            leaf = leaf[k]
        want[_port_name(keys)] = _translate(keys, leaf.shape, sharding.spec)
    assert got == want
    sharded = [n for n, s in got.items() if s]
    assert len(sharded) == 6 * jcfg.layers  # q, k, v, out, mlp_in, mlp_out
    params = dict(model.named_parameters())
    for name in sharded:
        dim = got[name].index("tp")
        assert params[name].shape[dim] % 2 == 0


def test_shardings_refuse_what_the_mesh_cannot_hold():
    model = TransformerEncoder(F32_TINY)
    with pytest.raises(ValueError, match="does not divide"):
        make_param_shardings(_cpu_mesh(1, 3), model)  # hidden 64 over tp = 3
    with pytest.raises(ValueError, match="names axis 'tp'"):
        make_param_shardings(make_mesh(devices=["cpu"], axes=("dp",)), model)


# -- the step against JAX's -----------------------------------------------------


def test_f32_step_matches_jax_loss_and_gradients():
    model, params = _jax_params(JAX_F32_TINY)
    batch = _batch(0)

    def loss_fn(p):
        q = model.apply({"params": p}, batch["q_ids"], batch["q_mask"])
        d = model.apply({"params": p}, batch["d_ids"], batch["d_mask"])
        return jax_contrastive_loss(q, d)

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    state, tmodel, tx = _port_state(F32_TINY, params)
    step = make_sharded_train_step(tmodel, tx, _cpu_mesh())
    state, loss = step(state, batch)
    assert state.step == 1
    assert loss.dim() == 0 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jax_grads = flax_params_to_torch(_to_numpy(jgrads), F32_TINY)
    assert grad_mismatches(_grads(tmodel), jax_grads, 1e-4) == []


def test_bf16_loss_matches_jax():
    jcfg, tcfg = JaxEncoderConfig.tiny(), EncoderConfig.tiny()
    model, params = _jax_params(jcfg, seed=1)
    batch = _batch(1)
    jloss = jax_contrastive_loss(
        model.apply({"params": params}, batch["q_ids"], batch["q_mask"]),
        model.apply({"params": params}, batch["d_ids"], batch["d_mask"]))
    state, tmodel, tx = _port_state(tcfg, params)
    _, loss = contrastive_train_step(tmodel, tx, state, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-2


def test_sharded_train_step_runs_and_reduces_loss():
    """The reference test's six steps on a (dp = 4, tp = 2) mesh."""
    mesh = make_mesh(devices=["cpu"] * 8)
    cfg = EncoderConfig.tiny()
    state, model, tx = create_train_state(cfg, mesh, learning_rate=1e-2)
    assert isinstance(state, TrainState) and state.params is model and state.opt_state is tx
    step = make_sharded_train_step(model, tx, mesh)
    rng = np.random.default_rng(0)
    batch = {
        "q_ids": rng.integers(3, cfg.vocab_size, size=(8, 16)).astype(np.int32),
        "q_mask": np.ones((8, 16), np.int32),
        "d_ids": rng.integers(3, cfg.vocab_size, size=(8, 16)).astype(np.int32),
        "d_mask": np.ones((8, 16), np.int32),
    }
    losses = []
    for _ in range(6):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert state.step == 6
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_optax(steps):
    rng = np.random.default_rng(steps)
    init = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(steps)]
    lr = 1e-2
    otx = optax.adamw(lr)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    ost = otx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    ttx = adamw(tp.values(), lr)
    for g in grads:
        updates, ost = otx.update({k: jnp.asarray(v) for k, v in g.items()}, ost, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        ttx.step()
    for k in init:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_dp_on_one_process_equals_dp_one():
    """Four chunks encoded apart, one InfoNCE over the whole batch: the
    negatives span the global batch, as XLA computes it for JAX."""
    batch = _batch(2)
    out = {}
    for dp in (1, 4):
        mesh = make_mesh(devices=["cpu"] * dp, axes=("dp", "tp"), shape=(dp, 1))
        state, model, tx = create_train_state(F32_TINY, mesh, seed=3)
        state, loss = make_sharded_train_step(model, tx, mesh)(state, batch)
        out[dp] = (float(loss), _grads(model))
    # gradients, not updated parameters: Adam's first update is about
    # lr * g / |g|, which turns rounding in a near-zero gradient into lr
    np.testing.assert_allclose(out[4][0], out[1][0], rtol=1e-6)
    assert grad_mismatches(out[4][1], out[1][1], 1e-6) == []


def test_batch_that_does_not_split_over_dp_raises():
    mesh = _cpu_mesh(dp=4)
    state, model, tx = create_train_state(F32_TINY, mesh)
    with pytest.raises(ValueError, match="does not split over dp=4"):
        make_sharded_train_step(model, tx, mesh)(state, _batch(3, n=6))


def test_mesh_of_distinct_cards_raises_before_any_cuda_call(monkeypatch):
    def no_cuda(*a, **kw):
        raise AssertionError("a CUDA call")

    _, model, tx = create_train_state(F32_TINY, _cpu_mesh())
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_device", no_cuda)
    mesh = make_mesh(devices=["cuda:0", "cuda:1"], axes=("dp", "tp"), shape=(2, 1))
    with pytest.raises(NotImplementedError, match="spawn -n N"):
        make_sharded_train_step(model, tx, mesh)
    with pytest.raises(NotImplementedError, match="spawn -n N"):
        create_train_state(F32_TINY, mesh)
    tp_mesh = make_mesh(devices=["cuda:0", "cuda:1"], axes=("dp", "tp"), shape=(1, 2))
    with pytest.raises(NotImplementedError, match="spawn -n N"):
        make_sharded_train_step(model, tx, tp_mesh)


def test_create_train_state_refuses_to_drop_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card is valid")
    mesh = make_mesh(devices=["cuda:0"], axes=("dp", "tp"), shape=(1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(F32_TINY, mesh)
    with pytest.raises(ValueError, match="the mesh lies on cpu"):
        create_train_state(F32_TINY, _cpu_mesh(), device="meta")
