"""Tensor parallelism in one process: the tp shards of a state dict and
their inverse, the encoder's tp attachment at one rank against the plain
encoder, the layout of a rank's mesh and the subgroups every rank makes,
and the refusals that come before any process group is touched. The
eight-rank step against the JAX package is
``tests/test_torch_tp_multiprocess.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import EncoderConfig, TransformerEncoder
from pathway_tpu_torch.models.convert import init_params
from pathway_tpu_torch.models.encoder import _Shard
from pathway_tpu_torch.parallel import Mesh, distributed, make_mesh
from pathway_tpu_torch.parallel.train import (
    TensorParallel,
    _merge_shards,
    create_train_state,
    make_param_shardings,
    shard_state_dict,
)

F32_TINY = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)


def _rank_mesh(shape, rank, axes=("dp", "tp")):
    """A rank's mesh as ``global_mesh`` makes it, its groups stand-ins."""
    local = make_mesh(devices=["cpu"], axes=axes, shape=(1,) * len(axes))
    return Mesh(local.devices, axes, ranks=np.arange(np.prod(shape)).reshape(shape),
                rank=rank, groups={a: f"group-{a}" for a in axes})


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("which", ["tiny", "bge_small"])
def test_shard_then_merge_is_bit_exact(which, size):
    cfg = getattr(EncoderConfig, which)()
    full = init_params(cfg, seed=7)
    shards = [shard_state_dict(full, size, r) for r in range(size)]
    back = _merge_shards(shards)
    assert back.keys() == full.keys()
    for name, t in full.items():
        assert torch.equal(back[name], t), name
    h, mlp = cfg.hidden, cfg.mlp
    s = shards[size - 1]
    blk = "blocks.0."
    assert s[blk + "attention.query.weight"].shape == (h // size, h)
    assert s[blk + "attention.out.weight"].shape == (h, h // size)
    assert s[blk + "mlp_in.weight"].shape == (mlp // size, h)
    assert s[blk + "mlp_out.weight"].shape == (h, mlp // size)
    assert s[blk + "attention.query.bias"].shape == (h,)  # replicated
    # the query's rows are its heads: the last rank holds the last heads
    hd = h // cfg.heads
    heads = full[blk + "attention.query.weight"].view(cfg.heads, hd, h)
    assert torch.equal(s[blk + "attention.query.weight"].view(-1, hd, h),
                       heads[cfg.heads - cfg.heads // size:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_tp_attachment_of_one_rank_is_the_plain_encoder(dtype):
    cfg = dataclasses.replace(EncoderConfig.tiny(), dtype=dtype)
    params = init_params(cfg, seed=2)
    plain = TransformerEncoder(cfg)
    plain.load_state_dict(params)
    one = TransformerEncoder(cfg, TensorParallel(1, 0))
    one.load_state_dict(shard_state_dict(params, 1, 0))
    rng = np.random.default_rng(2)
    lens = rng.integers(3, 17, size=4)
    mask = torch.from_numpy((np.arange(16)[None, :] < lens[:, None]).astype(np.int32))
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(4, 16))) * mask
    with torch.no_grad():
        assert torch.equal(one(ids, mask), plain(ids, mask))


def test_an_unloaded_layer_of_one_rank_is_initialised_as_nn_linear():
    torch.manual_seed(5)
    shard = _Shard(24, 16, 24)
    torch.manual_seed(5)
    linear = torch.nn.Linear(16, 24)
    assert torch.equal(shard.weight, linear.weight)
    assert torch.equal(shard.bias, linear.bias)


def test_tp_specs_of_a_sharded_model_are_the_whole_models():
    with torch.device("meta"):
        whole = TransformerEncoder(EncoderConfig.bge_small())
        sharded = TransformerEncoder(EncoderConfig.bge_small(), TensorParallel(3, 1))
    mesh = _rank_mesh((1, 3), 1)
    assert make_param_shardings(mesh, sharded) == make_param_shardings(
        make_mesh(devices=["cpu"] * 3, shape=(1, 3)), whole)


def test_a_rank_mesh_lays_ranks_out_last_axis_fastest():
    for r in range(8):
        mesh = _rank_mesh((4, 2), r)
        assert mesh.shape == {"dp": 1, "tp": 1}
        assert mesh.global_shape == {"dp": 4, "tp": 2}
        assert mesh.coords() == {"dp": r // 2, "tp": r % 2}
        assert mesh.axis_ranks("tp") == [r // 2 * 2, r // 2 * 2 + 1]
        assert mesh.axis_ranks("dp") == [r % 2, r % 2 + 2, r % 2 + 4, r % 2 + 6]
        assert mesh.group("tp") == "group-tp"
    with pytest.raises(ValueError, match="not a mesh of a process group"):
        make_mesh(devices=["cpu"] * 2).group("tp")


def test_every_rank_makes_every_subgroup_in_one_order(monkeypatch):
    """``new_group`` is collective: each rank must make the same groups in
    the same order, its own among them."""
    import torch.distributed as dist

    made = {}
    for rank in range(8):
        calls = []
        monkeypatch.setattr(dist, "new_group", lambda m, calls=calls: calls.append(m) or tuple(m))
        ranks = np.arange(8).reshape(4, 2)
        mine = distributed._axis_groups(ranks, ("dp", "tp"), rank)
        made[rank] = calls
        assert mine == {"dp": tuple(range(rank % 2, 8, 2)),
                        "tp": (rank // 2 * 2, rank // 2 * 2 + 1)}
    assert all(calls == made[0] for calls in made.values())
    assert made[0] == [[0, 2, 4, 6], [1, 3, 5, 7], [0, 1], [2, 3], [4, 5], [6, 7]]


def test_tp_over_heads_it_does_not_divide_raises_before_any_group(monkeypatch):
    import torch.distributed as dist

    def no_group(*a, **kw):
        raise AssertionError("a process-group call")

    for name in ("all_reduce", "all_gather", "new_group", "get_rank", "get_world_size"):
        monkeypatch.setattr(dist, name, no_group)
    with pytest.raises(ValueError, match="tp=3 does not divide the 4 heads"):
        create_train_state(F32_TINY, _rank_mesh((1, 3), 0))
    with pytest.raises(ValueError, match="tp=3 does not divide the 4 heads"):
        TransformerEncoder(F32_TINY, TensorParallel(3, 0))
