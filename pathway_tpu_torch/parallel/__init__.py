"""pathway_tpu_torch.parallel — device meshes, the sharded index and the
process mesh's control plane.

The reference scales by running N identical timely workers per process and
a TCP mesh between processes (src/engine/dataflow/config.rs:63-127, SURVEY
§2.9). The modules here are that plane: the pure wave/rollback transition
table (``protocol``), the multi-process group and its exchange
(``procgroup``), the rank supervisor (``supervisor``) and the autoscaler
(``autoscale``); and the device side: a mesh of devices (``mesh``) and a
KNN index with one shard per mesh device whose partial top-k results
merge into the global top-k (``sharded_knn``), in place of the
reference's broadcast-replicated index (external_index.rs:95 — a full
copy per worker); and the ``torch.distributed`` process group of the
ranks that ``python -m pathway_tpu_torch spawn`` starts
(``distributed``); exact attention over a sequence split around a ring
of devices or ranks (``ring_attention``), and the encoder's InfoNCE
fine-tuning step over a dp/tp mesh (``train``), whose tp axis across
ranks shards the encoder's weights Megatron-style. The exported names load
on first use, so importing one submodule imports none of the others.
"""

import importlib

_EXPORTS = {
    "initialize_from_env": "distributed",
    "global_mesh": "distributed",
    "best_factorization": "mesh",
    "make_mesh": "mesh",
    "Mesh": "mesh",
    "ShardedKnnIndex": "sharded_knn",
    "sharded_topk": "sharded_knn",
    "TrainState": "train",
    "create_train_state": "train",
    "contrastive_train_step": "train",
    "make_sharded_train_step": "train",
    "TensorParallel": "distributed",
    "shard_state_dict": "train",
    "gather_state_dict": "train",
}

__all__ = [
    "autoscale", "procgroup", "protocol", "supervisor", "mesh", "sharded_knn",
    "distributed", "ring_attention", "train",
    *_EXPORTS,
]


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
