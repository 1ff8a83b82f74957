"""pathway_tpu_torch.parallel — the process mesh's control plane.

The reference scales by running N identical timely workers per process and
a TCP mesh between processes (src/engine/dataflow/config.rs:63-127, SURVEY
§2.9). The modules here are that plane: the pure wave/rollback transition
table (``protocol``), the multi-process group and its exchange
(``procgroup``), the rank supervisor (``supervisor``) and the autoscaler
(``autoscale``). Each is imported by name; this package imports none of
them eagerly. Device meshes, the sharded index, ring attention and
training come with later slices of the port.
"""

__all__ = ["autoscale", "procgroup", "protocol", "supervisor"]
