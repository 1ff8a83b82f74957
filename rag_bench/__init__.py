"""The benchmark of ``pathway_tpu_torch`` on one NVIDIA H100.

``python3 -m rag_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Each
configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``), traffic mode (``modes/<mode>.py``) and
per-layer metric (``metrics/<name>.py``) is a file of its own, found by
its name. The plain reference (``reference/``) imports nothing of the
program. Nothing here imports ``jax`` or the JAX package.
"""
