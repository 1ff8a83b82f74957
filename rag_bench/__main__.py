"""``python3 -m rag_bench``: see ``rag_bench/run.py``."""

import time

_T0 = time.perf_counter()

import sys  # noqa: E402

from rag_bench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=_T0))
