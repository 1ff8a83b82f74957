"""The control at the configurations' own widths, on a small corpus the
CPU holds: the program as it is reads within each cell's limits, and the
plain reference one precision step below (float8 products in the
encoder, TF32 search operands; or the float32 encoder with TF32 search:
``rag_bench/control.py``) reads past at least one of them. The cell-size control runs on the card
(``python3 -m rag_bench.control``)."""

import json
import time

import torch

from rag_bench import control, run
from rag_bench.tests import tiny


def _small(workload):
    m, args, cfg, tr = tiny.cell(workload, seconds=0.6)
    with open(run.cell_files(m, workload)["config"]) as f:
        widths = json.load(f)
    for key in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                "intermediate_size"):
        cfg[key] = widths[key]
    return m, args, cfg, tr


def _over(readings, limits):
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


def test_serve_control_fails_where_the_program_passes(capsys):
    m, args, cfg, tr = _small("msmarco-serve")
    assert run.execute(m, args, cfg, tr, torch.device("cpu"), "cpu", time.perf_counter()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    mode = run.load_by_path(run.cell_files(m, args.workload)["mode"], "t_ctl_serve")
    got = control.serve_readings(cfg, tr, args.seed, args.seconds, torch.device("cpu"), mode)
    assert set(got) == {"fp8_tf32", "tf32_search"}
    for readings in got.values():
        assert _over(readings, tr["check"]["limits"]), got
    # the search one step below fails the search check, and that alone
    assert _over(got["tf32_search"], tr["check"]["limits"]) == ["search_gap"], got


def test_ingest_control_fails_where_the_program_passes(capsys):
    m, args, cfg, tr = _small("nq-ingest")
    tr["batch"] = 8
    assert run.execute(m, args, cfg, tr, torch.device("cpu"), "cpu", time.perf_counter()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    mode = run.load_by_path(run.cell_files(m, args.workload)["mode"], "t_ctl_ingest")
    got = control.ingest_readings(cfg, tr, args.seed, 2, torch.device("cpu"), mode)
    assert _over(got, tr["check"]["limits"]), got
