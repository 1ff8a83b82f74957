"""BENCHMARK.json against the benchmark's contract, and each cell's files
found by name."""

import json
import os
import re

import pytest

from rag_bench import run

ROOT = run.ROOT
M = run.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert not any(w.startswith("/") or ".." in w for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in M[section]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_sections():
    names = [e["name"] for e in M["end_to_end"] + M["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        widths = ("hidden_size", "intermediate_size", "num_attention_heads")
        assert not any(k in widths or k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert set(c["reduced"]) <= set(body)


def test_workloads():
    configs = {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(section):
    for e in M[section]:
        keys = METRIC_KEYS | {"workloads"}
        if section == "per_layer":
            keys = (keys - {"bound"}) | {"layer", "moves"}
        assert set(e) <= keys and set(e) >= keys - {"workloads"}
        if section == "per_layer":
            assert e["workloads"], "a per-layer metric names its cells"
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        else:
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert _line(e["layer"])
            assert e["moves"] in {x["name"] for x in M["end_to_end"]}
        cells = {w["name"] for w in M["workloads"]}
        assert set(e.get("workloads", [])) <= cells
        if e["name"].endswith("_roofline") or "mfu" in e["name"]:
            assert e["unit"] == "%"
    assert any(e["name"] == "setup_s" and e["bound"] <= 0.25 for e in M["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    files = run.cell_files(M, cell)
    for key in ("config", "traffic", "mode"):
        assert os.path.isfile(files[key]), files[key]
    e2e = {e["name"] for e in run.end_to_end(M, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = run.per_layer(M, cell)
    assert layers
    for p in layers:
        assert os.path.isfile(os.path.join(run.HERE, "metrics", f"{p['name']}.py"))
        # each per-layer metric listing this cell moves an end-to-end metric it reports
        assert p["moves"] in e2e
