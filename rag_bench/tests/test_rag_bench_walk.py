"""Each cell's whole path at a tiny geometry on the CPU, through
``run.execute`` (everything after the look for a card): the checks pass
on the program as it is and fail with the timed path broken underneath,
once for each fault the cell can have."""

import pytest
import torch

from rag_bench.tests import tiny


@pytest.mark.parametrize("cell", ["msmarco-serve", "nq-ingest"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_walks_and_is_correct(cell, trace, capsys):
    rc, line = tiny.execute(cell, capsys, trace=trace)
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert line["metrics"] and {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert "setup_s" in line["metrics"]


def _alter_answers(monkeypatch):
    from pathway_tpu_torch.ops.query_engine import QueryEngine

    finish = QueryEngine.finish

    def altered(self, ticket):
        out = finish(self, ticket)
        # each answer's best key swapped for another key, its score kept
        return [[((k + 1) % 3000, s)] + rest if i % 2 == 0 else [(k, s)] + rest
                for i, ((k, s), *rest) in enumerate(out)]

    monkeypatch.setattr(QueryEngine, "finish", altered)


def _half_of_each_batch(monkeypatch):
    from pathway_tpu_torch.ops.query_engine import QueryEngine

    dispatch = QueryEngine.dispatch

    def half(self, texts):
        return dispatch(self, texts[: max(1, len(texts) // 2)])

    monkeypatch.setattr(QueryEngine, "dispatch", half)


def _other_query(monkeypatch):
    from pathway_tpu_torch.ops.query_engine import QueryEngine

    dispatch = QueryEngine.dispatch

    def rotated(self, texts):
        # every answer is produced for its neighbour's query
        return dispatch(self, texts[1:] + texts[:1])

    monkeypatch.setattr(QueryEngine, "dispatch", rotated)


@pytest.mark.parametrize("fault", [_alter_answers, _half_of_each_batch, _other_query],
                         ids=["answer_altered", "half_the_batch", "answer_misrouted"])
def test_serve_faults_come_out_not_correct(fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, line = tiny.execute("msmarco-serve", capsys, seconds=1.0)
    assert rc == 0 and line["correct"] is False


def test_serve_search_on_the_ports_one_pass_tf32_path_is_not_correct(capsys):
    import json
    import time

    from rag_bench import run

    m, args, cfg, tr = tiny.cell("msmarco-serve", seconds=1.0)
    cfg["deployment"]["precision"] = "default"
    rc = run.execute(m, args, cfg, tr, torch.device("cpu"), "cpu", time.perf_counter())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False
    bad = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert bad == ["search_gap"], line["checks"]


def _write(monkeypatch, change):
    import pathway_tpu_torch.ops.ingest as ingest

    chain = ingest.fused_chain

    def broken(forward, wire, compact, n, write):
        return chain(forward, wire, compact, n, lambda emb: change(emb, write))

    monkeypatch.setattr(ingest, "fused_chain", broken)


@pytest.mark.parametrize("change", [
    lambda emb, write: None,  # the write returns the index unchanged
    lambda emb, write: write(torch.cat([emb[: len(emb) // 2],
                                        torch.zeros_like(emb[len(emb) // 2:])])),
    lambda emb, write: write(torch.roll(emb, 1, dims=0)),  # rows under the wrong keys
    lambda emb, write: write(emb + 0.05 * torch.sign(emb)),  # a row altered
], ids=["state_unchanged", "half_the_batch", "rows_misplaced", "row_altered"])
def test_ingest_faults_come_out_not_correct(change, monkeypatch, capsys):
    _write(monkeypatch, change)
    rc, line = tiny.execute("nq-ingest", capsys, seconds=1.0)
    assert rc == 0 and line["correct"] is False


def test_ingest_write_into_another_key_is_a_map_fault(monkeypatch, capsys):
    from pathway_tpu_torch.ops.knn import KnnShard

    assign = KnnShard._assign_slots

    def wrong(self, keys):
        slots = assign(self, keys)
        if len(slots) and min(keys) >= 3000:  # window batches only
            slots = slots.copy()
            slots[0] = self.key_to_slot[0]  # overwrites corpus key 0's row
        return slots

    monkeypatch.setattr(KnnShard, "_assign_slots", wrong)
    rc, line = tiny.execute("nq-ingest", capsys, seconds=1.0)
    assert rc == 0 and line["correct"] is False
