"""The port's dataflow and relational plane against the JAX package.

Each scenario is one function of the package under test (``pw``); it runs
once through ``pathway_tpu`` and once through ``pathway_tpu_torch`` in this
process, and the two results must be identical: the printed tables of
``compute_and_print``, the change stream ``pw.io.subscribe`` sees, and the
files the csv/jsonlines writers leave.
"""

import contextlib
import io
import json

import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu_torch.internals.parse_graph import G as PORT_G


@pytest.fixture(autouse=True)
def _clear_port_graph():
    PORT_G.clear()
    yield
    PORT_G.clear()


def _printed(pw, table, **kwargs) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pw.debug.compute_and_print(table, include_id=False, **kwargs)
    return buf.getvalue()


def _people(pw):
    return pw.debug.table_from_markdown(
        """
        name  | dept  | age | salary
        alice | eng   | 31  | 120
        bob   | eng   | 45  | 150
        carol | sales | 27  | 90
        dave  | sales | 38  | 95
        erin  | ops   | 52  | 110
        """
    )


def scen_select_filter(pw):
    t = _people(pw)
    out = t.filter(pw.this.age > 30).select(
        pw.this.name, older=pw.this.age + 1, rich=pw.this.salary >= 110
    )
    return _printed(pw, out)


def scen_groupby_reduce(pw):
    t = _people(pw)
    out = t.groupby(pw.this.dept).reduce(
        pw.this.dept,
        n=pw.reducers.count(),
        total=pw.reducers.sum(pw.this.salary),
        oldest=pw.reducers.max(pw.this.age),
        names=pw.reducers.sorted_tuple(pw.this.name),
    )
    return _printed(pw, out)


def _depts(pw):
    return pw.debug.table_from_markdown(
        """
        dept  | floor
        eng   | 3
        sales | 1
        hr    | 2
        """
    )


def scen_join(pw, mode):
    people, depts = _people(pw), _depts(pw)
    join = getattr(people, {"inner": "join"}.get(mode, f"join_{mode}"))
    out = join(depts, people.dept == depts.dept).select(
        people.name, depts.floor
    )
    return _printed(pw, out)


def scen_tumbling_window(pw):
    t = pw.debug.table_from_markdown(
        """
        t  | v
        1  | 10
        2  | 20
        4  | 5
        7  | 1
        9  | 2
        11 | 3
        """
    )
    out = t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4)).reduce(
        start=pw.this._pw_window_start,
        end=pw.this._pw_window_end,
        total=pw.reducers.sum(pw.this.v),
        n=pw.reducers.count(),
    )
    return _printed(pw, out)


def scen_iterate(pw):
    # Collatz steps to a fixed point: x -> x/2 (even) or 3x+1 (odd), 1 stays
    t = pw.debug.table_from_markdown(
        """
        x
        6
        7
        1
        """
    )

    def step(t):
        return t.select(
            x=pw.if_else(
                pw.this.x == 1,
                1,
                pw.if_else(pw.this.x % 2 == 0, pw.this.x // 2, 3 * pw.this.x + 1),
            )
        )

    return _printed(pw, pw.iterate(step, t=t))


def scen_streaming_subscribe(pw):
    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for word in ["a", "b", "a", "c", "a", "b"]:
                self.next(word=word)
                self.commit()

    class Schema(pw.Schema):
        word: str

    words = pw.io.python.read(Subject(), schema=Schema)
    counts = words.groupby(pw.this.word).reduce(
        pw.this.word, n=pw.reducers.count()
    )
    events = []
    pw.io.subscribe(
        counts,
        on_change=lambda key, row, time, is_addition: events.append(
            (row["word"], row["n"], time, is_addition)
        ),
    )
    pw.run()
    # commit times are the wall clock's: compare them by their order
    rank = {t: i for i, t in enumerate(sorted({e[2] for e in events}))}
    return [(w, n, rank[t], add) for w, n, t, add in events]


def scen_file_io(pw, fmt, tmp_path):
    src = tmp_path / f"in_{pw.__name__}"
    src.mkdir()
    rows = [{"k": "x", "v": 1}, {"k": "y", "v": 2}, {"k": "x", "v": 5}]
    if fmt == "csv":
        (src / "a.csv").write_text("k,v\n" + "".join(f"{r['k']},{r['v']}\n" for r in rows))
    else:
        (src / "a.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))

    class Schema(pw.Schema):
        k: str
        v: int

    reader = getattr(pw.io, fmt)
    t = reader.read(str(src), schema=Schema, mode="static")
    out = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
    dst = tmp_path / f"out_{pw.__name__}.{fmt}"
    reader.write(out, str(dst))
    pw.run()
    lines = dst.read_text().splitlines()
    if fmt == "csv":
        header = lines[0].split(",")
        recs = [dict(zip(header, line.split(","))) for line in lines[1:]]
    else:
        header = None
        recs = [json.loads(line) for line in lines]
    # the time column holds the wall clock's commit times: keep their order
    rank = {t: i for i, t in enumerate(sorted({int(r["time"]) for r in recs}))}
    for r in recs:
        r["time"] = rank[int(r["time"])]
    return header, sorted(recs, key=lambda r: (r["k"], r["time"]))


SCENARIOS = {
    "select_filter": scen_select_filter,
    "groupby_reduce": scen_groupby_reduce,
    "join_inner": lambda pw: scen_join(pw, "inner"),
    "join_left": lambda pw: scen_join(pw, "left"),
    "join_right": lambda pw: scen_join(pw, "right"),
    "join_outer": lambda pw: scen_join(pw, "outer"),
    "tumbling_window": scen_tumbling_window,
    "iterate": scen_iterate,
    "streaming_subscribe": scen_streaming_subscribe,
}


def _both(fn, *args):
    JAX_G.clear()
    want = fn(pathway_tpu, *args)
    JAX_G.clear()
    got = fn(pathway_tpu_torch, *args)
    return want, got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_dataflow_matches_the_jax_package(name):
    want, got = _both(SCENARIOS[name])
    assert want, "the scenario produced nothing"
    assert got == want


@pytest.mark.parametrize("fmt", ["csv", "jsonlines"])
def test_file_io_matches_the_jax_package(fmt, tmp_path):
    want, got = _both(scen_file_io, fmt, tmp_path)
    assert len(want[1]) == 2
    assert got == want


def test_streaming_shows_retraction_pairs():
    _, got = _both(scen_streaming_subscribe)
    # every later count of a word arrives as a retraction of the old row
    # and an insertion of the new one at the same time
    for word, final in (("a", 3), ("b", 2)):
        for n in range(2, final + 1):
            adds = [t for w, c, t, add in got if w == word and c == n and add]
            dels = [t for w, c, t, add in got if w == word and c == n - 1 and not add]
            assert adds and adds[0] in dels, (word, n, got)


def test_compute_and_print_text_matches():
    def fn(pw):
        t = _people(pw)
        return _printed(pw, t.select(pw.this.name, pw.this.age), short_pointers=True)

    want, got = _both(fn)
    assert "alice" in want
    assert got == want


@pytest.mark.parametrize("value", [
    {"text": "the cat", "metadata": {"path": "/a.txt", "size": 7}},
    [1, 2.5, None, "x"],
    "plain",
])
def test_json_keeps_its_hash_and_leaves_it_out_of_pickles(value):
    """The port's ``Json`` hashes its value once and keeps it; the hash is
    the JAX package's, and a pickle carries the value, not the hash."""
    import pickle

    from pathway_tpu.internals.api import Json as JaxJson
    from pathway_tpu_torch.internals.api import Json

    j = Json(value)
    assert hash(j) == hash(JaxJson(value)) == hash(j)
    assert j._hash == hash(JaxJson(value))
    back = pickle.loads(pickle.dumps(j))
    assert back == j and back.value == value
    assert not hasattr(back, "_hash")
    assert hash(back) == hash(j)
    assert {j: 1}[Json(value)] == 1
