"""The port's multi-process relational plane, end to end over real
processes: ``tests/test_multiprocess.py`` on ``pathway_tpu_torch``.

PATHWAY_PROCESSES ranks (separate interpreters) run the same program: fs
sources shard files across ranks, ExchangeNodes hash-route rows at
groupby/join boundaries over the TCP mesh, the rank-0 clock master
assigns timestamps, and outputs gather to rank 0. Each scenario's merged
rows must equal the same program run once, in one process, through the
JAX package. Every spawn has its own timeout, so a hang fails one test.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import zlib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150


# Port bases come from below the host's ephemeral range. A port from
# bind(("", 0)) is ephemeral (odd, on Linux), and every outgoing TCP
# connection on the host takes its source port from the same range (the
# even ports): between the probe and the ranks' binds (the launcher's and
# then each rank's imports, seconds under a loaded test run) another
# process's connection could take base + 1, and that rank's listener then
# failed to bind. Below the range only an explicit bind takes a port. The
# ports there are cut into blocks, and each process walks them from a
# block of its own, picked by its pid and this checkout's path: the pid
# times a prime, so that nearby pids (pytest-xdist workers, or two test
# runs of two checkouts on one host) start hundreds of blocks apart and
# do not probe the same ports in the same seconds.
_BLOCK = 16  # ports a block: the most one base is asked for
_SPAN = 8192  # ports below the ephemeral range that the blocks cover


def _port_blocks() -> range:
    """The first port of each block below the ephemeral range."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768  # Linux's default
    return range(max(1024, low - _SPAN), low - _BLOCK + 1, _BLOCK)


def _first_block(pid: int, n_blocks: int) -> int:
    return (pid * 7919 + zlib.crc32(REPO.encode())) % n_blocks


_next_block = {"at": None}


def _free_port_base(n: int = 5) -> int:
    """A base with n consecutive free ports (bound, then released): the
    rank listeners and the coordinator past them, the first of the next
    block of this process's walk where they are all free."""
    assert n <= _BLOCK
    blocks = _port_blocks()
    if _next_block["at"] is None:
        _next_block["at"] = _first_block(os.getpid(), len(blocks))
    for _ in range(len(blocks)):
        base = blocks[_next_block["at"]]
        _next_block["at"] = (_next_block["at"] + 1) % len(blocks)
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no consecutive free port range found")


def test_port_bases_lie_below_the_ephemeral_range():
    """Each base and the ports past it lie in one block below the range
    that bind(("", 0)) and outgoing connections draw from, and are free
    when handed out."""
    blocks = _port_blocks()
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    assert blocks[-1] + _BLOCK <= low
    for n in (2, 5, 9):
        base = _free_port_base(n)
        assert base in blocks and base + n - 1 < base + _BLOCK
        socks = [socket.socket() for _ in range(n)]
        try:
            for i, s in enumerate(socks):
                s.bind(("127.0.0.1", base + i))
        finally:
            for s in socks:
                s.close()


def test_nearby_pids_start_their_walks_apart():
    """Processes whose pids lie within one cycle of blocks start their
    walks at different blocks, and two consecutive pids a tenth of the
    blocks or more apart, so that their first few bases never meet."""
    n_blocks = len(_port_blocks())
    pid = os.getpid()
    firsts = [_first_block(p, n_blocks) for p in range(pid, pid + n_blocks)]
    assert len(set(firsts)) == n_blocks
    for a, b in zip(firsts, firsts[1:]):
        assert min((a - b) % n_blocks, (b - a) % n_blocks) >= n_blocks // 10


def _env(**kw):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **kw)
    return env


def _communicate(procs, timeout):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, f"rank failed rc={rc}\nstdout:{out}\nstderr:{err}"
    return outs


def _spawn(program: str, workdir: str, processes: int, timeout: int = TIMEOUT):
    port = _free_port_base()
    procs = [
        subprocess.Popen(
            [sys.executable, program],
            env=_env(PATHWAY_PROCESSES=str(processes),
                     PATHWAY_PROCESS_ID=str(rank), PATHWAY_FIRST_PORT=str(port)),
            cwd=workdir, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            start_new_session=True,
        )
        for rank in range(processes)
    ]
    return _communicate(procs, timeout)


def _run_single(program: str, workdir: str, timeout: int = TIMEOUT):
    """The program once, in one process."""
    proc = subprocess.Popen(
        [sys.executable, program], env=_env(PATHWAY_PROCESSES="1"), cwd=workdir,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, start_new_session=True,
    )
    return _communicate([proc], timeout)


def _write_programs(tmp_path, template: str, **fmt):
    """The port's program (``prog_multi.py``) and the JAX package's
    (``prog_single.py``), each writing its own output files."""
    multi = tmp_path / "prog_multi.py"
    multi.write_text(template.format(pkg="pathway_tpu_torch", suffix="multi", **fmt))
    single = tmp_path / "prog_single.py"
    single.write_text(template.format(pkg="pathway_tpu", suffix="single", **fmt))
    return str(multi), str(single)


WORDCOUNT = """
import {pkg} as pw

class S(pw.Schema):
    word: str

t = pw.io.jsonlines.read("in", schema=S, mode="static")
counts = t.groupby(pw.this.word).reduce(
    word=pw.this.word, c=pw.reducers.count()
)
pw.io.jsonlines.write(counts, "out_{suffix}.jsonl")
pw.run(monitoring_level=pw.MonitoringLevel.NONE)
"""

JOIN_PIPELINE = """
import {pkg} as pw

class L(pw.Schema):
    k: int
    j: int
    v: int

class R(pw.Schema):
    k: int
    j: int
    w: str

lt = pw.io.jsonlines.read("inl", schema=L, mode="static")
rt = pw.io.jsonlines.read("inr", schema=R, mode="static")
out = lt.join(rt, pw.left.j == pw.right.j).select(
    v=pw.left.v, w=pw.right.w
)
agg = out.groupby(pw.this.w).reduce(
    w=pw.this.w, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count()
)
pw.io.jsonlines.write(agg, "out_{suffix}.jsonl")
pw.run(monitoring_level=pw.MonitoringLevel.NONE)
"""


def _read_rows(path, drop=("time", "diff", "id")):
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                for key in drop:
                    d.pop(key, None)
                rows.append(tuple(sorted(d.items())))
    return sorted(rows)


def _wordcount_input(tmp_path, files=6, per_file=40):
    os.makedirs(tmp_path / "in")
    words = ["alpha", "beta", "gamma", "delta", "epsilon"]
    for f in range(files):  # several files so path-sharding spreads ranks
        with open(tmp_path / "in" / f"part{f}.jsonl", "w") as fh:
            for i in range(per_file):
                fh.write(json.dumps({"word": words[(i * 7 + f) % len(words)]}) + "\n")


@pytest.mark.parametrize("processes", [2, 3])
def test_multiprocess_wordcount(tmp_path, processes):
    _wordcount_input(tmp_path)
    multi, single = _write_programs(tmp_path, WORDCOUNT)
    _spawn(multi, str(tmp_path), processes)
    _run_single(single, str(tmp_path))
    got = _read_rows(tmp_path / "out_multi.jsonl")
    want = _read_rows(tmp_path / "out_single.jsonl")
    assert got == want and got, (got, want)


ITERATE_GRAPHS = """
import {pkg} as pw

class E(pw.Schema):
    un: str
    vn: str
    dist: float

edge_names = pw.io.jsonlines.read("in_edges", schema=E, mode="static")
verts = edge_names.select(name=pw.this.un).concat_reindex(
    edge_names.select(name=pw.this.vn)
).groupby(pw.this.name).reduce(name=pw.this.name)
verts = verts.with_id(verts.pointer_from(verts.name)).with_columns(
    is_source=pw.this.name == "a"
)
edges = edge_names.select(
    u=verts.pointer_from(edge_names.un),
    v=verts.pointer_from(edge_names.vn),
    dist=edge_names.dist,
)
bf = pw.graphs.bellman_ford(verts, edges)
vnames = verts.select(pw.this.name)
res = vnames.join(
    bf, vnames.id == bf.v
).select(name=pw.left.name, d=pw.right.dist_from_source)
pw.io.jsonlines.write(res, "out_bf_{suffix}.jsonl")

pr = pw.graphs.pagerank(edges.select(u=pw.this.u, v=pw.this.v), steps=4)
ranked = pr.groupby().reduce(total=pw.reducers.sum(pw.this.rank))
pw.io.jsonlines.write(ranked, "out_pr_{suffix}.jsonl")
pw.run(monitoring_level=pw.MonitoringLevel.NONE)
"""


def test_multiprocess_iterate_graph_algorithms(tmp_path):
    """pw.iterate under PATHWAY_PROCESSES=2: bellman_ford and pagerank
    fixpoints give the single-process result with the edge files sharded
    across two ranks."""
    os.makedirs(tmp_path / "in_edges")
    edges = [
        ("a", "b", 2.0), ("b", "c", 3.0), ("a", "c", 10.0),
        ("c", "d", 1.0), ("b", "d", 7.0), ("d", "e", 2.0),
    ]
    for f in range(3):
        with open(tmp_path / "in_edges" / f"e{f}.jsonl", "w") as fh:
            for i, (u, v, d) in enumerate(edges):
                if i % 3 == f:
                    fh.write(json.dumps({"un": u, "vn": v, "dist": d}) + "\n")
    multi, single = _write_programs(tmp_path, ITERATE_GRAPHS)
    _spawn(multi, str(tmp_path), 2)
    _run_single(single, str(tmp_path))
    bf_multi = _read_rows(tmp_path / "out_bf_multi.jsonl")
    bf_single = _read_rows(tmp_path / "out_bf_single.jsonl")
    assert bf_multi == bf_single and bf_multi, (bf_multi, bf_single)
    # shortest paths from 'a': a=0, b=2, c=5, d=6, e=8
    assert sorted(dict(r)["d"] for r in bf_multi) == [0.0, 2.0, 5.0, 6.0, 8.0]
    pr_multi = _read_rows(tmp_path / "out_pr_multi.jsonl")
    pr_single = _read_rows(tmp_path / "out_pr_single.jsonl")
    assert pr_multi == pr_single and pr_multi


def test_multiprocess_join_groupby(tmp_path):
    os.makedirs(tmp_path / "inl")
    os.makedirs(tmp_path / "inr")
    for f in range(4):
        with open(tmp_path / "inl" / f"l{f}.jsonl", "w") as fh:
            for i in range(30):
                k = f * 1000 + i
                fh.write(json.dumps({"k": k, "j": k % 7, "v": k % 13}) + "\n")
    with open(tmp_path / "inr" / "r0.jsonl", "w") as fh:
        for j in range(7):
            fh.write(json.dumps({"k": j, "j": j, "w": f"g{j % 3}"}) + "\n")
    multi, single = _write_programs(tmp_path, JOIN_PIPELINE)
    _spawn(multi, str(tmp_path), 3)
    _run_single(single, str(tmp_path))
    got = _read_rows(tmp_path / "out_multi.jsonl")
    want = _read_rows(tmp_path / "out_single.jsonl")
    assert got == want and got, (got, want)


# every rank emits its slice of the key space with live commits and
# cross-commit retractions; the single process emits all three slices
STREAMING_PIPELINE = """
import time
import {pkg} as pw
from {pkg}.internals.config import get_pathway_config

class S(pw.Schema):
    k: int = pw.column_definition(primary_key=True)
    g: int
    v: int

class RankSubject(pw.io.python.ConnectorSubject):
    _distributed_partitioned = True

    def run(self):
        c = get_pathway_config()
        ranks = [c.process_id] if c.processes > 1 else range({ranks})
        for r in ranks:
            base = r * 1000
            for i in range(8):
                self.next(k=base + i, g=i % 3, v=10 * r + i)
                self.commit()
                time.sleep(0.02)
            # retract half of what this rank emitted, in later rounds
            for i in range(0, 8, 2):
                self.remove(k=base + i, g=i % 3, v=10 * r + i)
                self.commit()
                time.sleep(0.02)

t = pw.io.python.read(RankSubject(), schema=S, autocommit_duration_ms=None)
agg = t.groupby(pw.this.g).reduce(
    g=pw.this.g, c=pw.reducers.count(), s=pw.reducers.sum(pw.this.v),
    mn=pw.reducers.min(pw.this.v),
)
pw.io.jsonlines.write(agg, "out_{suffix}.jsonl")
pw.run(monitoring_level=pw.MonitoringLevel.NONE)
"""


def _net_rows(path):
    """Fold the written update stream into its final net state."""
    net = {}
    if not os.path.exists(path):
        return []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            diff = d.pop("diff")
            d.pop("time")
            key = tuple(sorted(d.items()))
            net[key] = net.get(key, 0) + diff
    return sorted(k for k, c in net.items() if c > 0)


def test_multiprocess_live_streaming_with_retractions(tmp_path):
    """Live commits arrive across BSP rounds on every rank, with
    retractions spanning rounds: the lockstep exchange keeps the groupby
    state exact."""
    multi, single = _write_programs(tmp_path, STREAMING_PIPELINE, ranks=3)
    _spawn(multi, str(tmp_path), 3, timeout=180)
    _run_single(single, str(tmp_path))
    # the deterministic final state: ranks r in {0,1,2}, i in {1,3,5,7}
    expected = {}
    for r in range(3):
        for i in range(1, 8, 2):
            g = i % 3
            c, s, mn = expected.get(g, (0, 0, None))
            v = 10 * r + i
            expected[g] = (c + 1, s + v, v if mn is None else min(mn, v))
    exp_rows = sorted(
        (("c", c), ("g", g), ("mn", mn), ("s", s))
        for g, (c, s, mn) in expected.items()
    )
    got = _net_rows(tmp_path / "out_multi.jsonl")
    assert got == exp_rows, (got, exp_rows)
    assert _net_rows(tmp_path / "out_single.jsonl") == exp_rows


def test_cli_spawn_multiprocess(tmp_path):
    """``python -m pathway_tpu_torch spawn -n 2`` launches the rank fleet
    (reference: cli.py spawn --processes)."""
    os.makedirs(tmp_path / "in")
    with open(tmp_path / "in" / "a.jsonl", "w") as fh:
        for i in range(20):
            fh.write(json.dumps({"word": f"w{i % 3}"}) + "\n")
    multi, single = _write_programs(tmp_path, WORDCOUNT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch", "spawn", "-n", "2",
         "--first-port", str(_free_port_base()), multi],
        env=_env(), cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True,
    )
    _communicate([proc], TIMEOUT)
    _run_single(single, str(tmp_path))
    got = _read_rows(tmp_path / "out_multi.jsonl")
    assert got, "no output rows from the CLI spawn"
    assert got == _read_rows(tmp_path / "out_single.jsonl")


def _cli(args, workdir, timeout=TIMEOUT, **env):
    proc = subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch", *args], env=_env(**env),
        cwd=str(workdir), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True,
    )
    return _communicate([proc], timeout)[0]


def test_cli_spawn_one_process_and_spawn_from_env(tmp_path):
    """``spawn`` without ``-n`` runs the program in the launcher's own
    process; ``spawn-from-env`` reads its arguments from
    PATHWAY_SPAWN_ARGS. Both give the JAX package's single-process rows."""
    _wordcount_input(tmp_path, files=3, per_file=20)
    multi, single = _write_programs(tmp_path, WORDCOUNT)
    _run_single(single, str(tmp_path))
    want = _read_rows(tmp_path / "out_single.jsonl")
    _cli(["spawn", multi], tmp_path)
    assert _read_rows(tmp_path / "out_multi.jsonl") == want and want
    os.remove(tmp_path / "out_multi.jsonl")
    _cli(["spawn-from-env"], tmp_path,
         PATHWAY_SPAWN_ARGS=f"-n 2 --first-port {_free_port_base()} {multi}")
    assert _read_rows(tmp_path / "out_multi.jsonl") == want


def test_cli_replay_sets_the_replay_storage(tmp_path):
    prog = tmp_path / "prog.py"
    prog.write_text(
        "import os, sys\n"
        "print('REPLAY', os.environ['PATHWAY_REPLAY_STORAGE'],"
        " os.environ['PATHWAY_SNAPSHOT_ACCESS'], sys.argv[1:])\n"
    )
    _, out, _ = _cli(["replay", "--record-path", "rec", "--mode", "speedrun",
                      str(prog), "a", "b"], tmp_path)
    assert "REPLAY rec speedrun ['a', 'b']" in out


def test_cli_airbyte_create_source_matches_the_jax_package(tmp_path):
    from pathway_tpu.cli import main as jax_main
    from pathway_tpu_torch.cli import main
    from pathway_tpu_torch.io.airbyte import _load_connection

    args = ["--image", "airbyte/source-github:1.0.0"]
    assert main(["airbyte", "create-source", str(tmp_path / "port" / "gh"), *args]) == 0
    assert jax_main(["airbyte", "create-source", str(tmp_path / "jax" / "gh"), *args]) == 0
    written = (tmp_path / "port" / "gh.yaml").read_text()
    assert written == (tmp_path / "jax" / "gh.yaml").read_text()
    cfg = _load_connection(str(tmp_path / "port" / "gh.yaml"))
    assert cfg["source"]["docker_image"] == "airbyte/source-github:1.0.0"
    # an existing file is not overwritten
    assert main(["airbyte", "create-source", str(tmp_path / "port" / "gh")]) == 1
