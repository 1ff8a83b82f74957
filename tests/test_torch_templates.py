"""The repo's seven template programs on the port, held to the JAX package.

The programs are those of tests/test_templates.py: the five served
templates of ``examples/`` (demo-question-answering, adaptive-rag,
multimodal-rag, private-rag, slides-search), ``examples/etl-lakehouse``
and ``examples/projects/spawn-deploy``. Each case copies its program into
``tmp_path`` twice. One copy stays as it is and runs on ``pathway_tpu``.
In the other, ``pathway_tpu`` is rewritten to ``pathway_tpu_torch``, and
the copy asks for the port's KNN index on the CPU (``index_params=
{"device": "cpu"}``, or ``device="cpu"`` on slides-search's factory): the
port's index runs on the card by default and raises without one. Both
copies run as processes of their own over the same documents, and their
answers must agree:

* the served templates: the HTTP JSON of ``/v2/answer``, ``/v1/retrieve``,
  ``/v1/parsed_documents`` and ``/v1/statistics``, asked once both servers
  count every document;
* etl-lakehouse: the Delta Lake rows and the warehouse statements it
  prints;
* spawn-deploy: the live per-user rows of rank 0's ``counts.jsonl`` under
  ``spawn --processes 2``.

Floats agree to 1e-5: both packages score in f32, in another summation
order. ``seen_at`` and ``last_indexed`` are left out: they are the
wall-clock second at which each process's reader saw a file.
"""

import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
TOL = 1e-5
WALL_CLOCK_KEYS = ("seen_at", "last_indexed")
# the prompt of tests/test_templates.py's knowledge file, beside each
# template's own documents
KNOWLEDGE = (
    "pathway tpu is a streaming dataflow framework with native "
    "tpu retrieval and incremental consistency"
)
ANSWER = "/v2/answer"
RETRIEVE = "/v1/retrieve"
STATISTICS = "/v1/statistics"
PARSED = "/v1/parsed_documents"
# template -> (its documents folder, the port's CPU index argument, requests)
SERVED = {
    "demo-question-answering": ("docs", 'index_params={"device": "cpu"}', [
        (ANSWER, {"prompt": "what is pathway tpu"}),
        (RETRIEVE, {"query": "what is pathway tpu", "k": 2}),
        (STATISTICS, {}),
    ]),
    "adaptive-rag": ("docs", 'index_params={"device": "cpu"}', [
        (ANSWER, {"prompt": "pathway tpu streaming dataflow framework"}),
        (RETRIEVE, {"query": "pathway tpu connectors", "k": 3}),
        (STATISTICS, {}),
    ]),
    "multimodal-rag": ("docs", 'index_params={"device": "cpu"}', [
        (ANSWER, {"prompt": "bar chart showing quarterly revenue"}),
        (ANSWER, {"prompt": "what does the multimodal pipeline index"}),
        (RETRIEVE, {"query": "architecture slide", "k": 2}),
        (STATISTICS, {}),
    ]),
    "private-rag": ("docs", 'index_params={"device": "cpu"}', [
        (ANSWER, {"prompt": "pathway tpu streaming dataflow framework"}),
        (RETRIEVE, {"query": "local models stay private", "k": 2}),
        (STATISTICS, {}),
    ]),
    "slides-search": ("decks", 'device="cpu"', [
        (RETRIEVE, {"query": "tpu architecture overview", "k": 2}),
        (PARSED, {}),
        (STATISTICS, {}),
    ]),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


def _copy_program(src: str, dest: str, package: str, cpu_index: str | None = None) -> str:
    """Copy a program folder; on the port, rewrite its imports and ask for
    the CPU index."""
    shutil.copytree(src, dest)
    if package == "pathway_tpu":
        return dest
    for root, _dirs, files in os.walk(dest):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                text = f.read()
            text = re.sub(r"\bpathway_tpu\b", "pathway_tpu_torch", text)
            if cpu_index is not None and name == "app.py":
                old = 'embedder=cfg["embedder"]'
                assert text.count(old) == 1, f"{path}: no single {old}"
                text = text.replace(old, f"{old}, {cpu_index}")
            with open(path, "w", encoding="utf-8") as f:
                f.write(text)
    return dest


def _post(url: str, payload: dict, timeout: float = 30.0):
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _tail(path: str) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-3000:]


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)


def _wait_for_files(port: int, n_files: int, proc, log: str, deadline_s: float = 120.0):
    """Poll /v1/statistics until the server counts every document."""
    deadline = time.monotonic() + deadline_s
    count = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"the server exited ({proc.returncode}):\n{_tail(log)}")
        try:
            count = _post(f"http://127.0.0.1:{port}{STATISTICS}", {}, timeout=5).get("file_count")
        except (urllib.error.URLError, ConnectionError, OSError):
            count = None
        if count == n_files:
            return
        time.sleep(0.25)
    raise AssertionError(f"file_count {count} of {n_files} after {deadline_s} s:\n{_tail(log)}")


def _plain(v):
    """JSON without the wall-clock keys."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items() if k not in WALL_CLOCK_KEYS}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


def _assert_same(got, want, path="answer"):
    """Equal structure and values; floats within TOL."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(float(got) - float(want)) <= TOL, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("template", sorted(SERVED))
def test_served_template_answers_as_on_the_jax_package(tmp_path, template):
    folder, cpu_index, requests = SERVED[template]
    src = os.path.join(REPO, "examples", template)
    docs = tmp_path / folder
    shutil.copytree(os.path.join(src, folder), docs)
    if folder == "docs":
        (docs / "tpu.txt").write_text(KNOWLEDGE)
    n_files = len(os.listdir(docs))

    procs, ports = {}, {}
    try:
        for package in PACKAGES:
            prog = _copy_program(src, str(tmp_path / package), package, cpu_index)
            ports[package] = _free_port()
            cfg = open(os.path.join(src, "app.yaml")).read()
            cfg = cfg.replace(f"./{folder}", str(docs))
            cfg = re.sub(r"(?m)^port: \d+$", f"port: {ports[package]}", cfg)
            config = os.path.join(prog, "run.yaml")
            with open(config, "w") as f:
                f.write(cfg)
            log = os.path.join(prog, "run.log")
            with open(log, "w") as out:
                procs[package] = subprocess.Popen(
                    [sys.executable, "app.py", config], cwd=prog, env=_env(),
                    stdout=out, stderr=subprocess.STDOUT,
                )
        for package in PACKAGES:
            _wait_for_files(ports[package], n_files, procs[package],
                            os.path.join(tmp_path, package, "run.log"))
        for route, payload in requests:
            want, got = (
                _plain(_post(f"http://127.0.0.1:{ports[p]}{route}", payload))
                for p in PACKAGES
            )
            assert want, (route, payload)
            _assert_same(got, want, f"{route} {payload}")
    finally:
        for proc in procs.values():
            _stop(proc)


def _etl_sections(stdout: str) -> tuple:
    """The header and the sorted rows of each section the program prints.
    Both packages print rows in the order of their row keys, which the
    process's string hashing reorders from run to run."""
    sections: dict = {}
    name = None
    for line in stdout.splitlines():
        if line.startswith("-- ") and line.endswith(" --"):
            name = line
            sections[name] = []
        elif name is not None and line.strip():
            sections[name].append(line)
    return tuple(
        (name, lines[:1], sorted(lines[1:])) for name, lines in sections.items()
    )


def test_etl_lakehouse_writes_as_on_the_jax_package(tmp_path):
    """The lake rows and the warehouse statements, as the program prints
    them (its lake lies in a fresh temporary folder of each run).

    Both packages' runs of this program may abort in the interpreter's
    teardown, after the program has printed all of its output: a C++
    thread is destroyed while joinable ("terminate called without an
    active exception"). That exit is accepted only with the whole output
    printed and that message alone on stderr."""
    src = os.path.join(REPO, "examples", "etl-lakehouse")
    outs = {}
    for package in PACKAGES:
        prog = _copy_program(src, str(tmp_path / package), package)
        r = subprocess.run(
            [sys.executable, "app.py"], cwd=prog, env=_env(TMPDIR=str(tmp_path)),
            capture_output=True, timeout=120,
        )
        out, err = r.stdout.decode(), r.stderr.decode()
        teardown_abort = (
            r.returncode == -signal.SIGABRT
            and out.endswith("COMMIT;\n")
            and err.strip() == "terminate called without an active exception"
        )
        assert r.returncode == 0 or teardown_abort, (package, r.returncode, err[-3000:])
        outs[package] = _etl_sections(out)
    want, got = (outs[p] for p in PACKAGES)
    lake, warehouse = want
    assert lake[0] == "-- delta lake contents --"
    assert "ann | 130 | 2 | 120" in lake[2]
    assert warehouse[0] == "-- warehouse statements --"
    assert any('ON CONFLICT ("user") DO UPDATE' in s for s in warehouse[2])
    assert got == want


def test_spawn_deploy_counts_as_on_the_jax_package(tmp_path):
    """Two ranks over the loopback mesh; rank 0's live per-user rows."""
    src = os.path.join(REPO, "examples", "projects", "spawn-deploy")
    live = {}
    for package in PACKAGES:
        prog = _copy_program(src, str(tmp_path / package), package)
        out_dir = tmp_path / f"out-{package}"
        r = subprocess.run(
            [sys.executable, "-m", f"{package}.cli", "spawn", "--processes", "2",
             os.path.join(prog, "main.py")],
            cwd=prog, capture_output=True, timeout=300,
            env=_env(N_EVENTS="5000", OUT_DIR=str(out_dir),
                     PATHWAY_FIRST_PORT=str(_free_port())),
        )
        assert r.returncode == 0, (package, r.stderr.decode()[-3000:])
        rows = {}
        for line in (out_dir / "counts.jsonl").read_text().splitlines():
            if not line.strip():
                continue
            row = json.loads(line)
            if row.get("diff", 1) > 0:
                rows[row["user"]] = (row["n"], row["total"])
            else:
                rows.pop(row["user"], None)
        live[package] = rows
    want, got = (live[p] for p in PACKAGES)
    assert len(want) == 97
    assert sum(n for n, _t in want.values()) == 5000
    assert sum(t for _n, t in want.values()) == sum(i % 13 for i in range(5000))
    assert got == want
