"""``parallel/distributed.py``: the PATHWAY_* variables that ``spawn``
sets, as a ``torch.distributed`` process group.

The JAX package's ``initialize_from_env`` returns False at one process
and hands the variables to ``jax.distributed`` otherwise; the port keeps
that contract with ``init_process_group``. Its backend follows one rule
(NCCL when every rank has a card of its own, gloo otherwise), and its
default coordinator lies past the ports the engine's mesh listens on.
"""

import json
import os
import signal
import subprocess
import sys
import types

import pytest
import torch

from pathway_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK_PROGRAM = """
import json, sys
import torch
import torch.distributed as dist
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.parallel import distributed, global_mesh, initialize_from_env

cfg = get_pathway_config()
ok = initialize_from_env(device="cpu")
t = torch.tensor([float(cfg.process_id + 1)])
dist.all_reduce(t)
mesh = global_mesh(axes=("dp",), device="cpu")

# the engine's mesh runs beside the process group: rank r listens on
# first_port + r, the group's store on the coordinator
class S(pw.Schema):
    word: str

rows = pw.io.jsonlines.read("in", schema=S, mode="static")
counts = rows.groupby(pw.this.word).reduce(word=pw.this.word, c=pw.reducers.count())
pw.io.jsonlines.write(counts, "out.jsonl")
pw.run(monitoring_level=pw.MonitoringLevel.NONE)
print("RESULT", json.dumps({
    "ok": ok, "backend": dist.get_backend(), "world": dist.get_world_size(),
    "rank": dist.get_rank(), "sum": t.item(), "mesh": str(mesh),
    "coordinator": distributed.default_coordinator(),
    "mesh_ports": [cfg.first_port + r for r in range(cfg.processes)],
}))
dist.destroy_process_group()
"""


def _config(processes, process_id=0, first_port=10000):
    return types.SimpleNamespace(
        processes=processes, process_id=process_id, first_port=first_port)


def test_initialize_from_env_returns_false_at_one_process(monkeypatch):
    monkeypatch.setattr(distributed, "get_pathway_config", lambda: _config(1))
    assert distributed.initialize_from_env() is False
    assert not torch.distributed.is_initialized()


def test_initialize_from_env_refuses_to_drop_to_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    monkeypatch.setattr(distributed, "get_pathway_config", lambda: _config(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize_from_env()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,cards,processes,want", [
    ("cpu", 0, 2, "gloo"),
    ("cpu", 8, 2, "gloo"),
    (None, 1, 2, "gloo"),     # two ranks on one card: NCCL refuses them
    (None, 2, 2, "nccl"),     # rank r on cuda:r
    (None, 4, 2, "nccl"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 3, 4, "gloo"),
    ("cuda:0", 4, 2, "gloo"),  # every rank pinned to one card
])
def test_backend_rule(monkeypatch, device, cards, processes, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed.choose_backend(device, processes) == want


@pytest.mark.parametrize("processes", [2, 3, 4, 8])
def test_default_coordinator_is_past_the_engine_mesh_ports(monkeypatch, processes):
    monkeypatch.delenv("PATHWAY_COORDINATOR", raising=False)
    for rank in range(processes):
        monkeypatch.setattr(distributed, "get_pathway_config",
                            lambda r=rank: _config(processes, r, 23000))
        host, port = distributed.default_coordinator().rsplit(":", 1)
        assert host == "127.0.0.1"
        assert int(port) == 23000 + processes
        assert int(port) not in {23000 + r for r in range(processes)}
    monkeypatch.setenv("PATHWAY_COORDINATOR", "10.0.0.1:999")
    assert distributed.default_coordinator() == "10.0.0.1:999"


def test_global_mesh_of_one_process_on_the_cpu():
    mesh = distributed.global_mesh(axes=("dp",), device="cpu")
    assert mesh.shape == {"dp": 1}
    assert mesh.axis_devices("dp") == [torch.device("cpu")]


def test_two_spawned_cpu_ranks_form_a_gloo_group(tmp_path):
    from tests.test_torch_multiprocess import _free_port_base, _read_rows

    os.makedirs(tmp_path / "in")
    for f in range(4):
        with open(tmp_path / "in" / f"p{f}.jsonl", "w") as fh:
            for i in range(10):
                fh.write(json.dumps({"word": f"w{(i + f) % 3}"}) + "\n")
    prog = tmp_path / "prog.py"
    prog.write_text(RANK_PROGRAM)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("PATHWAY_COORDINATOR", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch", "spawn", "-n", "2",
         "--first-port", str(_free_port_base()), str(prog)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err.decode()
    results = sorted(
        (json.loads(line.split("RESULT ", 1)[1])
         for line in out.decode().splitlines() if line.startswith("RESULT ")),
        key=lambda r: r["rank"],
    )
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert r["ok"] is True and r["backend"] == "gloo" and r["world"] == 2
        assert r["sum"] == 3.0  # 1 + 2
        assert r["mesh"] == "Mesh({'dp': 1}, devices=[cpu])"
        port = int(r["coordinator"].rsplit(":", 1)[1])
        assert port not in r["mesh_ports"]
    counts = {}
    for f in range(4):
        for i in range(10):
            counts[f"w{(i + f) % 3}"] = counts.get(f"w{(i + f) % 3}", 0) + 1
    assert _read_rows(tmp_path / "out.jsonl") == sorted(
        (("c", c), ("word", w)) for w, c in counts.items())
