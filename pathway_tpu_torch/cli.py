"""pathway CLI, the port's copy of the JAX package's ``cli`` (reference:
python/pathway/cli.py — `pathway spawn` :166, `spawn-from-env` :284,
`replay` :252). Run as ``python -m pathway_tpu_torch spawn -n N prog.py``.

`spawn` launches a pipeline program; --processes N starts N ranks, each a
separate interpreter (``subprocess.Popen``, not a fork, so a rank opens
CUDA normally) with PATHWAY_PROCESSES / PATHWAY_PROCESS_ID /
PATHWAY_FIRST_PORT set: the engine's TCP mesh reads them, and
``parallel.distributed.initialize_from_env`` turns them into a
``torch.distributed`` process group. A rank that is still running when
the launcher stops waiting (an interrupt) is killed."""

from __future__ import annotations

import argparse
import os
import runpy
import subprocess
import sys


def _spawn(args) -> int:
    env = dict(os.environ)
    env["PATHWAY_THREADS"] = str(args.threads)
    env["PATHWAY_PROCESSES"] = str(args.processes)
    env["PATHWAY_FIRST_PORT"] = str(args.first_port)
    program = args.program
    if args.processes > 1:
        procs = []
        for pid in range(args.processes):
            child_env = dict(env)
            child_env["PATHWAY_PROCESS_ID"] = str(pid)
            procs.append(
                subprocess.Popen(
                    [sys.executable, program, *args.arguments], env=child_env
                )
            )
        rc = 0
        try:
            for p in procs:
                rc = rc or p.wait()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        return rc
    env["PATHWAY_PROCESS_ID"] = "0"
    os.environ.update(env)
    sys.argv = [program, *args.arguments]
    runpy.run_path(program, run_name="__main__")
    return 0


def _replay(args) -> int:
    os.environ["PATHWAY_REPLAY_STORAGE"] = args.record_path
    os.environ["PATHWAY_SNAPSHOT_ACCESS"] = args.mode
    sys.argv = [args.program, *args.arguments]
    runpy.run_path(args.program, run_name="__main__")
    return 0


def _spawn_from_env(args) -> int:
    command = os.environ.get("PATHWAY_SPAWN_ARGS", "")
    if not command:
        print("PATHWAY_SPAWN_ARGS is not set", file=sys.stderr)
        return 1
    parts = command.split()
    return main(["spawn", *parts])


_CONNECTION_TEMPLATE = """\
source:
  docker_image: "{image}"
  config:
    # connector-specific configuration — run the connector's `spec`
    # action (or see its docs) for the full schema
# optional: remote execution through an HTTPS runner
# remote_runner:
#   url: https://runner.example.com
#   token: <bearer token>
"""


def _airbyte_create_source(args) -> int:
    """Scaffold a connection YAML (reference: python/pathway/cli.py:294
    `pathway airbyte create-source` over airbyte_serverless
    ConnectionFromFile.init_yaml_config)."""
    path = args.connection
    if not path.endswith((".yaml", ".yml")):
        path = path + ".yaml"
    if os.path.exists(path):
        print(f"{path} already exists; not overwriting", file=sys.stderr)
        return 1
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(_CONNECTION_TEMPLATE.format(image=args.image))
    print(
        f"Connection `{os.path.splitext(os.path.basename(path))[0]}` "
        f"with source `{args.image}` created successfully"
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pathway")
    sub = parser.add_subparsers(dest="command", required=True)

    spawn = sub.add_parser("spawn", help="run a pathway program")
    spawn.add_argument("--threads", "-t", type=int, default=1)
    spawn.add_argument("--processes", "-n", type=int, default=1)
    spawn.add_argument("--first-port", type=int, default=10000)
    spawn.add_argument("--record", action="store_true")
    spawn.add_argument("--record-path", default="record")
    spawn.add_argument("program")
    spawn.add_argument("arguments", nargs=argparse.REMAINDER)
    spawn.set_defaults(fn=_spawn)

    replay = sub.add_parser("replay", help="replay a recorded stream")
    replay.add_argument("--record-path", required=True)
    replay.add_argument(
        "--mode", choices=["replay", "speedrun"], default="replay"
    )
    replay.add_argument("program")
    replay.add_argument("arguments", nargs=argparse.REMAINDER)
    replay.set_defaults(fn=_replay)

    sfe = sub.add_parser("spawn-from-env", help="spawn using PATHWAY_SPAWN_ARGS")
    sfe.set_defaults(fn=_spawn_from_env)

    airbyte = sub.add_parser("airbyte", help="airbyte connection tooling")
    airbyte_sub = airbyte.add_subparsers(dest="airbyte_command", required=True)
    create = airbyte_sub.add_parser(
        "create-source", help="scaffold a connection YAML"
    )
    create.add_argument("connection", help="connection file path (or name)")
    create.add_argument(
        "--image",
        default="airbyte/source-faker:0.1.4",
        help="any public Airbyte source docker image",
    )
    create.set_defaults(fn=_airbyte_create_source)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
