"""The controls of a cell's check: the plain reference put in the
program's place, one precision step below the configuration's, judged by
the cell's own comparison at the cell's own size; and, for the search,
the program itself on its own one-pass TF32 path.

    python3 -m rag_bench.control --workload msmarco-serve --seeds 11,12,13
    python3 -m rag_bench.control --workload msmarco-serve --seeds 11 \
        --program-precision default

The configuration states bfloat16 activations, float32 index rows and
float32 ("highest") search scores. Control ``fp8_tf32`` computes the
encoder with every matrix product's operands in float8 e4m3
(``reference/bert.py`` ``fp8``) and the search with TF32 operands, the
index's rows rounded to TF32 (``reference/knn.py``); ``tf32_search``
(serve cells) keeps the float32 encoder and searches in TF32, so only
the check of the search alone can tell it apart. Each answers the same
seeded sample the harness checks: for ``serve``, the sampled requests of
the window's schedule at the traffic's rate (``--seconds`` long); for
``ingest``, the sample of the first ``--batches`` batches. One JSON line
a seed and control with each number the cell compares, and its limit; a
control that reads within every limit on some seed means the check
cannot tell that step apart. These import nothing of the program.

``--program-precision default`` runs the cell through the harness, the
program and its check in full, with the index's search switched to the
port's one-pass TF32 path, and prints each run's result line: its
``correct`` has to read false.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def serve_readings(cfg, tr, seed, seconds, dev, mode):
    """{control: readings} of the serve cell's two controls on the sampled
    requests: ``fp8_tf32``, float8 encoder products and TF32 search, and
    ``tf32_search``, the float32 reference encoder with TF32 search, which
    only the search check can tell from the program. Each control's own
    query embeddings stand for the program's in that check."""
    from rag_bench import weights
    from rag_bench.reference import bert, knn
    from rag_bench.reference.tokenizer import ReferenceTokenizer

    dep = cfg["deployment"]
    texts, _, words = mode.schedule(cfg, tr, seed, seconds)
    idx = mode.sample(len(texts), words, seed, tr["check"]["sample"], tr["check"]["longest"])
    params = weights.state_dict(cfg, seed, dev)
    tok, heads = ReferenceTokenizer(), cfg["num_attention_heads"]
    sub = [texts[i] for i in idx]
    q_ref = bert.encode_texts(params, heads, tok, sub, dev)
    q_ctl = bert.encode_texts(params, heads, tok, sub, dev, mm=bert.fp8)
    got = {}
    for name, q in (("fp8_tf32", q_ctl), ("tf32_search", q_ref)):
        vals, keys, _ = knn.search(q, seed, dep["rows"], dep["k"], tf32=True)
        answers = {i: list(zip(keys[r].tolist(), vals[r].tolist()))
                   for r, i in enumerate(idx)}
        taps = [(q[r], answers[i]) for r, i in enumerate(idx)]
        got[name] = mode.judge(answers, idx, q_ref, seed, dep["rows"], dep["k"], taps)
    return got


def ingest_readings(cfg, tr, seed, batches, dev, mode):
    from rag_bench import corpus, textgen, weights
    from rag_bench.reference import bert, knn
    from rag_bench.reference.tokenizer import ReferenceTokenizer

    pick, texts_of = mode.sample(cfg, tr, seed, batches)
    params = weights.state_dict(cfg, seed, dev)
    tok, heads = ReferenceTokenizer(), cfg["num_attention_heads"]
    sub = [texts_of[p] for p in pick]
    ref = bert.encode_texts(params, heads, tok, sub, dev)
    ctl = bert.encode_texts(params, heads, tok, sub, dev, mm=bert.fp8)
    # the index's rows held one step below their float32: TF32
    dep = cfg["deployment"]
    keys = textgen.seed_rng(seed, 9).choice(dep["rows"], tr["check"]["prefill_sample"],
                                            replace=False)
    gap = 0.0
    for c in corpus.blocks(dep["rows"]):
        inside = keys[(keys >= c * corpus.BLOCK) & (keys < (c + 1) * corpus.BLOCK)]
        if len(inside):
            x = corpus.rows(seed, c, dep["rows"], cfg["hidden_size"], dev)[
                torch.from_numpy(inside - c * corpus.BLOCK).to(dev)]
            gap = max(gap, float((knn.tf32_round(x) - x).abs().max()))
    return {"row_gap": float((ctl - ref).norm(dim=1).max()), "prefill_gap": gap}


def main(argv=None) -> int:
    from rag_bench.run import cell_files, load_by_path, manifest

    ap = argparse.ArgumentParser(prog="python3 -m rag_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--batches", type=int, default=300)
    ap.add_argument("--program-precision", default=None,
                    help="run the cell through the harness with the index's search "
                         "at this precision of the port's own (serve cells)")
    args = ap.parse_args(argv)
    m = manifest()
    files = cell_files(m, args.workload)
    with open(files["config"]) as f:
        cfg = json.load(f)
    with open(files["traffic"]) as f:
        tr = json.load(f)
    seconds = args.seconds or m["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.program_precision:
        return program_control(m, args, cfg, tr, seeds, seconds)
    mode = load_by_path(files["mode"], f"rag_bench_mode_{tr['mode']}")
    dev = torch.device("cuda", 0)
    lim = tr["check"]["limits"]
    for seed in seeds:
        if tr["mode"] == "serve":
            readings = serve_readings(cfg, tr, seed, seconds, dev, mode)
        else:
            readings = {"fp8_tf32": ingest_readings(cfg, tr, seed, args.batches, dev, mode)}
        for name, got in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "control": name,
                              "readings": got,
                              "limits": {k: lim[k] for k in got if k in lim}}), flush=True)
    return 0


def program_control(m, args, cfg, tr, seeds, seconds) -> int:
    """The program as the control: one harness run a seed, in this
    process, with the configuration's search precision switched to the
    port's ``--program-precision`` path; each prints its result line."""
    import time

    from rag_bench import run

    cfg = json.loads(json.dumps(cfg))
    cfg["deployment"]["precision"] = args.program_precision
    dev = torch.device("cuda", 0)
    for seed in seeds:
        ns = run.parse(["--workload", args.workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", "0"])
        rc = run.execute(m, ns, cfg, tr, dev, torch.cuda.get_device_name(0),
                         time.perf_counter())
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
