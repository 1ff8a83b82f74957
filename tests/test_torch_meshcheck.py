"""The port's mesh verifier (``pathway_tpu_torch/analysis/meshcheck.py``)
against the JAX package's, on the CPU.

The model checker explores the wave/rollback protocol through the port's
own transition table (``pathway_tpu_torch/parallel/protocol.py``). Over
the same configurations both packages' checkers must explore the same
state space — states, transitions, terminals, rollbacks and rescales
explored — and find the same violations, and their CLIs must give the
same exit codes. Pinned beside: the port's runtime, mesh backend and
supervisor drive the very transition objects the checker explores.
"""

from __future__ import annotations

import json

import pytest

from pathway_tpu.analysis import knobs as jknobs
from pathway_tpu.analysis import meshcheck as jmc
from pathway_tpu_torch.analysis import knobs as tknobs
from pathway_tpu_torch.analysis import meshcheck as tmc
from pathway_tpu_torch.parallel import protocol as tproto


@pytest.fixture(autouse=True)
def _fresh():
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw

    for pw in (jpw, tpw):
        pw.internals.parse_graph.G.clear()
    for knobs in (jknobs, tknobs):
        knobs._checked = None
    yield
    for pw in (jpw, tpw):
        pw.internals.parse_graph.G.clear()
    for knobs in (jknobs, tknobs):
        knobs._checked = None


def _counts(rep) -> dict:
    d = rep.to_dict()
    d.pop("schema")
    return d


CONFIGS = {
    "smoke_3rank": dict(world=3, rounds=2, fault_budget=1),
    "faultfree_2rank": dict(world=2, rounds=1, fault_budget=0, straggler=False),
    "faultfree_4rank": dict(world=4, rounds=1, fault_budget=0, straggler=False),
    "state_cap": dict(world=3, rounds=2, fault_budget=1, max_states=50),
    "skip_quiesce": dict(world=3, rounds=2, fault_budget=1, mutate="skip_quiesce"),
    "skip_quiesce_no_fault": dict(world=3, rounds=1, fault_budget=0,
                                  straggler=False, mutate="skip_quiesce"),
    "accept_dead_epoch": dict(world=3, rounds=2, fault_budget=1,
                              mutate="accept_dead_epoch"),
    "drop_rollback_retraction": dict(world=3, rounds=2, fault_budget=1,
                                     mutate="drop_rollback_retraction"),
    "tree_gather_4rank": dict(world=4, rounds=1, fault_budget=1, tree_knob="2"),
    "drop_relay_4rank": dict(world=4, rounds=1, fault_budget=1, tree_knob="2",
                             mutate="drop_relay"),
    "rescale_grow": dict(world=2, rounds=2, fault_budget=1, rescale_to=3,
                         snap_every=1),
    "rescale_shrink": dict(world=3, rounds=2, fault_budget=1, rescale_to=2,
                           snap_every=1),
    "reshard_mutant": dict(world=2, rounds=2, fault_budget=1, rescale_to=3,
                           snap_every=1, mutate="drop_reshard_shard"),
    "sink_2rank": dict(world=2, rounds=1, fault_budget=1, sink=True,
                       fault_phases=tmc.SINK_FAULT_PHASES),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_checker_matches_the_jax_package(name):
    kw = CONFIGS[name]
    jkw = dict(kw)
    if "fault_phases" in jkw:
        assert tuple(jkw["fault_phases"]) == tuple(jmc.SINK_FAULT_PHASES)
        jkw["fault_phases"] = jmc.SINK_FAULT_PHASES
    t = tmc.check(tmc.MeshCheckConfig(**kw))
    j = jmc.check(jmc.MeshCheckConfig(**jkw))
    assert _counts(t) == _counts(j)
    assert t.to_dict().get("schema") == "pathway_tpu_torch.meshcheck/v1"
    assert [v.kind for v in t.violations] == [v.kind for v in j.violations]
    assert [v.fault_plan() for v in t.violations] == [
        v.fault_plan() for v in j.violations]
    if kw.get("mutate"):
        assert t.violations, f"mutant {kw['mutate']} not caught"
    elif name == "state_cap":
        assert not t.complete and not t.ok
    else:
        assert t.complete and t.ok, t.render()


def test_smoke_is_exhaustive_and_not_vacuous():
    rep = tmc.check(tmc.MeshCheckConfig(world=3, rounds=2, fault_budget=1))
    assert rep.complete and rep.ok
    assert rep.states > 100 and rep.transitions > rep.states
    assert rep.terminals > 1 and rep.rollbacks_explored > 0
    again = tmc.check(tmc.MeshCheckConfig(world=3, rounds=2, fault_budget=1))
    assert (again.states, again.transitions, again.terminals) == (
        rep.states, rep.transitions, rep.terminals)


@pytest.mark.parametrize("world,target", [(2, 3), (3, 2)])
def test_rescale_explores_the_rescale_window(world, target):
    rep = tmc.check(tmc.MeshCheckConfig(world=world, rounds=2, fault_budget=1,
                                        rescale_to=target, snap_every=1))
    assert rep.complete and rep.ok, rep.render()
    assert rep.rescales_explored > 0 and rep.rollbacks_explored > 0
    assert rep.to_dict()["rescale_to"] == target


@pytest.mark.parametrize("mutant", [
    "skip_quiesce", "accept_dead_epoch", "drop_rollback_retraction"])
def test_mutant_trace_replays_as_fault_rules(mutant):
    from pathway_tpu_torch.internals import faults

    rep = tmc.check(tmc.MeshCheckConfig(world=3, rounds=2, fault_budget=1,
                                        mutate=mutant))
    v = rep.violations[0]
    assert v.trace
    plan = v.fault_plan()
    if mutant != "skip_quiesce":
        assert plan is not None
    if plan is not None:
        rules = faults.FaultPlan.from_spec(plan).rules
        assert rules and all(r.point == "mesh.rank_kill" and r.action == "crash"
                             for r in rules)


def test_unknown_mutant_rejected():
    with pytest.raises(ValueError, match="unknown mutant"):
        tmc.get_transitions("made_up")


# -- one transition table ----------------------------------------------------

def test_engine_modules_drive_the_checked_protocol():
    import pathway_tpu_torch.engine.runtime as rt
    import pathway_tpu_torch.parallel.procgroup as pg
    import pathway_tpu_torch.parallel.supervisor as sup

    assert rt._proto is pg._proto is sup._proto is tmc._proto is tproto
    t = tmc.Transitions()
    for name in tmc.Transitions.NAMES:
        assert getattr(t, name) is tproto.TRANSITIONS[name] is getattr(tproto, name)
    assert tmc.Transitions.NAMES == jmc.Transitions.NAMES


def test_topology_extraction_matches_the_jax_package():
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw

    topos = {}
    for name, pw, mc in (("jax", jpw, jmc), ("torch", tpw, tmc)):
        config = __import__(pw.__name__ + ".internals.config", fromlist=["x"])
        runtime_mod = __import__(pw.__name__ + ".engine.runtime", fromlist=["x"])
        runner = __import__(pw.__name__ + ".internals.graph_runner", fromlist=["x"])
        t = pw.debug.table_from_rows(pw.schema_from_types(data=str), [("a",), ("b",)])
        counts = t.groupby(pw.this.data).reduce(word=pw.this.data, c=pw.reducers.count())
        pw.io.subscribe(counts, on_change=lambda *a: None)
        g = pw.internals.parse_graph.G
        token = config.push_config_overlay(processes=3, process_id=0)
        try:
            runtime = runtime_mod.Runtime(validate_env=False)
            runner.GraphRunner(g)._lower(
                g.reachable_operators(g.output_operators()), runtime)
        finally:
            config.pop_config_overlay(token)
            g.clear()
        topos[name] = [(x.idx, x.mode, tuple(x.upstream))
                       for x in mc.topology_from_runtime(runtime)]
    assert topos["torch"] == topos["jax"]
    assert topos["torch"] and {m for _, m, _ in topos["torch"]} <= {
        "hash", "gather", "broadcast"}


# -- the CLI -----------------------------------------------------------------

CLI_CASES = {
    "mesh": (["--mesh", "--processes", "3", "--mesh-rounds", "1"], 0),
    "mesh_mutant": (["--mesh", "--processes", "3", "--mesh-rounds", "1",
                     "--mesh-mutant", "skip_quiesce", "--json"], 2),
    "rescale": (["--mesh", "--rescale", "--processes", "2", "--mesh-rounds", "1"], 0),
    "rescale_mutant": (["--mesh", "--rescale", "--processes", "2",
                        "--mesh-rounds", "1", "--mesh-mutant",
                        "drop_reshard_shard"], 2),
    "serve": (["--serve", "--serve-requests", "2"], 0),
    "serve_mutant": (["--serve", "--serve-requests", "2", "--serve-mutant",
                      "replay_committed_window"], 2),
    "pace": (["--pace", "--pace-rows", "2"], 0),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_exit_codes_match_the_jax_package(case, capsys):
    from pathway_tpu.analysis.__main__ import main as jmain
    from pathway_tpu_torch.analysis.__main__ import main as tmain

    args, rc = CLI_CASES[case]
    assert tmain(args) == rc
    tout = capsys.readouterr().out
    assert jmain(args) == rc
    jout = capsys.readouterr().out
    if "--json" in args:
        t, j = json.loads(tout), json.loads(jout)
        assert t.pop("schema") == "pathway_tpu_torch.meshcheck/v1"
        j.pop("schema")
        assert t == j and t["violations"]
    elif case == "mesh":
        assert "explored" in tout and "no deadlock" in tout
