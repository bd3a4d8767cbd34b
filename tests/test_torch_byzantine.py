"""The port's byzantine adversary (`--nemesis byzantine`) against the JAX
package's, on the CPU.

- The pure parts: `assemble_block`, `classify_wire_diff` and the
  injection gate (over rounds from 0 to several million and next to
  2^31 - 1, nonces and rates of 0, 1, 999 and 1000 permille) against
  JAX's.
- K30's and K31's plain versions (`corrupt_pool_plain`,
  `corrupt_edge_plain`) against JAX's `corrupt_pool` / `corrupt_edge`
  with the programs' own wiring, on seeded random outboxes: S = 1 and
  S = 2, each attack, inactive, the culprit -1 and out of range.
- `ProxyRole.step` with the conviction lanes (K24's and K28's plain
  versions) and the sequencers' steps on E_BYZANTINE NACK lanes (K23,
  K27) against JAX's steps under jit, S = 1 and S = 2, the stall mask on
  and off (`testing.compartment.random_byz_inputs`: equivocating,
  stale-ballot and honest assigns). Every state leaf and outbox field,
  invalid lanes included.
- The plan stream (`next_byz_plan` under targets and `--byz-attacks`)
  against JAX's per seed.
- Short forms of the smoke's runs (5 ms a round) through `core.run` and
  the CLI with `--device cpu`: history.jsonl byte-equal to the JAX
  runner's and the `byzantine` block equal; benign runs carry no block.

Tolerance: exact everywhere (int32 and bool, and the blocks' dicts).

`-m slow` re-derives `chip_smoke.PINNED_BYZANTINE` (the smoke's
`cli_byzantine` runs at full length) and `chip_smoke.
PINNED_BYZANTINE_BENCH` (bench.py's byzantine record at full width),
some twenty minutes on the CPU:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_byzantine.py -m slow
"""

from __future__ import annotations

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu import byzantine as JBZ
from maelstrom_tpu import core as jcore
from maelstrom_tpu.checkers.byzantine import \
    classify_wire_diff as j_classify
from maelstrom_tpu.nemesis import NemesisDecisions as JDecisions
from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import compartment as JC
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.sim import _freeze as j_freeze
from maelstrom_tpu_torch import byzantine as PBZ
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch import core as pcore
from maelstrom_tpu_torch import prng
from maelstrom_tpu_torch.checkers.byzantine import \
    classify_wire_diff as p_classify
from maelstrom_tpu_torch.nemesis import NemesisDecisions as PDecisions
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.testing.compartment import random_byz_inputs
from test_torch_kernels_gpu import compartment_layout, compartment_role
from test_torch_support import (as_numpy, assert_trees_equal,
                                jax_tree_to_numpy)

JROLES = {"sequencers": JC.SequencerRole, "proxies": JC.ProxyRole}
BYZ = {"nemesis": {"byzantine"}}
ATTACKS = ("equivocation", "forged-proof", "stale-ballot")


# --- the pure parts ----------------------------------------------------------

def _blocks():
    conv = [{"rule": "equivocation", "culprit": "n0",
             "evidence": {"count": 5}, "witness": "n2"}]
    forge = [{"rule": "forged-count", "culprit": "n1", "evidence": {}},
             {"rule": "truncated-batch", "culprit": "n1", "evidence": {}}]
    zero = {a: 0 for a in ATTACKS}
    return [
        (conv, {"equivocation": 5, "forged-proof": 0, "stale-ballot": 0}),
        ([], {"equivocation": 5}),
        (conv, zero),
        (forge, {"forged-proof": 2}),
        (forge + conv, {"forged-proof": 2, "equivocation": 1}),
        ([{"rule": "made-up", "culprit": "n3", "evidence": {}}], zero),
        ([], {}),
        ([{"rule": "stale-ballot", "culprit": "n0", "evidence": {}}],
         {"stale-ballot": 9, "equivocation": 3}),
    ]


@pytest.mark.parametrize("i", range(len(_blocks())))
def test_assemble_block_matches_jax(i):
    conv, inj = _blocks()[i]
    assert PBZ.assemble_block(conv, inj) == JBZ.assemble_block(conv, inj)
    assert PBZ.RULE_ATTACK == JBZ.RULE_ATTACK
    assert PBZ.ATTACKS == JBZ.ATTACKS
    assert PBZ.PROOF_FIELDS == JBZ.PROOF_FIELDS
    assert PBZ.conviction("r", "n1", {"k": 1}, witness="n2") \
        == JBZ.conviction("r", "n1", {"k": 1}, witness="n2")


@pytest.mark.parametrize("sent,received,prior", [
    ({"type": "assign", "slot": 7}, {"type": "assign", "slot": 3},
     [{"type": "assign", "slot": 3}]),
    ({"lo": 4, "n": 3}, {"lo": 5, "n": 4}, []),
    ({"type": "assign", "slot": 7}, {"type": "assign", "slot": 9}, []),
    ({"lo": 4, "proof": 1}, {"lo": 4, "proof": 1, "extra": 2}, []),
    ({}, {}, []),
])
def test_classify_wire_diff_matches_jax(sent, received, prior):
    assert p_classify(sent, received, prior) == \
        j_classify(sent, received, prior)


def test_gate_matches_jax_over_rounds_nonces_and_rates():
    """The gate's int32 wrap of round * -1640531535 + delta: rounds from
    0 to several million and next to 2^31 - 1, rates 0, 1, 999 and 1000
    permille, active and not."""
    rounds = np.concatenate([np.arange(0, 3000), np.arange(0, 9_000_000,
                                                           4099),
                             np.arange(2**31 - 2000, 2**31)]).astype(
        np.int32)
    jgate = jax.jit(lambda b, r: JBZ._gate(b, r))
    for delta in (1, 2, 0x3F, 12345, 0x7FFF):
        for rate in (0, 1, 999, 1000):
            for active in (0, 1):
                jb = {"active": jnp.int32(active), "delta": jnp.int32(delta),
                      "rate_q": jnp.int32(rate)}
                pb = {k: torch.tensor(int(v), dtype=torch.int32)
                      for k, v in jb.items()}
                want = np.asarray(jgate(jb, jnp.asarray(rounds)))
                got = PBZ.gate_plain(pb, torch.tensor(rounds)).numpy()
                np.testing.assert_array_equal(got, want)


def test_carry_and_surgery_match_jax():
    jb, pb = JBZ.init_state(), PBZ.init_state("cpu")
    assert_trees_equal(jax_tree_to_numpy(jb), as_numpy(pb))
    for attack, culprit, delta, rate in (("equivocation", 0, 17, 1.0),
                                         ("stale-ballot", 1, 0x7FFF, 0.25),
                                         ("forged-proof", 3, 1, 0.0)):
        jb = JBZ.start_state(jb, attack, culprit, delta, rate)
        pb2 = PBZ.start_state(pb, attack, culprit, delta, rate)
        assert pb2 is not pb and pb["active"].item() == 0
        pb = pb2
        assert_trees_equal(jax_tree_to_numpy(jb), as_numpy(pb))
        jb, pb = JBZ.stop_state(jb), PBZ.stop_state(pb)
        assert_trees_equal(jax_tree_to_numpy(jb), as_numpy(pb))
    for opts in ({}, BYZ, {"nemesis": "byzantine"},
                 {"nemesis": ["kill", "byzantine"]},
                 {"nemesis_pkg": {"faults": ("kill",)}, **BYZ},
                 {"nemesis_pkg": {"faults": ("byzantine",)}}):
        assert PBZ.byz_enabled(opts) == JBZ.byz_enabled(opts)


# --- K30's and K31's plain versions ------------------------------------------

def _outbox(rng, n, L, msg_type):
    return {"valid": rng.random((n, L)) < 0.8,
            "src": rng.integers(0, n, (n, L)).astype(np.int32),
            "dest": rng.integers(0, n, (n, L)).astype(np.int32),
            "due": np.zeros((n, L), np.int32),
            "mid": rng.integers(0, 1000, (n, L)).astype(np.int32),
            "reply_to": np.full((n, L), -1, np.int32),
            "type": np.where(rng.random((n, L)) < 0.6, msg_type,
                             rng.integers(0, 45, (n, L))).astype(np.int32),
            "a": rng.integers(-2**31, 2**31 - 1, (n, L)).astype(np.int32),
            "b": rng.integers(-2**31, 2**31 - 1, (n, L)).astype(np.int32),
            "c": rng.integers(-2**31, 2**31 - 1, (n, L)).astype(np.int32)}


def _carries(rng, attack, culprit, active):
    delta = int(rng.integers(1, 0x8000))
    inj = rng.integers(0, 1 << 20, 3).astype(np.int32)
    j = {"active": jnp.int32(active), "attack": jnp.int32(attack),
         "culprit": jnp.int32(culprit), "delta": jnp.int32(delta),
         "rate_q": jnp.int32(1000), "injected": jnp.asarray(inj)}
    p = {k: torch.tensor(np.asarray(v)) for k, v in j.items()}
    return j, p


@pytest.mark.parametrize("surface", ["comp-s1", "comp-s2", "batched"])
def test_corrupt_plain_matches_jax(surface):
    """corrupt_pool / corrupt_edge's plain versions with the programs' own
    wiring against JAX's, at rounds of both parities: every attack (the
    ones a surface does not wire inject nothing), inactive, the culprit
    -1 and past the rows."""
    if surface == "batched":
        nodes = [f"n{i}" for i in range(5)]
        opts = {**BYZ, "node_count": 5}
        jprog = j_get_program("broadcast-batched", opts, nodes)
        pprog = p_get_program("broadcast-batched", opts, nodes,
                              device="cpu")
        jfn, pfn, msg_type = JBZ.corrupt_edge, PBZ.corrupt_edge, 21
    else:
        roles = ("proxies=2,acceptors=1x2,replicas=1" if surface == "comp-s1"
                 else "sequencers=2,proxies=2,acceptors=1x2,replicas=1")
        opts = {**BYZ, "roles": roles, "rate": 20.0, "time_limit": 3.0}
        n = JC.roles_node_count(roles)
        nodes = [f"n{i}" for i in range(n)]
        jprog = j_get_program("compartment", opts, nodes)
        pprog = p_get_program("compartment", opts, nodes, device="cpu")
        jfn, pfn, msg_type = JBZ.corrupt_pool, PBZ.corrupt_pool, 30
    n = len(nodes)
    rng = np.random.default_rng(len(surface))
    jfn_jit = jax.jit(lambda b, o, r: jfn(jprog, b, o, r))
    hits = 0
    for rnd in (0, 1, 36, 37, 2**31 - 1):
        for attack in range(3):
            for culprit, active in ((0, 1), (1, 1), (n - 1, 1), (-1, 1),
                                    (n, 1), (0, 0)):
                jb, pb = _carries(rng, attack, culprit, active)
                ob = _outbox(rng, n, 40, msg_type)
                jb2, jo = jfn_jit(jb, JT.Msgs(**{
                    k: jnp.asarray(v) for k, v in ob.items()}),
                    jnp.int32(rnd))
                pb2, po = pfn(pprog, pb, convert.msgs_from_numpy(
                    ob, device="cpu"), torch.tensor(rnd, dtype=torch.int32))
                assert_trees_equal(jax_tree_to_numpy(jb2), as_numpy(pb2))
                assert_trees_equal(jax_tree_to_numpy(jo), as_numpy(po))
                hits += int((np.asarray(jb2["injected"])
                             != np.asarray(jb["injected"])).any())
    assert hits > 0


def test_benign_programs_have_no_surface():
    nodes9 = [f"n{i}" for i in range(9)]
    prog = p_get_program("compartment", {}, nodes9, device="cpu")
    assert prog.byz_wire() is None and prog.byz_evidence({}) == []
    assert not any(k.startswith("z_") for k in
                   prog.init_state()["proxies"])
    byz = p_get_program("compartment", BYZ, nodes9, device="cpu")
    assert byz.roles[1][1].outbox_cap == prog.roles[1][1].outbox_cap \
        + byz.lay.K
    bat = p_get_program("broadcast-batched", {}, nodes9[:5], device="cpu")
    assert bat.byz_wire_edge() is None
    assert PBZ.corrupt_pool(prog, None, "outbox", 0) == (None, "outbox")


# --- the role steps with the adversary ---------------------------------------

_S1 = "proxies=2,acceptors=1x2,replicas=1"
_S2 = "sequencers=2,proxies=2,acceptors=1x2,replicas=1"
ROLE_CASES = {
    "proxy-s1": (_S1, {}, "proxies", 2),
    "proxy-s1-wide": ("proxies=8,acceptors=3x5,replicas=3",
                      {"proxy_slots": 40, "compartment_inbox": 16},
                      "proxies", 8),
    "proxy-s2": (_S2, {}, "proxies", 2),
    "proxy-s3-wide": ("sequencers=3,proxies=6,acceptors=3x5,replicas=3",
                      {"proxy_slots": 40, "compartment_inbox": 16},
                      "proxies", 6),
    "seq-s1": (_S1, {}, "sequencers", 1),
    "seq-s2": (_S2, {"election_timeout_rounds": 40}, "sequencers", 2),
}


@pytest.mark.parametrize("case", list(ROLE_CASES))
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_byz_role_steps_match_jax(case, stalled):
    roles, opts, role, n = ROLE_CASES[case]
    rnd = {False: 37, True: 1 << 20}[stalled]
    lay = compartment_layout(roles, rate=20.0, time_limit=2.0, **opts)
    jlay = JC.Layout({"roles": roles, "rate": 20.0, "time_limit": 2.0,
                      **opts}, lay.n_nodes)
    rng = np.random.default_rng(n * 19 + len(case) + int(stalled))
    inbox, state = random_byz_inputs(rng, role, lay, n, rnd)
    stall = rng.random(n) < 0.4
    jprog = JROLES[role](BYZ, [f"n{i}" for i in range(n)], jlay)
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    jkey, pkey = jax.random.PRNGKey(n + rnd), prng.PRNGKey(n + rnd, "cpu")
    jnew, jout = jax.jit(lambda s_, m_, r_: jprog.step(s_, m_, {
        "round": r_, "key": jkey}))(jst, JT.Msgs(**{
            k: jnp.asarray(v) for k, v in inbox.items()}), jnp.int32(rnd))
    ctx = {"round": torch.tensor(rnd, dtype=torch.int32), "key": pkey}
    if stalled:
        st = jnp.asarray(stall)
        jnew = j_freeze(st, jst, jnew)
        jout = jout.replace(valid=jout.valid & ~st[:, None])
        ctx["stall"] = torch.tensor(stall)
    pprog = compartment_role(role, lay, n, "cpu", byz=True)
    pnew, pout = pprog.step({k: torch.tensor(v) for k, v in state.items()},
                            convert.msgs_from_numpy(inbox, device="cpu"),
                            ctx)
    assert list(pnew) == list(state)
    assert_trees_equal(jax_tree_to_numpy(jnew), as_numpy(pnew))
    assert_trees_equal(jax_tree_to_numpy(jout), as_numpy(pout))
    assert pprog.outbox_cap == jprog.outbox_cap
    assert list(pprog.init_state()) == list(jprog.init_state())
    assert_trees_equal(jax_tree_to_numpy(jprog.init_state()),
                       as_numpy(pprog.init_state()))
    if role == "proxies" and not stalled:
        # the inputs convicted something, and left honest assigns
        L = pprog.outbox_cap - lay.K
        nack = as_numpy(pout)["valid"][:, L:]
        assert nack.any() and any((np.asarray(pnew[k]) != state[k]).any()
                                  for k in ("z_eq", "z_sb"))


# --- the plan stream ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 13])
@pytest.mark.parametrize("targets,attacks", [
    (None, None),
    ({"byzantine": ["n0"]}, ("equivocation",)),
    ({"byzantine": ["n0", "n1"]}, ("equivocation", "stale-ballot")),
    ({"kill": ["n2"]}, ("forged-proof",)),
])
def test_plan_stream_matches_jax(seed, targets, attacks):
    nodes = [f"n{i}" for i in range(6)]
    j = JDecisions(nodes, seed=seed, targets=targets, attacks=attacks)
    p = PDecisions(nodes, seed=seed, targets=targets, attacks=attacks)
    got = [(p.next_byz_plan(), p.next_kill_targets()) for _ in range(12)]
    assert got == [(j.next_byz_plan(), j.next_kill_targets())
                   for _ in range(12)]


def test_targets_and_attacks_resolve_like_jax():
    from maelstrom_tpu import nemesis as jnem
    from maelstrom_tpu_torch import nemesis as pnem
    nodes7 = [f"n{i}" for i in range(7)]
    prog = p_get_program("compartment", {"roles": _S2}, nodes7,
                         device="cpu")
    for spec in ("byzantine=sequencers", "byzantine=n0",
                 "byzantine=proxies+n5"):
        assert pnem.resolve_targets(spec, prog.fault_groups(), nodes7) \
            == jnem.resolve_targets(spec, prog.fault_groups(), nodes7)
    for raw in ("equivocation", "stale-ballot,forged-proof", "nope"):
        opts = dict(workload="lin-kv", node="tpu:compartment", roles=_S2,
                    nemesis={"byzantine"}, byz_attacks=raw)
        outs = []
        for build in (jcore.build_test, pcore.build_test):
            try:
                outs.append(build(dict(opts))["byz_attacks"])
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]
    pkg = pnem.package({"byzantine", "kill"}, 0.8)
    assert pkg["faults"] == jnem.package({"byzantine", "kill"}, 0.8)["faults"]


# --- runs through core.run and the CLI ---------------------------------------

def _history(root):
    with open(os.path.join(root, "latest", "history.jsonl"), "rb") as f:
        return f.read()


def _both(opts, tmp_path):
    jres = jcore.run({**opts, "store_root": str(tmp_path / "jax"),
                      "no_overlap": True, "audit": False,
                      "audit_trace": False})
    pres = pcore.run({**opts, "store_root": str(tmp_path / "port"),
                      "device": "cpu"})
    return jres, pres, _history(str(tmp_path / "jax")), \
        _history(str(tmp_path / "port"))


def _smoke_runs():
    import chip_smoke
    return dict(chip_smoke.CLI_BYZANTINE)


# the smoke's runs at 5 ms a round: their plans, windows and verdicts at a
# fifth of the rounds
SHORT = ("byz-eq", "byz-eq1", "byz-forge", "byz-armed")


@pytest.mark.parametrize("name", SHORT)
def test_byzantine_runs_match_jax(name, tmp_path):
    opts = {**_smoke_runs()[name], "ms_per_round": 5.0}
    jres, pres, jh, ph = _both(opts, tmp_path)
    assert ph == jh
    assert pres["byzantine"] == jres["byzantine"]
    assert pres["valid"] is jres["valid"]
    assert pres["byzantine"]["valid"] is True
    inj = pres["byzantine"]["injected"]
    if name == "byz-armed":
        assert inj == {a: 0 for a in ATTACKS}
        assert pres["byzantine"]["convictions"] == [] and pres["valid"]
    else:
        assert sum(inj.values()) > 0


def test_cli_runs_the_adversary_like_jax(tmp_path, capsys):
    """`python -m maelstrom_tpu_torch test ... --nemesis byzantine
    --byz-attacks stale-ballot --byz-rate 0.5`, against the JAX runner's
    `core.run` of the same options."""
    args = ["test", "-w", "lin-kv", "--node", "tpu:compartment", "--roles",
            _S2, "--rate", "20", "--time-limit", "1.5", "--seed", "5",
            "--ms-per-round", "5", "--nemesis", "byzantine",
            "--nemesis-interval", "0.4", "--nemesis-targets",
            "byzantine=sequencers", "--byz-attacks", "stale-ballot",
            "--byz-rate", "0.5", "--compartment-retry", "3", "--device",
            "cpu", "--store", str(tmp_path / "port")]
    pcli.main(args)
    opts = dict(workload="lin-kv", node="tpu:compartment", roles=_S2,
                rate=20.0, time_limit=1.5, seed=5, ms_per_round=5.0,
                nemesis={"byzantine"}, nemesis_interval=0.4,
                nemesis_targets="byzantine=sequencers",
                byz_attacks="stale-ballot", byz_rate=0.5,
                compartment_retry=3, journal_rows=True)
    jres = jcore.run({**opts, "store_root": str(tmp_path / "jax"),
                      "no_overlap": True, "audit": False,
                      "audit_trace": False})
    assert _history(str(tmp_path / "port")) == _history(str(tmp_path /
                                                             "jax"))
    with open(os.path.join(tmp_path / "port", "latest",
                           "results.json")) as f:
        pres = json.load(f)
    assert pres["byzantine"] == json.loads(json.dumps(jres["byzantine"]))
    assert 0 < jres["byzantine"]["injected"]["stale-ballot"]


def test_benign_runs_carry_no_block_and_no_carry(tmp_path):
    res = pcore.run(dict(
        store_root=str(tmp_path), seed=7, workload="lin-kv",
        node="tpu:compartment", rate=20.0, time_limit=0.5, ms_per_round=5.0,
        journal_rows=False, nemesis={"kill", "partition"},
        nemesis_interval=0.2, device="cpu"))
    assert "byzantine" not in res
    from maelstrom_tpu_torch.sim import make_sim
    prog = p_get_program("compartment", {}, [f"n{i}" for i in range(9)],
                         device="cpu")
    sim = make_sim(prog, PT.NetConfig(n_nodes=9), device="cpu")
    assert sim.byz is None


def test_the_cluster_axis_refuses_the_adversary():
    from maelstrom_tpu_torch import parallel
    prog = p_get_program("lin-kv", {}, [f"n{i}" for i in range(5)],
                         device="cpu")
    with pytest.raises(NotImplementedError,
                       match="does not compose with --fleet"):
        parallel.make_cluster_round_fn(
            prog, PT.NetConfig(n_nodes=5, enable_byz=True), device="cpu")


# --- the smoke's pins (slow) ------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", list(_smoke_runs()))
def test_pinned_byzantine_runs(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_BYZANTINE: the sha256 of the JAX
    runner's history.jsonl and its `byzantine` block for each
    cli_byzantine run at full length, and holds the port's run on the CPU
    to them."""
    import chip_smoke
    jres, pres, jh, ph = _both(_smoke_runs()[name], tmp_path)
    pin = chip_smoke.PINNED_BYZANTINE[name]
    assert hashlib.sha256(jh).hexdigest() == pin["history"]
    assert jres["byzantine"] == pin["byzantine"]
    assert ph == jh and pres["byzantine"] == jres["byzantine"]


@pytest.mark.slow
def test_pinned_byzantine_bench():
    """Re-derives chip_smoke.py's PINNED_BYZANTINE_BENCH from bench.py's
    `bench_byzantine_record` (the JAX runner at full width on the CPU)
    and holds the port's `bench --byzantine` record to it."""
    import importlib.util

    import chip_smoke
    from maelstrom_tpu_torch import bench as pbench
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(root, "bench.py"))
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    jrec = jbench.bench_byzantine_record()
    keys = chip_smoke.BYZ_BENCH_PIN_KEYS
    assert jrec["valid"] is True
    assert {k: jrec[k] for k in keys} == chip_smoke.PINNED_BYZANTINE_BENCH
    prec, rc = pbench.main_byzantine(device="cpu")
    assert rc == 0 and prec["valid"] is True
    assert {k: prec[k] for k in keys} == chip_smoke.PINNED_BYZANTINE_BENCH
