"""The port's compartment with a stable leader (`--node tpu:compartment`,
one sequencer) against the JAX package's, on the CPU.

- The host half: `parse_roles`, `roles_node_count` and every `Layout`
  validation (the elected configuration's too), with JAX's messages.
- The table helpers (`_alloc_rows`, `_put_rows`, `_first_per_key`,
  `_match_rows`) on seeded random inputs with ties, duplicates, full and
  empty tables.
- The role steps: the plain versions of K23 (`SequencerRole`), K24
  (`ProxyRole`), K25 (`AcceptorRole`) and K26 (`ReplicaRole`) against
  JAX's `step` on random inboxes (`maelstrom_tpu_torch.testing.
  compartment.random_compartment_inputs`: every lane type, slots repeated and past
  the log, full and empty tables, INT32_MAX words, keys past the row),
  at the CLI's shapes and at K 16 / QL 128, with the stall mask on and
  off (JAX's freeze and output mask after the step). Tolerance: exact,
  on every state leaf and every outbox field, invalid lanes included.
- A 9-node cluster's rounds through the pool-path round under loss and
  a proxy kill, then the proxy's restart from the durable store: every
  `SimState` leaf (the key included) and `NetStats` counter equal.
- lin-kv through `core.run`, byte-equal to the JAX runner's history
  (the role-targeted kill and partition with the ring on, the leader's
  shed), and `--ordering compartment` for lin-kv and kafka; the
  refusals (the byzantine adversary, and the options of later slices
  beside the election's) naming what brings each.

`-m slow` re-derives `chip_smoke.PINNED_COMPARTMENT` (the full-length
runs of the smoke's `cli_compartment` phase) and the bench's ok ops
(`chip_smoke.PINNED_COMPARTMENT_BENCH`, the sweep at full width), some
five minutes on the CPU:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_compartment.py -m slow
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

from maelstrom_tpu import core as jcore
from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import compartment as JC
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.sim import _freeze as j_freeze
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch import core as pcore
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import compartment as PC
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.sim import make_run_fn as p_make_run_fn
from maelstrom_tpu_torch.testing.compartment import \
    random_compartment_inputs
from test_torch_kernels_gpu import (COMPARTMENT_CASES, compartment_layout,
                                    compartment_role)
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

JROLES = {"sequencers": JC.SequencerRole, "proxies": JC.ProxyRole,
          "acceptors": JC.GridAcceptors, "replicas": JC.ReplicaRole}
NODES9 = [f"n{i}" for i in range(9)]


# --- the host half ------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    None, "", "proxies=4,acceptors=2x3,replicas=2", "acceptors=3",
    "sequencers=3,acceptors=3", " proxies = 8 , acceptors=1x1,",
    "proxies=1,acceptors=1x2,replicas=1"])
def test_parse_roles_matches_jax(spec):
    assert PC.parse_roles(spec) == JC.parse_roles(spec)
    assert PC.roles_node_count(spec) == JC.roles_node_count(spec)


@pytest.mark.parametrize("spec", [
    "leaders=2", "proxies=0", "proxies", "proxies=", "acceptors=2x0",
    "replicas=-1", "proxies=x"])
def test_parse_roles_refusals_match_jax(spec):
    msgs = []
    for mod in (JC, PC):
        with pytest.raises(ValueError) as e:
            mod.parse_roles(spec)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("opts,n", [
    ({}, 7), ({"log_cap": 40_000}, 9), ({"kv_keys": 5000}, 9),
    ({"concurrency": 40_000}, 9),
    ({"roles": "sequencers=2,acceptors=2x2", "log_cap": 5000}, 10),
    ({"roles": "sequencers=2", "concurrency": 5000}, 10),
    ({"roles": "sequencers=2", "ballot_width": 7}, 10),
    ({"roles": "sequencers=2,acceptors=31"}, 36),
    ({"roles": "sequencers=4", "ballot_width": 2}, 12),
    ({"roles": "sequencers=2", "election_timeout_rounds": 19}, 10)])
def test_layout_refusals_match_jax(opts, n):
    msgs = []
    for mod in (JC, PC):
        with pytest.raises(ValueError) as e:
            mod.Layout({"rate": 5, "time_limit": 1, **opts}, n)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("opts", [
    {"roles": "proxies=4,acceptors=2x3,replicas=3", "rate": 200.0,
     "time_limit": 3.0, "concurrency": 16},
    {"leader_slots": 128, "proxy_slots": 8, "compartment_inbox": 16,
     "kv_keys": 1024, "compartment_retry": 4, "log_cap": 700},
    {"roles": "sequencers=3,acceptors=3", "ballot_width": 4}])
def test_layout_matches_jax(opts):
    n = JC.roles_node_count(opts.get("roles"))
    jl, pl = JC.Layout(opts, n), PC.Layout(opts, n)
    assert vars(pl) == vars(jl)


def test_roles_size_the_cluster_and_fault_groups():
    opts = {"node": "tpu:compartment",
            "roles": "proxies=1,acceptors=1x2,replicas=1"}
    assert pcore.parse_nodes(opts) == jcore.parse_nodes(opts) == [
        f"n{i}" for i in range(5)]
    assert len(pcore.parse_nodes({"node": "tpu:compartment"})) == 9
    ordered = {"node": "tpu:ordered", "ordering": "compartment",
               "roles": "proxies=3"}
    assert pcore.parse_nodes(ordered) == jcore.parse_nodes(ordered)
    for mod, get in ((JC, j_get_program), (PC, p_get_program)):
        with pytest.raises(ValueError, match="needs 9 nodes"):
            kw = {} if mod is JC else {"device": "cpu"}
            get("compartment", {"rate": 5, "time_limit": 1},
                [f"n{i}" for i in range(7)], **kw)
    opts = {"rate": 5, "time_limit": 1}
    jg = j_get_program("compartment", opts, NODES9).fault_groups()
    pprog = p_get_program("compartment", opts, NODES9, device="cpu")
    assert pprog.fault_groups() == jg
    assert jg["acceptor-col-0"] == ["n3", "n5"]
    assert pprog.dynamic_fault_groups() == ("sequencer",)
    assert pprog.node_for_op({"f": "read", "value": [1, None]}) == 0
    assert pprog.current_leader_host(None) == 0
    assert pprog.election_report(None) is None
    assert pprog.inbox_cap == 8 and pprog.outbox_cap == 40


def test_decode_and_redirect_hooks_match_jax():
    opts = {"rate": 5, "time_limit": 1}
    jp = j_get_program("compartment", opts, NODES9)
    pp = p_get_program("compartment", opts, NODES9, device="cpu")
    for words in ((1, 31, 0, 0), (1, 31, -1, 0), (1, 32, 7, 2),
                  (1, 11, 0, 0), (11, 4, 0, 0), (13, 0, 0, 0),
                  (15, 0, 0, 0)):
        jb, pb = jp.decode_body(*words, None), pp.decode_body(*words, None)
        assert pb == jb
        assert pp.redirect_hint(pb) == jp.redirect_hint(jb)
    assert pp.next_probe(0) == jp.next_probe(0) == 0
    pp.note_timeout(0)
    pp.note_leader(3)
    assert pp.node_for_op({}) == 0


# --- the table helpers ------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_table_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, Q, K_ = 6, 9, 12
    occ = rng.random((n, Q)) < rng.choice([0.0, 0.5, 1.0], (n, 1))
    want = rng.random((n, K_)) < 0.6
    jok, jrow = JC._alloc_rows(jnp.asarray(occ), jnp.asarray(want))
    pok, prow = PC._alloc_rows(torch.tensor(occ), torch.tensor(want))
    np.testing.assert_array_equal(np.asarray(jok), pok.numpy())
    ok = np.asarray(jok)
    np.testing.assert_array_equal(np.asarray(jrow)[ok], prow.numpy()[ok])
    dst = rng.integers(-5, 5, (n, Q)).astype(np.int32)
    val = rng.integers(100, 200, (n, K_)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(JC._put_rows(jnp.asarray(dst), jok, jrow,
                                jnp.asarray(val))),
        PC._put_rows(torch.tensor(dst), pok, prow,
                     torch.tensor(val)).numpy())
    key = rng.integers(0, 4, (n, K_)).astype(np.int32)
    valid = rng.random((n, K_)) < 0.7
    np.testing.assert_array_equal(
        np.asarray(JC._first_per_key(jnp.asarray(valid), jnp.asarray(key))),
        PC._first_per_key(torch.tensor(valid), torch.tensor(key)).numpy())
    slots = rng.integers(0, 4, (n, Q)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(JC._match_rows(jnp.asarray(occ), jnp.asarray(slots),
                                  jnp.asarray(valid), jnp.asarray(key))),
        PC._match_rows(torch.tensor(occ), torch.tensor(slots),
                       torch.tensor(valid), torch.tensor(key)).numpy())
    cmd = rng.integers(-2**31, 2**31 - 1, 64, dtype=np.int64).astype(
        np.int32)
    for j, p in zip(JC._unpack_cmd(jnp.asarray(cmd)),
                    PC._unpack_cmd(torch.tensor(cmd))):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())


# --- the role steps (K23-K26's plain versions) ------------------------------

@pytest.mark.parametrize("case", list(COMPARTMENT_CASES))
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_role_steps_match_jax(case, stalled):
    roles, opts, role, n = COMPARTMENT_CASES[case]
    rnd = {False: 37, True: 1 << 20}[stalled] if "cli" in case else 0
    lay = compartment_layout(roles, rate=20.0, time_limit=2.0, **opts)
    jlay = JC.Layout({"roles": roles, "rate": 20.0, "time_limit": 2.0,
                      **opts}, lay.n_nodes)
    rng = np.random.default_rng(n * 13 + len(case) + int(stalled))
    inbox, state = random_compartment_inputs(rng, role, lay, n, rnd)
    stall = rng.random(n) < 0.4
    jprog = JROLES[role]({}, [f"n{i}" for i in range(n)], jlay)
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    # one XLA program a case (op by op, JAX compiles every op's shape)
    jnew, jout = jax.jit(lambda s_, m_, r_: jprog.step(s_, m_, {
        "round": r_}))(jst, JT.Msgs(**{
            k: jnp.asarray(v) for k, v in inbox.items()}), jnp.int32(rnd))
    ctx = {"round": torch.tensor(rnd, dtype=torch.int32)}
    if stalled:
        st = jnp.asarray(stall)
        jnew = j_freeze(st, jst, jnew)
        jout = jout.replace(valid=jout.valid & ~st[:, None])
        ctx["stall"] = torch.tensor(stall)
    pprog = compartment_role(role, lay, n, "cpu")
    pnew, pout = pprog.step({k: torch.tensor(v) for k, v in state.items()},
                            convert.msgs_from_numpy(inbox, device="cpu"),
                            ctx)
    assert_trees_equal(jax_tree_to_numpy(jnew), as_numpy(pnew))
    assert_trees_equal(jax_tree_to_numpy(jout), as_numpy(pout))
    got = as_numpy(pout)
    if not stalled:
        assert got["valid"].any()
    # the quiescence planes: JAX's `quiescent` on the same state
    quiet = not any(p.any() for p in pprog.quiet_planes(pnew))
    assert quiet == bool(jprog.quiescent(jnew))


def test_pending_plane_reads_the_clipped_frontier():
    """The replicas' busy plane reads r_has at clip(applied + 1, 0,
    C - 1), with no idx < C test, as JAX's `quiescent` does: a replica
    that applied the last slot stays busy while that slot is stored."""
    lay = compartment_layout("proxies=2,acceptors=2x2,replicas=2",
                             log_cap=8)
    prog = compartment_role("replicas", lay, 2, "cpu")
    jprog = JC.ReplicaRole({}, ["n0", "n1"], JC.Layout(
        {"roles": "proxies=2,acceptors=2x2,replicas=2", "log_cap": 8}, 9))
    st = prog.init_state()
    for applied, has_last, busy in ((7, True, True), (7, False, False),
                                    (-1, False, False), (3, False, False)):
        st["applied"][:] = applied
        st["r_has"][:] = False
        st["r_has"][:, 7] = has_last
        (plane,) = prog.quiet_planes(st)
        assert bool(plane.any()) == busy
        jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
        assert bool(jprog.quiescent(jst)) == (not busy)


# --- the cluster's rounds ----------------------------------------------------

def _comp_plan(n, R, M, seed, clients=6):
    """M client requests a round to the sequencer: reads, writes and cas
    over four keys, values that hit and miss."""
    rng = np.random.default_rng(seed)
    return {"valid": rng.random((R, M)) < 0.6,
            "src": (n + rng.integers(0, clients, (R, M))).astype(np.int32),
            "dest": np.zeros((R, M), np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": rng.integers(0, 1 << 20, (R, M)).astype(np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": rng.choice(np.array([10, 12, 14], np.int32), (R, M)),
            "a": rng.integers(0, 4, (R, M), dtype=np.int32),
            "b": rng.integers(0, 4, (R, M), dtype=np.int32),
            "c": rng.integers(0, 4, (R, M), dtype=np.int32)}


def test_cluster_rounds_match_jax():
    """40 rounds under 5% loss with proxy n1 killed, its restart from the
    durable store (a volatile proxy comes back empty), then 40 more."""
    opts = {"rate": 20.0, "time_limit": 1.0, "compartment_retry": 4}
    jprog = j_get_program("compartment", opts, NODES9)
    pprog = p_get_program("compartment", opts, NODES9, device="cpu")
    kw = dict(n_nodes=9, n_clients=6, pool_cap=1024,
              inbox_cap=jprog.inbox_cap, client_cap=8,
              latency_mean_rounds=1.0, enable_stall=True,
              partition_groups=9)
    jcfg, pcfg = JT.NetConfig(**kw), PT.NetConfig(**kw)
    jsim = j_make_sim(jprog, jcfg, seed=31)
    start = jax_tree_to_numpy(jsim)
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    down = np.zeros(9, bool)
    down[1] = True
    jsim = jsim.replace(net=JT.set_down(JT.flaky(jsim.net, 0.05), down))
    psim = psim.replace(net=PT.set_down(PT.flaky(psim.net, 0.05),
                                        torch.tensor(down)))
    jrun = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)
    prun = p_make_run_fn(pprog, pcfg, collect_client_msgs=True,
                         device="cpu")
    for phase in range(2):
        plan = _comp_plan(9, 40, 3, seed=phase)
        jsim, jmsgs = jrun(jsim, JT.Msgs(**{k: jnp.asarray(v)
                                            for k, v in plan.items()}))
        psim, pmsgs = prun(psim, convert.msgs_from_numpy(plan,
                                                         device="cpu"))
        assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
        assert_msgs_equal_on_valid(jmsgs, pmsgs)
        if phase == 0:
            # the kill's restart: the durable store over a fresh state
            assert bool(np.asarray(jsim.nodes["proxies"]["p_valid"]).any())
            jnodes = jprog.restore(jprog.init_state(), jsim.durable,
                                   jsim.nodes, jnp.asarray(down))
            pnodes = pprog.restore(pprog.init_state(), psim.durable,
                                   psim.nodes, torch.tensor(down))
            assert_trees_equal(jax_tree_to_numpy(jnodes), as_numpy(pnodes))
            assert not pnodes["proxies"]["p_valid"][0].any()
            jsim = jsim.replace(nodes=jnodes, net=JT.set_down(
                jsim.net, np.zeros(9, bool)))
            psim = psim.replace(nodes=pnodes, net=PT.set_down(
                psim.net, torch.zeros(9, dtype=torch.bool)))
    st = PT.stats_dict(psim.net)
    assert st["lost"] > 0 and st["dropped_down"] > 0
    assert int(psim.nodes["replicas"]["applied"].min()) > 0


# --- end to end -----------------------------------------------------------

def _history(store):
    d = os.path.realpath(os.path.join(store, "latest"))
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        return f.read()


def _both(opts, tmp_path):
    jres = jcore.run({**opts, "store_root": str(tmp_path / "jax"),
                      "no_overlap": True, "audit": False,
                      "audit_trace": False})
    pres = pcore.run({**opts, "store_root": str(tmp_path / "port"),
                      "device": "cpu"})
    return jres, pres, _history(str(tmp_path / "jax")), \
        _history(str(tmp_path / "port"))


# tier 1: a second of virtual time at 5 ms a round
COMP_BASE = {"workload": "lin-kv", "node": "tpu:compartment", "seed": 7,
             "rate": 40.0, "time_limit": 1.0, "ms_per_round": 5.0,
             "journal_rows": False}
RUNS = {
    "comp9": dict(COMP_BASE),
    "comp9-targeted": {
        **COMP_BASE, "seed": 11, "time_limit": 0.6,
        "nemesis": {"kill", "partition"},
        "nemesis_interval": 0.2, "recovery_s": 0.2, "timeout_ms": 600,
        "roles": "proxies=4,acceptors=2x2,replicas=2",
        "nemesis_targets": "kill=proxies,partition=acceptor-col-0",
        "telemetry": "auto"},
    "comp9-shed": {**COMP_BASE, "rate": 200.0, "time_limit": 0.3,
                   "ms_per_round": 1.0, "leader_slots": 2,
                   "proxy_slots": 2, "concurrency": 16},
    "linkv-ordered-comp": {**COMP_BASE, "node": None,
                           "ordering": "compartment"},
}


# tier 1 runs the targeted soup and the ordering engine; the plain run and
# the shed repeat what the smoke's full-length pins hold (-m slow)
@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow)
    if n in ("comp9", "comp9-shed") else n for n in RUNS])
def test_compartment_runs_match_jax(name, tmp_path):
    jres, pres, jh, ph = _both(RUNS[name], tmp_path)
    assert ph == jh
    assert pres["valid"] is jres["valid"] is True
    assert pres["workload"] == jres["workload"]
    assert pres["stats"] == jres["stats"]
    assert pres["stats"]["ok-count"] > 5
    assert pres["net"].get("telemetry") == jres["net"].get("telemetry")
    if name == "comp9-shed":
        assert pres["stats"]["fail-count"] > 0
    if "nemesis_targets" in RUNS[name]:
        ops = [json.loads(x) for x in ph.decode().splitlines()]
        kills = [str(o["value"]) for o in ops
                 if o.get("process") == "nemesis" and o["type"] == "info"
                 and str(o["value"]).startswith("killed")]
        assert kills
        proxies = {"n1", "n2", "n3", "n4"}
        for v in kills:
            named = {f"n{i}" for i in range(11) if f"'n{i}'" in v}
            assert named and named <= proxies, v
        assert set(pres["net"]["telemetry"]["role-sent"]) == {
            "sequencers", "proxies", "acceptors", "replicas"}


# --- the refusals -----------------------------------------------------------

BASE = ["test", "-w", "lin-kv", "--node", "tpu:compartment", "--device",
        "cpu"]


@pytest.mark.parametrize("extra,what", [
    (["--roles", "sequencers=2", "--checkpoint-every", "0.5"],
     "checkpoint and resume"),
    # fleets run since the fleet slice, but not of the compartment (a role
    # partition); a mesh names the multi-GPU slice: the cases keep their
    # ids
    pytest.param(["--roles", "sequencers=3,proxies=4", "--mesh", "1,2"],
                 "the multi-GPU slice", id="extra1-mesh and fleet"),
    pytest.param(["--election-timeout-rounds", "90", "--fleet", "2"],
                 "the role partitions", id="extra2-mesh and fleet"),
    # the byzantine cases refused what now runs: they keep their ids and
    # check what stays refused beside the adversary
    pytest.param(["--leader-lease-ms", "5", "--byz-rate", "0.5",
                  "--fleet", "2"], "the role partitions",
                 id="extra3-the byzantine adversary"),
    (["--client-retries", "2", "--check-workers", "2"],
     "the overlap pipeline"),
    pytest.param(["--nemesis", "kill,byzantine", "--checkpoint-every",
                  "0.5"], "checkpoint and resume",
                 id="extra5-the byzantine adversary"),
    (["--ordering", "compartment", "--roles", "sequencers=2",
      "--resume", "x"], "checkpoint and resume")])
def test_cli_refusals_name_their_slice(extra, what, tmp_path, capsys):
    args = BASE + ["--store", str(tmp_path)] + extra
    if "--ordering" in extra:
        args.remove("--node")
        args.remove("tpu:compartment")
    assert pcli.main(args) == 2
    err = capsys.readouterr().err
    assert what in err and "does not run it yet" in err
    assert not os.listdir(tmp_path)


def test_cli_lifts_the_stable_leader_options():
    args = pcli.build_parser().parse_args(
        BASE + ["--roles", "proxies=4,acceptors=2x2,replicas=2",
                "--compartment-retry", "6", "--ballot-width", "4",
                "--nemesis", "kill,partition", "--nemesis-targets",
                "kill=proxies,partition=acceptor-col-0"])
    opts = pcli.opts_from_args(args)
    assert opts["roles"] == "proxies=4,acceptors=2x2,replicas=2"
    assert opts["compartment_retry"] == 6 and opts["ballot_width"] == 4
    ordered = pcli.opts_from_args(pcli.build_parser().parse_args(
        ["test", "-w", "kafka", "--ordering", "compartment", "--roles",
         "proxies=3"]))
    assert ordered["node"] == "tpu:ordered"
    with pytest.raises(pcli.ScopeError, match="tpu:compartment"):
        pcli.check_scope(pcli.build_parser().parse_args(
            ["test", "-w", "echo", "--node", "tpu:compartment"]))


def test_program_refuses_an_elected_tier_and_the_adversary():
    # an elected tier runs since the election slice, the adversary since
    # the byzantine slice (the proxies then carry the evidence leaves);
    # only a layout the JAX package refuses is refused, in its words
    prog = p_get_program("compartment", {"roles": "sequencers=2"},
                         [f"n{i}" for i in range(10)], device="cpu")
    assert prog.lay.S == 2 and prog.quiet_planes is None
    byz = p_get_program("compartment", {"nemesis": {"byzantine"}}, NODES9,
                        device="cpu")
    assert byz.byz and "z_eq" in byz.init_state()["proxies"]
    # the JAX layout's own refusals come first, word for word
    with pytest.raises(ValueError, match="ballot_width must be"):
        p_get_program("compartment", {"roles": "sequencers=2",
                                      "ballot_width": 9},
                      [f"n{i}" for i in range(10)], device="cpu")


# --- the bench record ------------------------------------------------------

def test_bench_record_keys_and_gate(monkeypatch):
    """bench --compartment's record over canned runs: bench.py's keys,
    the sweep's options and env overrides, `scaling_1_to_4` and the
    exit-1 gate (an invalid point, or 4 proxies under twice one's ok
    ops)."""
    from maelstrom_tpu_torch import bench as pbench
    from maelstrom_tpu_torch import core as pc
    seen = []
    ok_by_p = {1: 100, 2: 190, 4: 390}
    invalid = set()

    def fake_run(opts):
        seen.append(opts)
        p = int(opts["roles"].split(",")[0].split("=")[1])
        return {"valid": p not in invalid,
                "stats": {"ok-count": ok_by_p[p], "fail-count": 7}}
    monkeypatch.setattr(pc, "run", fake_run)
    monkeypatch.setenv("BENCH_COMPARTMENT_PROXIES", "1,2,4")
    monkeypatch.setenv("BENCH_COMPARTMENT_TIME_LIMIT", "0.5")
    rec, rc = pbench.main_compartment(device="cpu")
    assert rc == 0 and rec["valid"] is True
    assert rec["metric"] == "compartment_client_ops_per_vsec"
    assert rec["value"] == 780.0 and rec["unit"] == "client-ops/vsec"
    assert rec["scaling_1_to_4"] == 3.9
    assert (rec["offered_rate"], rec["time_limit_s"],
            rec["concurrency"]) == (8000.0, 0.5, 96)
    assert set(rec["proxies"][0]) == {
        "proxies", "ok_ops", "ops_per_vsec", "wall_s", "ops_per_wall_sec",
        "predicted", "failed_ops", "valid"}
    assert rec["proxies"][0]["predicted"] is None
    assert seen[2]["roles"] == "proxies=4,acceptors=2x2,replicas=2"
    assert {k: seen[0][k] for k in ("leader_slots", "proxy_slots",
                                    "compartment_inbox", "kv_keys",
                                    "timeout_ms", "seed")} == {
        "leader_slots": 128, "proxy_slots": 8, "compartment_inbox": 16,
        "kv_keys": 1024, "timeout_ms": 20000, "seed": 11}
    ok_by_p[4] = 150
    assert pbench.main_compartment(device="cpu")[1] == 1
    ok_by_p[4] = 390
    invalid.add(2)
    assert pbench.main_compartment(device="cpu")[1] == 1


@pytest.mark.slow
def test_bench_record_matches_jax_ok_ops(monkeypatch):
    """bench --compartment's record at P = 1, 2 offered 1,000 ops a
    second for 0.12 s by 12 clients: every point valid, each point's ok
    ops the JAX runner's."""
    from maelstrom_tpu_torch import bench as pbench
    env = {"BENCH_COMPARTMENT_PROXIES": "1,2",
           "BENCH_COMPARTMENT_RATE": "1000",
           "BENCH_COMPARTMENT_TIME_LIMIT": "0.12",
           "BENCH_COMPARTMENT_CONC": "12"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rec, rc = pbench.main_compartment(device="cpu")
    assert rec["valid"] is True and rc == 0
    assert [r["proxies"] for r in rec["proxies"]] == [1, 2]
    for row in rec["proxies"]:
        res = jcore.run(_bench_opts(row["proxies"], 1000.0, 0.12, 12,
                                    "/tmp/maelstrom-bench-comp-jax"))
        assert row["ok_ops"] == res["stats"]["ok-count"] > 0
        assert row["failed_ops"] == res["stats"]["fail-count"]


def _bench_opts(p, rate, tl, conc, store):
    return dict(store_root=store, seed=11, workload="lin-kv",
                node="tpu:compartment",
                roles=f"proxies={p},acceptors=2x2,replicas=2",
                concurrency=conc, rate=rate, time_limit=tl,
                journal_rows=False, audit=False, audit_trace=False,
                no_overlap=True, leader_slots=128, proxy_slots=8,
                compartment_inbox=16, kv_keys=1024, timeout_ms=20000)


# --- the smoke's pins (slow) ------------------------------------------------

def _smoke_runs():
    import chip_smoke
    return dict(chip_smoke.CLI_COMPARTMENT)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_smoke_runs()))
def test_pinned_compartment_runs(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_COMPARTMENT: the sha256 of the
    JAX runner's history.jsonl and of its `net.telemetry` block (None
    with the ring off) for each cli_compartment run, and checks the
    port's run on the CPU against them."""
    import chip_smoke
    opts = _smoke_runs()[name]
    jres, pres, jh, ph = _both(opts, tmp_path)
    pin = chip_smoke.PINNED_COMPARTMENT[name]
    assert jres["valid"] is True
    assert hashlib.sha256(jh).hexdigest() == pin["history"]
    tel = jres["net"].get("telemetry")
    assert (None if tel is None else hashlib.sha256(json.dumps(
        tel, sort_keys=True).encode()).hexdigest()) == pin["telemetry"]
    assert ph == jh
    assert pres["net"].get("telemetry") == tel


@pytest.mark.slow
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_pinned_bench_ok_ops(p, tmp_path):
    """Re-derives chip_smoke.py's PINNED_COMPARTMENT_BENCH: the JAX
    runner's ok ops at each point of bench.py's compartment sweep at
    full width."""
    import chip_smoke
    res = jcore.run(_bench_opts(p, 8000.0, 2.0, 96, str(tmp_path)))
    assert res["valid"] is True
    assert res["stats"]["ok-count"] == \
        chip_smoke.PINNED_COMPARTMENT_BENCH[p]
