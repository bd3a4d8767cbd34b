"""The port's elected compartment (`--node tpu:compartment --roles
sequencers=S`, S > 1) against the JAX package's, on the CPU.

- The role steps: the plain versions of K27 (`SequencerRole`'s elected
  step), K28 (`ProxyRole` with ballots), K29 (`AcceptorRole`'s elected
  step) and K26 at the elected learn packing against JAX's steps under
  jit on seeded random inboxes (`maelstrom_tpu_torch.testing.
  compartment.random_elect_inputs`: every phase-1 lane type, QVAL ballot ties,
  duplicate and stale prepares, P2A below and at the promise, a query of
  a slot written the same round, done_bits backlogs past 8, ballots at
  the ballot-width limit), with the stall mask on and off. Tolerance:
  exact, on every state leaf and outbox field, invalid lanes included.
- `tests/test_election.py`'s unit cases (promise-highest,
  fence-and-query, accept-raises-floor, the duel, the redirect) on the
  port.
- The program's host hooks (the lease, `note_leader`, `note_timeout`,
  `next_probe`, the leader and the election report) against JAX's under
  one call sequence; the runner's redirect requeue and backoff.
- A 6-node elected cluster's rounds through the pool-path round with the
  leader killed and restarted from the durable store: every `SimState`
  leaf (the key included) and `NetStats` counter equal.
- The kill-as-failover soup through both CLIs (the ISSUE's command with
  `--device cpu`), history.jsonl and the net journal byte-equal to the
  JAX runner's, its availability block (the election report included)
  equal but for wall time; the CLI's lifted options; the refusals that
  remain (the elected layout's, in JAX's words; the byzantine
  adversary).

`-m slow` re-derives `chip_smoke.PINNED_ELECTION` (the smoke's
`cli_election` runs at full length) and `chip_smoke.
PINNED_FAILOVER_BENCH` (bench.py's failover record at full width), some
ten minutes on the CPU:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_election.py -m slow
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

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import compartment as JC
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.sim import _freeze as j_freeze
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch import core as pcore
from maelstrom_tpu_torch import prng
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import compartment as PC
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.runner import sessions as psessions
from maelstrom_tpu_torch.sim import make_run_fn as p_make_run_fn
from test_torch_compartment import _both
from maelstrom_tpu_torch.testing.compartment import \
    random_compartment_inputs
from test_torch_kernels_gpu import (ELECT_CASES, compartment_layout,
                                    compartment_role)
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

JROLES = {"sequencers": JC.SequencerRole, "proxies": JC.ProxyRole,
          "acceptors": JC.GridAcceptors, "replicas": JC.ReplicaRole}
ROLES6 = "sequencers=2,proxies=1,acceptors=1x2,replicas=1"
NODES6 = [f"n{i}" for i in range(6)]


# --- the role steps (K26-K29's plain versions) ------------------------------

def _keys(seed):
    """The same role key for both packages."""
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


@pytest.mark.parametrize("case", list(ELECT_CASES))
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_elected_role_steps_match_jax(case, stalled):
    roles, opts, role, n = ELECT_CASES[case]
    rnd = {False: 37, True: 1 << 20}[stalled]
    lay = compartment_layout(roles, rate=20.0, time_limit=2.0, **opts)
    jlay = JC.Layout({"roles": roles, "rate": 20.0, "time_limit": 2.0,
                      **opts}, lay.n_nodes)
    rng = np.random.default_rng(n * 17 + len(case) + int(stalled))
    inbox, state = random_compartment_inputs(rng, role, lay, n, rnd)
    stall = rng.random(n) < 0.4
    jprog = JROLES[role]({}, [f"n{i}" for i in range(n)], jlay)
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    jkey, pkey = _keys(n + rnd)
    jnew, jout = jax.jit(lambda s_, m_, r_: jprog.step(s_, m_, {
        "round": r_, "key": jkey}))(jst, JT.Msgs(**{
            k: jnp.asarray(v) for k, v in inbox.items()}), jnp.int32(rnd))
    ctx = {"round": torch.tensor(rnd, dtype=torch.int32), "key": pkey}
    if stalled:
        st = jnp.asarray(stall)
        jnew = j_freeze(st, jst, jnew)
        jout = jout.replace(valid=jout.valid & ~st[:, None])
        ctx["stall"] = torch.tensor(stall)
    pprog = compartment_role(role, lay, n, "cpu")
    pnew, pout = pprog.step({k: torch.tensor(v) for k, v in state.items()},
                            convert.msgs_from_numpy(inbox, device="cpu"),
                            ctx)
    assert list(pnew) == list(state)
    assert_trees_equal(jax_tree_to_numpy(jnew), as_numpy(pnew))
    assert_trees_equal(jax_tree_to_numpy(jout), as_numpy(pout))
    if not stalled:
        assert as_numpy(pout)["valid"].any()
    assert pprog.outbox_cap == jprog.outbox_cap
    assert list(pprog.init_state()) == list(jprog.init_state())
    assert_trees_equal(jax_tree_to_numpy(jprog.init_state()),
                       as_numpy(pprog.init_state()))


# --- test_election.py's unit cases on the port --------------------------------

def _lay(**over):
    opts = {"roles": "sequencers=2,proxies=1,acceptors=2x2,replicas=1",
            "rate": 5, "time_limit": 1, **over}
    return opts, PC.Layout(opts, 8), JC.Layout(opts, 8)


def _ctx(rnd, seed=0):
    return {"round": torch.tensor(rnd, dtype=torch.int32),
            "key": prng.PRNGKey(seed, "cpu")}


def _inbox(n, k, rows):
    """Msgs [n, k] from sparse rows: (node, lane, field dict)."""
    ib = PT.Msgs.empty((n, k), "cpu")
    cols = {f: getattr(ib, f).clone() for f in
            ("valid", "src", "dest", "type", "a", "b", "c", "mid")}
    for node, lane, fields in rows:
        cols["valid"][node, lane] = True
        for f, v in fields.items():
            cols[f][node, lane] = v
    return ib.replace(**cols)


def _acceptors(opts, lay):
    return PC.AcceptorRole(opts, [f"n{i}" for i in range(3, 7)], lay,
                           device="cpu")


def test_col_quorum_geometry_matches_jax():
    """Phase-1 quorums are COLUMNS: every column meets every row quorum;
    a full row does not."""
    _o, lay, jlay = _lay()
    for bits in range(16):
        assert bool(PC._col_quorum(lay, torch.tensor(bits, dtype=torch.int32))
                    ) == bool(JC._col_quorum(jlay, jnp.int32(bits)))
    col0, row0 = (1 << 0) | (1 << 2), (1 << 0) | (1 << 1)
    assert bool(PC._col_quorum(lay, torch.tensor(col0)))
    assert not bool(PC._col_quorum(lay, torch.tensor(row0)))


def test_acceptor_promises_highest_and_rejects_rest():
    opts, lay, _j = _lay()
    acc = _acceptors(opts, lay)
    st, out = acc.step(acc.init_state(), _inbox(4, lay.K, [
        (0, 0, {"type": PC.T_PREP, "a": 3, "src": 0}),
        (0, 1, {"type": PC.T_PREP, "a": 5, "src": 1})]), _ctx(1))
    assert int(st["promised"][0]) == 5
    types = out.type[0][out.valid[0]].tolist()
    assert set(types) == {PC.T_PROM, PC.T_REJP}
    lane = out.type[0].tolist().index(PC.T_PROM)
    assert int(out.a[0, lane]) == 5 and int(out.c[0, lane]) == 0


def test_acceptor_fences_stale_p2a_and_answers_queries():
    """After promising ballot 5, a stale-ballot T_P2A is nacked (T_P2R)
    and never stored, a current one stores and acks, and T_QRY reads
    back (cmd, accepted ballot)."""
    opts, lay, _j = _lay()
    acc = _acceptors(opts, lay)
    st, _ = acc.step(acc.init_state(), _inbox(4, lay.K, [
        (0, 0, {"type": PC.T_PREP, "a": 5, "src": 1})]), _ctx(1))
    st, out = acc.step(st, _inbox(4, lay.K, [
        (0, 0, {"type": PC.T_P2A, "a": 7, "b": 111, "c": 3, "src": 2}),
        (0, 1, {"type": PC.T_P2A, "a": 8, "b": 222, "c": 5, "src": 2})]),
        _ctx(2))
    assert not bool(st["acc_has"][0, 7]) and bool(st["acc_has"][0, 8])
    assert int(st["acc_bal"][0, 8]) == 5 and int(st["acc_hi"][0]) == 8
    assert int(out.type[0, 0]) == PC.T_P2R and int(out.c[0, 0]) == 5
    assert int(out.type[0, 1]) == PC.T_P2B and int(out.c[0, 1]) == 5
    st, out = acc.step(st, _inbox(4, lay.K, [
        (0, 0, {"type": PC.T_QRY, "a": 8, "c": 5, "src": 1}),
        (0, 1, {"type": PC.T_QRY, "a": 9, "c": 5, "src": 1})]), _ctx(3))
    assert int(out.type[0, 0]) == PC.T_QVAL and int(out.b[0, 0]) == 222
    assert int(out.c[0, 0]) & 0xFFFF == 6 and int(out.c[0, 1]) & 0xFFFF == 0


def test_accept_raises_promise_floor():
    """Accepting ballot b promises b: a stale lower-ballot proposal
    arriving after is nacked and the higher-ballot value kept."""
    opts, lay, _j = _lay()
    acc = _acceptors(opts, lay)
    st, out = acc.step(acc.init_state(), _inbox(4, lay.K, [
        (1, 0, {"type": PC.T_P2A, "a": 10, "b": 222, "c": 1, "src": 2})]),
        _ctx(1))
    assert int(out.type[1, 0]) == PC.T_P2B and int(st["promised"][1]) == 1
    st, out = acc.step(st, _inbox(4, lay.K, [
        (1, 0, {"type": PC.T_P2A, "a": 10, "b": 111, "c": 0, "src": 2})]),
        _ctx(2))
    assert int(out.type[1, 0]) == PC.T_P2R
    assert int(st["acc_cmd"][1, 10]) == 222 and int(st["acc_bal"][1, 10]) == 1


def test_sequencer_duel_loser_backs_off_winner_takes_column():
    opts, lay, _j = _lay()
    seq = PC.SequencerRole(opts, ["n0", "n1"], lay, device="cpu")
    st = seq.init_state()
    st["electing"] = torch.tensor([False, True])
    st["leading"] = torch.tensor([False, False])
    st["bal"] = torch.tensor([0, 3], dtype=torch.int32)
    st["cand_round"] = torch.tensor([0, 10], dtype=torch.int32)
    # a full ROW of promises is not a phase-1 quorum
    st, _ = seq.step(st, _inbox(2, lay.K, [
        (1, 0, {"type": PC.T_PROM, "a": 3, "b": 0, "c": 9}),
        (1, 1, {"type": PC.T_PROM, "a": 3, "b": 1, "c": 4})]), _ctx(12))
    assert not bool(st["leading"][1])
    # completing a COLUMN wins; next_slot = hi + 1
    st, _ = seq.step(st, _inbox(2, lay.K, [
        (1, 0, {"type": PC.T_PROM, "a": 3, "b": 2, "c": 9})]), _ctx(14))
    assert bool(st["leading"][1]) and not bool(st["electing"][1])
    assert int(st["next_slot"][1]) == 9
    assert int(st["won_count"][1]) == 1 and int(st["won_sum"][1]) == 4
    # a rival's rejection aborts a candidacy and backs off
    st["electing"] = torch.tensor([True, False])
    st["bal"] = torch.tensor([4, 3], dtype=torch.int32)
    st, _ = seq.step(st, _inbox(2, lay.K, [
        (0, 0, {"type": PC.T_REJP, "a": 4, "c": 7})]), _ctx(20))
    assert not bool(st["electing"][0]) and int(st["seen"][0]) == 7
    assert int(st["boff"][0]) > 20


def test_sequencer_redirects_when_not_leading():
    opts, lay, _j = _lay()
    seq = PC.SequencerRole(opts, ["n0", "n1"], lay, device="cpu")
    st, out = seq.step(seq.init_state(), _inbox(2, lay.K, [
        (1, 0, {"type": 10, "a": 1, "src": 8, "mid": 42})]), _ctx(1))
    lane = int(torch.argmax(out.valid[1].int()))
    assert int(out.type[1, lane]) == PC.T_ERR
    assert int(out.a[1, lane]) == PC.E_NOT_LEADER
    assert int(out.b[1, lane]) == 0           # the ballot-0 leader's hint
    assert int(out.reply_to[1, lane]) == 42


# --- the host hooks, the sessions and the backoff ---------------------------

def test_host_hooks_match_jax():
    """The lease, note_leader, note_timeout, next_probe, node_for_op, the
    leader and the election report: one seeded call sequence on both
    programs, every answer equal."""
    opts = {"roles": ROLES6, "rate": 30.0, "time_limit": 2.5,
            "election_timeout_rounds": 40}
    for lease in (None, 0, 7.0):
        o = {**opts, "leader_lease_ms": lease}
        jp = j_get_program("compartment", o, NODES6)
        pp = p_get_program("compartment", o, NODES6, device="cpu")
        assert pp._lease_rounds == jp._lease_rounds
        rng = np.random.default_rng(3)
        r = 0
        for _ in range(400):
            r += int(rng.integers(0, 30))
            call = int(rng.integers(0, 6))
            node = int(rng.integers(-1, 4))
            for p in (jp, pp):
                p.observe_round(r)
            if call == 0:
                got = [p.node_for_op({"f": "read"}) for p in (jp, pp)]
            elif call == 1:
                at = r - int(rng.integers(0, 5))
                got = [p.note_reply(node, at) for p in (jp, pp)]
            elif call == 2:
                got = [p.note_leader(node) for p in (jp, pp)]
            elif call == 3:
                got = [p.note_timeout(node) for p in (jp, pp)]
            elif call == 4:
                got = [p.next_probe(max(node, 0)) for p in (jp, pp)]
            else:
                got = [p.redirect_hint({"code": 31, "hint": node})
                       for p in (jp, pp)]
            assert got[0] == got[1]
            assert (pp._leader_guess, pp._lease_ok) == (
                jp._leader_guess, jp._lease_ok)
    jp = j_get_program("compartment", opts, NODES6)
    pp = p_get_program("compartment", opts, NODES6, device="cpu")
    rng = np.random.default_rng(5)
    seq = {k: v.numpy() for k, v in pp.init_state()["sequencers"].items()}
    for lead in ([False, False], [True, False], [True, True]):
        seq.update(leading=np.array(lead), bal=rng.integers(0, 9, 2),
                   seen=rng.integers(0, 9, 2),
                   won_count=rng.integers(0, 3, 2),
                   won_sum=rng.integers(0, 90, 2),
                   won_max=rng.integers(0, 40, 2),
                   bal_overflow=rng.integers(0, 2, 2))
        host = {"sequencers": seq}
        assert pp.current_leader_host(host) == jp.current_leader_host(host)
        assert pp.election_report(host) == jp.election_report(host)
    assert pp.dynamic_fault_groups() == jp.dynamic_fault_groups()
    assert pp.fault_groups() == jp.fault_groups()


def test_sessions_requeue_matches_jax():
    """The redirect requeue half of the session table: one seeded
    sequence of requeues, due takes, drains and retry chains on both
    packages' `CoroutineSessions`."""
    from maelstrom_tpu.runner import sessions as jsessions
    js, ps = jsessions.CoroutineSessions(), psessions.CoroutineSessions()
    rng = np.random.default_rng(7)
    for step in range(600):
        call = int(rng.integers(0, 8))
        r = int(rng.integers(0, 100))
        proc = int(rng.integers(0, 5))
        if call < 3:
            row = (r, proc, {"f": "read", "i": step}, proc % 3, 10, step,
                   0, 0)
            got = [s.requeue(*row) for s in (js, ps)]
        elif call == 3:
            got = [s.take_due_requeues(r) for s in (js, ps)]
        elif call == 4:
            got = [s.drain_requeues(r) for s in (js, ps)]
        elif call == 5:
            att = int(rng.integers(1, 4))
            got = [s.open_retry(proc, att) for s in (js, ps)]
        elif call == 6:
            got = [s.close_retry(proc) for s in (js, ps)]
        else:
            got = [(s.attempt(proc), s.retry_is_open(proc), s.has_requeue(),
                    s.requeue_min_due()) for s in (js, ps)]
        assert got[0] == got[1]
    for args in ((50, 2000, 0), (1, 1, 9), (3, 700, 40), (20, 2000, 5)):
        assert psessions.trunc_exp_bound(*args) == \
            jsessions.trunc_exp_bound(*args)


def test_backoff_rounds_match_jax():
    from types import SimpleNamespace

    from maelstrom_tpu.runner.tpu_runner import TpuRunner as JRunner
    from maelstrom_tpu_torch.runner.tpu_runner import TpuRunner as PRunner
    for test, mpr in (({"seed": 11}, 1.0),
                      ({"seed": 3, "client_backoff_ms": 20,
                        "client_backoff_cap_ms": 100}, 1.0),
                      ({"seed": 7, "client_backoff_ms": 50}, 5.0)):
        fake = SimpleNamespace(test=test, ms_per_round=mpr)
        for proc in range(4):
            for attempt in range(20):
                assert PRunner._backoff_rounds(fake, proc, attempt) == \
                    JRunner._backoff_rounds(fake, proc, attempt)


# --- the cluster's rounds ----------------------------------------------------

def _elect_plan(n, R, M, seed, clients=4):
    """M client requests a round to either candidate: reads, writes and
    cas over four keys."""
    rng = np.random.default_rng(seed)
    return {"valid": rng.random((R, M)) < 0.5,
            "src": (n + rng.integers(0, clients, (R, M))).astype(np.int32),
            "dest": rng.integers(0, 2, (R, M)).astype(np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": rng.integers(0, 1 << 20, (R, M)).astype(np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": rng.choice(np.array([10, 12, 14], np.int32), (R, M)),
            "a": rng.integers(0, 4, (R, M), dtype=np.int32),
            "b": rng.integers(0, 4, (R, M), dtype=np.int32),
            "c": rng.integers(0, 4, (R, M), dtype=np.int32)}


def test_elected_cluster_rounds_match_jax():
    """A 6-node elected cluster (2 candidates, 1 proxy, a 1x2 grid, 1
    replica) for 70 rounds under 5% loss with the leader n0 killed: the
    other candidate's detector fires and it wins; then n0's restart from
    the durable store and 70 more rounds, in which it hears the new
    leader. Every SimState leaf (the key included) and NetStats counter
    equal."""
    opts = {"roles": ROLES6, "rate": 30.0, "time_limit": 1.0,
            "election_timeout_rounds": 20, "compartment_retry": 4}
    jprog = j_get_program("compartment", opts, NODES6)
    pprog = p_get_program("compartment", opts, NODES6, device="cpu")
    kw = dict(n_nodes=6, n_clients=4, pool_cap=1024,
              inbox_cap=jprog.inbox_cap, client_cap=8,
              latency_mean_rounds=1.0, enable_stall=True,
              partition_groups=6)
    jcfg, pcfg = JT.NetConfig(**kw), PT.NetConfig(**kw)
    jsim = j_make_sim(jprog, jcfg, seed=41)
    psim = convert.state_from_numpy(jax_tree_to_numpy(jsim), pprog, pcfg,
                                    device="cpu")
    down = np.zeros(6, bool)
    down[0] = True
    jsim = jsim.replace(net=JT.set_down(JT.flaky(jsim.net, 0.05), down))
    psim = psim.replace(net=PT.set_down(PT.flaky(psim.net, 0.05),
                                        torch.tensor(down)))
    jrun = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)
    prun = p_make_run_fn(pprog, pcfg, collect_client_msgs=True,
                         device="cpu")
    for phase in range(2):
        plan = _elect_plan(6, 70, 2, seed=phase)
        jsim, jmsgs = jrun(jsim, JT.Msgs(**{k: jnp.asarray(v)
                                            for k, v in plan.items()}))
        psim, pmsgs = prun(psim, convert.msgs_from_numpy(plan,
                                                         device="cpu"))
        assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
        assert_msgs_equal_on_valid(jmsgs, pmsgs)
        if phase == 0:
            seq = psim.nodes["sequencers"]
            assert bool(seq["leading"][1]) and int(seq["won_count"][1]) == 1
            jnodes = jprog.restore(jprog.init_state(), jsim.durable,
                                   jsim.nodes, jnp.asarray(down))
            pnodes = pprog.restore(pprog.init_state(), psim.durable,
                                   psim.nodes, torch.tensor(down))
            assert_trees_equal(jax_tree_to_numpy(jnodes), as_numpy(pnodes))
            jsim = jsim.replace(nodes=jnodes, net=JT.set_down(
                jsim.net, np.zeros(6, bool)))
            psim = psim.replace(nodes=pnodes, net=PT.set_down(
                psim.net, torch.zeros(6, dtype=torch.bool)))
    st = PT.stats_dict(psim.net)
    assert st["dropped_down"] > 0
    assert int(psim.nodes["replicas"]["applied"].min()) > 0


# --- end to end -------------------------------------------------------------

def _avail(res):
    return {k: v for k, v in res["availability"].items()
            if k != "check-wall-s"}


def test_failover_soup_matches_jax(tmp_path):
    """The kill-as-failover soup through both CLIs at 5 ms a round (seed
    13: kill=sequencer, pause, partition and duplicate every 0.6 s on 2
    candidates): history.jsonl and the net journal byte-equal to the JAX
    runner's, the availability block (failovers, rounds to leader, dips)
    equal, valid, and every kill naming the live leader."""
    from maelstrom_tpu import cli as jcli
    args = ["test", "-w", "lin-kv", "--node", "tpu:compartment", "--roles",
            ROLES6, "--seed", "13", "--rate", "30", "--time-limit", "2.5",
            "--timeout-ms", "300", "--ms-per-round", "5",
            "--election-timeout-rounds", "40", "--nemesis",
            "kill,pause,partition,duplicate", "--nemesis-interval", "0.6",
            "--nemesis-targets", "kill=sequencer"]
    dirs, res = [], []
    for main, extra, sub in ((jcli.main, ["--no-audit", "--no-overlap"],
                              "jax"),
                             (pcli.main, ["--device", "cpu"], "port")):
        store = str(tmp_path / sub)
        assert main(args + extra + ["--store", store]) == 0
        d = os.path.realpath(os.path.join(store, "latest"))
        dirs.append(d)
        with open(os.path.join(d, "results.json")) as f:
            res.append(json.load(f))
    (jd, pd), (jres, pres) = dirs, res

    def read(d, *path):
        with open(os.path.join(d, *path), "rb") as f:
            return f.read()
    ph = read(pd, "history.jsonl")
    assert ph == read(jd, "history.jsonl")
    journal = sorted(os.listdir(os.path.join(jd, "net-journal")))
    assert journal == sorted(os.listdir(os.path.join(pd, "net-journal")))
    for name in journal:
        assert read(pd, "net-journal", name) == read(jd, "net-journal", name)
    assert pres["valid"] is jres["valid"] is True
    assert pres["workload"] == jres["workload"]
    assert _avail(pres) == _avail(jres)
    assert pres["availability"]["election"]["failovers"] >= 2
    assert pres["net"]["send-count-by-type"] == \
        jres["net"]["send-count-by-type"]
    assert pres["net"]["send-count-by-type"]["prep"] > 0
    kills = [json.loads(x) for x in ph.decode().splitlines()
             if '"start-kill"' in x and '"info"' in x]
    assert kills and all("n0" in str(k["value"]) or "n1" in str(k["value"])
                         for k in kills)


# --- the CLI ---------------------------------------------------------------

def test_cli_lifts_the_election_options():
    args = pcli.build_parser().parse_args([
        "test", "-w", "lin-kv", "--node", "tpu:compartment", "--roles",
        "sequencers=3,proxies=4,acceptors=2x2,replicas=2",
        "--election-timeout-rounds", "50", "--leader-lease-ms", "0",
        "--client-retries", "2", "--client-backoff-ms", "20",
        "--nemesis", "kill", "--nemesis-targets", "kill=sequencer",
        "--device", "cpu"])
    opts = pcli.opts_from_args(args)
    assert opts["election_timeout_rounds"] == 50
    assert opts["leader_lease_ms"] == 0.0
    assert opts["client_retries"] == 2 and opts["client_backoff_ms"] == 20
    test = pcore.build_test(opts)
    assert len(test["nodes"]) == 13


@pytest.mark.parametrize("opts", [
    {"roles": "sequencers=2", "ballot_width": 9},
    {"roles": "sequencers=4", "ballot_width": 2},
    {"roles": "sequencers=2", "election_timeout_rounds": 5},
    {"roles": "sequencers=2", "log_cap": 5000}])
def test_elected_layout_refusals_match_jax(opts):
    n = JC.roles_node_count(opts["roles"])
    msgs = []
    for get, kw in ((j_get_program, {}), (p_get_program, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            get("compartment", {"rate": 5, "time_limit": 1, **opts},
                [f"n{i}" for i in range(n)], **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_byzantine_stays_refused_on_an_elected_tier(tmp_path, capsys):
    # the adversary runs on an elected tier since the byzantine slice (the
    # proxies carry the stale-ballot surface there); beside a fleet it
    # stays refused, in the JAX package's words
    prog = p_get_program("compartment", {"roles": "sequencers=2",
                                         "nemesis": {"kill", "byzantine"}},
                         [f"n{i}" for i in range(10)], device="cpu")
    assert prog.byz_wire().S == 2          # the stale-ballot surface too
    assert pcli.main(["test", "-w", "lin-kv", "--node", "tpu:compartment",
                      "--roles", "sequencers=2", "--nemesis",
                      "kill,byzantine", "--fleet", "2", "--device", "cpu",
                      "--store", str(tmp_path)]) == 2
    assert "does not compose with --fleet" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


# --- the smoke's pins (slow) ------------------------------------------------

def _smoke_runs():
    import chip_smoke
    return dict(chip_smoke.CLI_ELECTION)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_smoke_runs()))
def test_pinned_election_runs(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_ELECTION: the sha256 of the JAX
    runner's history.jsonl and of its `net.telemetry` block (None with the
    ring off) and its election block for each cli_election run, and holds
    the port's run on the CPU to them: the history byte-equal, the
    availability block equal but for wall time."""
    import chip_smoke
    opts = _smoke_runs()[name]
    jres, pres, jh, ph = _both(opts, tmp_path)
    pin = chip_smoke.PINNED_ELECTION[name]
    assert jres["valid"] is True
    assert hashlib.sha256(jh).hexdigest() == pin["history"]
    tel = jres["net"].get("telemetry")
    assert (None if tel is None else hashlib.sha256(json.dumps(
        tel, sort_keys=True).encode()).hexdigest()) == pin["telemetry"]
    assert jres["availability"]["election"] == pin["election"]
    assert ph == jh
    assert _avail(pres) == _avail(jres)
    assert pres["net"].get("telemetry") == tel
    if name == "elect-soup":
        assert pin["election"]["failovers"] >= 2


@pytest.mark.slow
def test_pinned_failover_bench():
    """Re-derives chip_smoke.py's PINNED_FAILOVER_BENCH from bench.py's
    `bench_failover_record` (the JAX runner at full width on the CPU) and
    holds the port's `bench --failover` record to it."""
    import importlib.util

    import chip_smoke
    from maelstrom_tpu_torch import bench as pbench
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(root, "bench.py"))
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    jrec = jbench.bench_failover_record()
    keys = chip_smoke.FAILOVER_PIN_KEYS
    assert jrec["valid"] is True and jrec["failovers"] >= 2
    assert {k: jrec[k] for k in keys} == chip_smoke.PINNED_FAILOVER_BENCH
    prec, rc = pbench.main_failover(device="cpu")
    assert rc == 0 and prec["valid"] is True
    assert {k: prec[k] for k in keys} == chip_smoke.PINNED_FAILOVER_BENCH
    assert prec["dip_threshold_rounds"] == jrec["dip_threshold_rounds"]
    assert prec["leader_lease_rounds"] == jrec["leader_lease_rounds"]


@pytest.mark.slow
def test_ordered_engine_fails_over_like_jax(tmp_path):
    """lin-kv over the compartment engine with an elected tier
    (`--ordering compartment --roles sequencers=2`) under kill=sequencer:
    the history byte-equal to the JAX runner's, a failover in both."""
    opts = dict(workload="lin-kv", ordering="compartment", seed=7,
                rate=20.0, time_limit=1.5, journal_rows=False, roles=ROLES6,
                election_timeout_rounds=40, timeout_ms=300,
                nemesis={"kill"}, nemesis_interval=0.5,
                nemesis_targets="kill=sequencer", recovery_s=1)
    jres, pres, jh, ph = _both(opts, tmp_path)
    assert ph == jh
    assert pres["valid"] is jres["valid"] is True
    assert _avail(pres) == _avail(jres)
    assert pres["availability"]["election"]["failovers"] >= 1
