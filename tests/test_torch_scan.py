"""The port's scan-ahead (`sim.make_scan_fn`) against the JAX package's,
and the plain versions of kernels K5 (`append_replies`) and K6 (the
runner's quiescence probe) against the JAX functions they replace.

Both scans start from one state (built in JAX, carried across with
`convert`) and one inject batch. Tolerance: exact, on every state leaf
(the threefry `key` included), on the last round's client messages, on
k, on the whole reply log (rows past rn empty, as JAX leaves them) and on
the whole journal buffer (rows past k zero)."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.nodes.broadcast import T_BCAST, T_READ
from maelstrom_tpu.sim import make_round_fn as j_make_round_fn
from maelstrom_tpu.sim import make_scan_fn as j_make_scan_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.runner.tpu_runner import (quiet_probe,
                                                   quiet_probe_plain)
from maelstrom_tpu_torch.sim import append_replies_plain, empty_reply_log
from maelstrom_tpu_torch.sim import make_round_fn as p_make_round_fn
from maelstrom_tpu_torch.sim import make_scan_fn as p_make_scan_fn
from test_torch_support import as_numpy, assert_trees_equal, \
    jax_tree_to_numpy

# (nodes, latency): the 5-node grid at latency 0 (ring 2) and a 64-node
# grid at latency 2 (ring 22), both with the `sent` plane tracked as the
# runner tracks it on clusters of 64 nodes or fewer
SHAPES = {5: 0, 64: 2}
C = 6           # client processes
RCAP = 64       # reply_cap asked for (the log takes max(it, 2 CW))
JCAP = 96       # journal_cap


@functools.lru_cache(maxsize=None)
def _programs(n):
    nodes = [f"n{i}" for i in range(n)]
    opts = {"topology": "grid", "max_values": 40,
            "latency": {"mean": SHAPES[n]}}
    jprog = j_get_program("broadcast", opts, nodes)
    pprog = p_get_program("broadcast", opts, nodes, device="cpu")
    kw = dict(n_nodes=n, n_clients=C, pool_cap=max(8 * C, 64),
              inbox_cap=jprog.inbox_cap, client_cap=max(2 * C, 8),
              latency_mean_rounds=float(SHAPES[n]))
    return jprog, pprog, JT.NetConfig(**kw), PT.NetConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_scan(n, journal):
    jprog, _p, jcfg, _c = _programs(n)
    return j_make_scan_fn(jprog, jcfg, reply_cap=RCAP,
                          journal_cap=JCAP if journal else None)


def _inject(n, seed):
    """C client requests: broadcasts of fresh values, then reads."""
    rng = np.random.default_rng(seed)
    typ = np.where(np.arange(C) < C - 2, T_BCAST, T_READ)
    return {"valid": np.arange(C) < C - 1,
            "src": (n + np.arange(C)).astype(np.int32),
            "dest": rng.integers(0, n, C, dtype=np.int32),
            "due": np.zeros(C, np.int32), "mid": np.zeros(C, np.int32),
            "reply_to": np.full(C, -1, np.int32),
            "type": typ.astype(np.int32),
            "a": rng.integers(0, 40, C, dtype=np.int32),
            "b": np.zeros(C, np.int32), "c": np.zeros(C, np.int32)}


def _start(n, seed):
    """A JAX state mid-run: six rounds of the same kind of requests, so
    gossip is in flight when the scan starts."""
    jprog, _p, jcfg, _c = _programs(n)
    sim = j_make_sim(jprog, jcfg, seed=3, track_edge_send_round=True)
    round_fn = j_make_round_fn(jprog, jcfg)
    for r in range(6):
        inj = _inject(n, seed * 100 + r)
        sim, _cm, _io = round_fn(sim, JT.Msgs(**{
            k: jnp.asarray(v) for k, v in inj.items()}))
    return sim


# (n, k_max, stop_on_reply, journal): for each grid and k_max both stop
# modes, and across the pair both log forms (reply_cap alone and with
# journal_cap), every pair of values of any two factors covered
CASES = [(5, 1, False, False), (5, 1, True, True), (5, 7, False, True),
         (5, 7, True, False), (5, 64, False, False), (5, 64, True, True),
         (64, 1, False, True), (64, 1, True, False), (64, 7, False, False),
         (64, 7, True, True), (64, 64, False, True), (64, 64, True, False)]


def _scan_both(n, k_max, stop, journal, first_chunk=None):
    """The scan from the same mid-run state in both packages, every
    output held equal; returns the port's scan fn and k."""
    jprog, pprog, jcfg, pcfg = _programs(n)
    jsim = _start(n, n + k_max)
    start = jax_tree_to_numpy(jsim)
    inj = _inject(n, 7 * k_max + n)
    out_j = _jax_scan(n, journal)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in inj.items()}),
        jnp.int32(k_max), stop)
    scan = p_make_scan_fn(pprog, pcfg, reply_cap=RCAP,
                          journal_cap=JCAP if journal else None,
                          device="cpu", chunk=4, first_chunk=first_chunk)
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    assert psim.channels.sent is not None
    out_p = scan(psim, convert.msgs_from_numpy(inj, device="cpu"), k_max,
                 stop)
    assert len(out_j) == len(out_p)
    k = int(out_j[2])
    assert out_p[2] == k
    assert 1 <= k <= max(k_max, 1)
    assert_trees_equal(jax_tree_to_numpy(out_j[0]), as_numpy(out_p[0]))
    assert_trees_equal(jax_tree_to_numpy(out_j[1]), as_numpy(out_p[1]))
    rl_j = [jax_tree_to_numpy(x) for x in out_j[3][:2]] + [
        np.asarray(out_j[3][2]), np.asarray(out_j[3][3])]
    rl_p = [as_numpy(x) for x in out_p[3][:2]] + [
        out_p[3][2].numpy(), out_p[3][3].numpy()]
    for name, a, b in zip(("rlog", "rounds", "plog", "rn"), rl_j, rl_p):
        assert_trees_equal(a, b, path=name)
    if journal:
        buf_j = [jax_tree_to_numpy(x) for x in out_j[4]]
        buf_p = [as_numpy(x) for x in out_p[4]]
        for i, (a, b) in enumerate(zip(buf_j, buf_p)):
            assert_trees_equal(a, b, path=f"buf[{i}]")
    return scan, k


@pytest.mark.parametrize("n,k_max,stop,journal", CASES)
def test_scan_matches_jax(n, k_max, stop, journal):
    scan, k = _scan_both(n, k_max, stop, journal)
    # the host reads the exit flag at most once a chunk of 4 rounds
    assert scan.host_syncs <= -(-k // 4)


@pytest.mark.parametrize("n,k_max,journal", [(5, 7, False), (5, 64, True),
                                             (64, 7, True), (64, 64, False)])
def test_scan_growing_chunks_matches_jax(n, k_max, journal):
    """The pool path's form: stopping on replies, chunks of 1, 2, then 4
    rounds, the same outputs as JAX's one while_loop."""
    scan, k = _scan_both(n, k_max, True, journal, first_chunk=1)
    # once a chunk of 4 rounds, and after the first chunks of 1 and 2
    assert scan.host_syncs <= -(-k // 4) + 2


@pytest.mark.parametrize("n", sorted(SHAPES))
def test_scan_matches_port_round_by_round(n):
    """scan == the port's own round fn, round by round: the same state
    and the same replies in the log, each stamped with its producing
    round's post-round counter; the stop-on-reply scan is the prefix of
    that run up to the first reply."""
    _j, pprog, _c, pcfg = _programs(n)
    start = jax_tree_to_numpy(_start(n, 1))
    inj = convert.msgs_from_numpy(_inject(n, 5), device="cpu")
    empty = PT.Msgs.empty(C, "cpu")
    round_fn = p_make_round_fn(pprog, pcfg, device="cpu")
    sim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    R = 11
    sims, replies = [], []
    for i in range(R):
        sim, cm, _io = round_fn(sim, inj if i == 0 else empty)
        sims.append(as_numpy(sim))
        v = cm.valid.numpy()
        replies += [(int(sim.net.round), int(m)) for m in cm.mid.numpy()[v]]
    first_reply = next(i for i in range(R) if any(
        r == int(sims[i]["net"]["round"]) for r, _m in replies))
    for stop, k_want in ((False, R), (True, first_reply + 1)):
        scan = p_make_scan_fn(pprog, pcfg, reply_cap=RCAP, device="cpu",
                              chunk=3)
        s0 = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
        s1, _cm, k, (rlog, rounds, _plog, rn) = scan(s0, inj, R, stop)
        assert k == k_want
        assert_trees_equal(sims[k - 1], as_numpy(s1))
        got = list(zip(rounds.numpy()[:int(rn)].tolist(),
                       rlog.mid.numpy()[:int(rn)].tolist()))
        assert got == [x for x in replies if x[0] <= sims[k - 1]["net"][
            "round"]]


@pytest.mark.parametrize("stop", [False, True])
def test_scan_with_faults_matches_jax(stop):
    """A scan under loss, uniform latency and paused nodes: a chunk that
    runs past the exit round is rolled back with the key it started
    from, so the replayed rounds draw what JAX's while_loop drew."""
    n = 16
    nodes = [f"n{i}" for i in range(n)]
    opts = {"topology": "grid", "max_values": 40,
            "latency": {"mean": 2, "dist": "uniform"}}
    jprog = j_get_program("broadcast", opts, nodes)
    pprog = p_get_program("broadcast", opts, nodes, device="cpu")
    kw = dict(n_nodes=n, n_clients=C, pool_cap=64,
              inbox_cap=jprog.inbox_cap, client_cap=12,
              latency_mean_rounds=2.0, latency_dist="uniform",
              enable_stall=True)
    jcfg, pcfg = JT.NetConfig(**kw), PT.NetConfig(**kw)
    paused = np.arange(n) % 5 == 1
    jsim = j_make_sim(jprog, jcfg, seed=9)
    jsim = jsim.replace(net=JT.set_paused(JT.flaky(jsim.net, 0.2), paused))
    start = jax_tree_to_numpy(jsim)
    inj = _inject(n, 17)
    out_j = j_make_scan_fn(jprog, jcfg, reply_cap=RCAP)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in inj.items()}),
        jnp.int32(40), stop)
    scan = p_make_scan_fn(pprog, pcfg, reply_cap=RCAP, device="cpu",
                          chunk=4)
    out_p = scan(convert.state_from_numpy(start, pprog, pcfg, device="cpu"),
                 convert.msgs_from_numpy(inj, device="cpu"), 40, stop)
    assert out_p[2] == int(out_j[2])
    assert_trees_equal(jax_tree_to_numpy(out_j[0]), as_numpy(out_p[0]))
    assert_trees_equal(jax_tree_to_numpy(out_j[3][0]), as_numpy(out_p[3][0]))
    assert int(out_p[0].net.stats.lost) > 0
    if stop:
        assert out_p[2] % 4 and scan.replayed > 0


@pytest.mark.parametrize("stop,chunk", [(True, 4), (True, 7), (False, 4)])
def test_scan_counts_every_round_it_runs(stop, chunk):
    """A dispatch runs the k rounds it returns, the rounds it replays
    after a chunk ran past the exit, and the rounds of that chunk past
    the exit, which it rolls back: the program steps once for each, so
    k + replayed + rolled_back is a kernel's launch count."""
    n = 16
    nodes = [f"n{i}" for i in range(n)]
    opts = {"topology": "grid", "max_values": 40,
            "latency": {"mean": 2, "dist": "uniform"}}
    jprog = j_get_program("broadcast", opts, nodes)
    pprog = p_get_program("broadcast", opts, nodes, device="cpu")
    kw = dict(n_nodes=n, n_clients=C, pool_cap=64,
              inbox_cap=jprog.inbox_cap, client_cap=12,
              latency_mean_rounds=2.0, latency_dist="uniform")
    pcfg = PT.NetConfig(**kw)
    start = jax_tree_to_numpy(j_make_sim(jprog, JT.NetConfig(**kw), seed=9))
    steps = []
    edge_step = pprog.edge_step

    def counted(*a, **k):
        steps.append(1)
        return edge_step(*a, **k)
    pprog.edge_step = counted
    scan = p_make_scan_fn(pprog, pcfg, reply_cap=RCAP, device="cpu",
                          chunk=chunk)
    sim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    inj = convert.msgs_from_numpy(_inject(n, 17), device="cpu")
    k = scan(sim, inj, 40, stop)[2]
    assert len(steps) == k + scan.replayed + scan.rolled_back
    if stop:
        assert k < 40 and k % chunk
        assert scan.rolled_back == chunk - k % chunk
        assert scan.replayed == k % chunk
    else:
        assert (k, scan.replayed, scan.rolled_back) == (40, 0, 0)


def _random_cm(rng, CW, n):
    return PT.Msgs(
        valid=torch.tensor(rng.random(CW) < 0.3),
        **{f: torch.tensor(rng.integers(-n, 2 * n, CW, dtype=np.int32))
           for f in ("src", "dest", "due", "mid", "reply_to", "type", "a",
                     "b", "c")})


@pytest.mark.parametrize("CW,rn0", [(37, 0), (37, 60), (5000, 123)])
def test_append_replies_plain_matches_jax(CW, rn0):
    """K5's plain version on random client messages against the JAX
    scan's `append_replies` + `reply_payload`, computed as the scan
    body computes them: the log rows, stamps, payload words (values up
    to 95, so bit 31 of word 0 and 2 are set), rn, and the exit flag."""
    n, V, W = 50, 96, 4
    rng = np.random.default_rng(CW + rn0)
    cm = _random_cm(rng, CW, n)
    seen = torch.tensor(rng.random((n, V)) < 0.5)
    rcap = max(64, 2 * CW)
    log = empty_reply_log(rcap, W, "cpu")
    log = log[:3] + (torch.tensor(rn0, dtype=torch.int32),)
    exit_k = torch.tensor(2**31 - 1, dtype=torch.int32)
    rn2 = append_replies_plain(log, cm, seen, n, torch.tensor(
        17, dtype=torch.int32), 3, 5, True, exit_k)
    # the JAX computation (sim.py:821-845) on the same inputs
    jcm = {f: jnp.asarray(getattr(cm, f).numpy())
           for f in PT.Msgs.__dataclass_fields__}
    valid = jcm["valid"]
    offs = jnp.cumsum(valid.astype(jnp.int32)) - valid.astype(jnp.int32)
    pos = jnp.where(valid, rn0 + offs, rcap)
    jprog = j_get_program("broadcast", {"max_values": V},
                          [f"n{i}" for i in range(n)])
    rows = jprog.reply_payload({"seen": jnp.asarray(seen.numpy())},
                               jnp.clip(jcm["src"], 0, n - 1))
    want = {f: np.asarray(getattr(JT.Msgs.empty(rcap), f).at[
        pos].set(jcm[f], mode="drop")) for f in jcm}
    want_rounds = np.asarray(jnp.zeros(rcap, jnp.int32).at[pos].set(
        17, mode="drop"))
    want_plog = np.asarray(jnp.zeros((rcap, W), jnp.int32).at[pos].set(
        rows, mode="drop"))
    want_rn = rn0 + int(valid.sum())
    for f in want:
        assert_trees_equal(want[f], getattr(log[0], f).numpy(), path=f)
    assert_trees_equal(want_rounds, log[1].numpy(), path="rounds")
    assert_trees_equal(want_plog, log[2].numpy(), path="plog")
    assert int(rn2) == want_rn
    go = 3 < 5 and not bool(valid.any()) and want_rn + CW <= rcap
    assert int(exit_k) == (2**31 - 1 if go else 3)


@pytest.mark.parametrize("busy", [None, "pool", "channels", "pending",
                                  "inflight", "inflight_old"])
def test_quiet_probe_plain_matches_jax(busy):
    """K6's plain version against the JAX runner's `_quiet` reduction on
    one state, quiet or with one set byte placed at random in one
    plane."""
    n = 64
    jprog, pprog, jcfg, pcfg = _programs(n)
    jsim = j_make_sim(jprog, jcfg, seed=3, track_edge_send_round=True)
    tree = jax_tree_to_numpy(jsim)
    rng = np.random.default_rng(hash(busy) % 1000)
    where = {"pool": tree["net"]["pool"], "channels": tree["channels"],
             "pending": tree["nodes"], "inflight": tree["nodes"],
             "inflight_old": tree["nodes"]}
    if busy is not None:
        d = where[busy]
        key = "valid" if busy in ("pool", "channels") else busy
        a = d[key].copy()
        a.reshape(-1)[rng.integers(0, a.size)] = True
        d[key] = a
    jq = ~tree["net"]["pool"]["valid"].any() & \
        ~tree["channels"]["valid"].any() & bool(
            jprog.quiescent({k: jnp.asarray(v)
                             for k, v in tree["nodes"].items()}))
    psim = convert.state_from_numpy(tree, pprog, pcfg, device="cpu")
    planes = ([psim.net.pool.valid, psim.channels.valid]
              + pprog.quiet_planes(psim.nodes))
    assert bool(quiet_probe_plain(planes)) == bool(jq) == (busy is None)
    assert bool(quiet_probe(planes)) == bool(jq)
