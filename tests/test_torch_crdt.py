"""The port's CRDT programs (g-set on the broadcast machine, PN- and
g-counter) against the JAX package's, leaf for leaf.

  - `fanout_topology`, the random gossip graph of `gossip_fanout`, drawn
    as the JAX package draws it, and each program's sizing (neighbours,
    degree, lanes, ring, retry period, spill);
  - the PN-counter step (K13's plain version) against
    `PnCounterProgram.edge_step` on random states: 64 nodes of a fanout-3
    graph, the total graph at 5 nodes and spill lanes, with pending bits
    dense on some edges and fewer than `per_nb` on others (the invalid
    lanes JAX's `top_k` fills), a retry round, and the stall mask;
  - g-set and pn-counter rounds through both packages' `make_run_fn`,
    fault-free and under loss and partitions;
  - the scan over the pn-counter round, whose reply log carries the
    int32 payload (K5's int32 form).

Tolerance: exact, on every state leaf (the threefry `key` and every
`NetStats` counter among them), on every field of the step's outputs,
invalid lanes included, on the collected client messages' valid rows and
on the whole reply log."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.net.static import EdgeMsgs as JEdgeMsgs
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.nodes.gset import fanout_topology as j_fanout_topology
from maelstrom_tpu.sim import _freeze_nodes
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_scan_fn as j_make_scan_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.net.static import EdgeMsgs as PEdgeMsgs
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.nodes.gset import fanout_topology
from maelstrom_tpu_torch.sim import (append_replies_plain, empty_reply_log,
                                     make_run_fn as p_make_run_fn,
                                     make_scan_fn as p_make_scan_fn)
from test_torch_faults import _install
from test_torch_kernels_gpu import random_pn_inputs
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

T_ADD, T_READ = 10, 12          # pn-counter; g-set's add is T_BCAST = 10


@pytest.mark.parametrize("n,k,seed", [(20, 3, 11), (64, 3, 0), (1000, 3, 7),
                                      (7, 10, 3), (2, 3, 1)])
def test_fanout_topology_matches_jax(n, k, seed):
    nodes = [f"n{i}" for i in range(n)]
    assert fanout_topology(nodes, k, seed) == j_fanout_topology(nodes, k,
                                                                seed)


@pytest.mark.parametrize("name,n,opts", [
    ("g-set", 20, {"gossip_fanout": 3, "seed": 11}),
    ("g-set", 5, {"topology": "grid"}),
    ("g-set", 6, {}),
    ("pn-counter", 1000, {"gossip_fanout": 3, "seed": 2}),
    ("pn-counter", 5, {"topology": "grid"}),
    ("g-counter", 9, {"gossip_fanout": 3, "latency": {"mean": 3, "dist":
                                                      "uniform"}}),
])
def test_program_sizing_matches_jax(name, n, opts):
    nodes = [f"n{i}" for i in range(n)]
    j = j_get_program(name, opts, nodes)
    p = p_get_program(name, opts, nodes, device="cpu")
    np.testing.assert_array_equal(p.neighbors.numpy(),
                                  np.asarray(j.neighbors))
    np.testing.assert_array_equal(p.rev.numpy(), np.asarray(j.rev))
    assert p.edge_cfg == type(p.edge_cfg)(**vars(j.edge_cfg))
    assert (p.D, p.lanes, p.per_nb, p.retry_rounds, p.inbox_cap,
            p.reply_payload_words) == (j.D, j.lanes, j.per_nb,
                                       j.retry_rounds, j.inbox_cap,
                                       j.reply_payload_words)
    assert_trees_equal(jax_tree_to_numpy(j.init_state()),
                       as_numpy(p.init_state()))


def _pn_programs(n, fanout, **opts):
    nodes = [f"n{i}" for i in range(n)]
    opts = {"gossip_fanout": fanout, **opts}
    return (j_get_program("pn-counter", opts, nodes),
            p_get_program("pn-counter", opts, nodes, device="cpu"))


@pytest.mark.parametrize("n,fanout,opts,rnd", [
    (64, 3, {}, 41), (64, 3, {}, 0), (5, None, {}, 7),
    (12, 3, {"gossip_per_neighbor": 3,
             "latency": {"mean": 3, "dist": "uniform"}}, 30)])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_pn_counter_step_matches_jax(n, fanout, opts, rnd, stalled):
    jprog, pprog = _pn_programs(n, fanout, **opts)
    rng = np.random.default_rng(n + rnd + stalled)
    state, edge_in, client_in = random_pn_inputs(rng, pprog)
    # some edges with fewer pending origins than out lanes, some none
    assert (state["pending"].sum(axis=2) < pprog.per_nb).any()
    stall = rng.random(n) < 0.3
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    jnew, jedge, jclient = jprog.edge_step(
        jstate, JEdgeMsgs(**{k: jnp.asarray(v) for k, v in edge_in.items()}),
        JT.Msgs(**{k: jnp.asarray(v) for k, v in client_in.items()}),
        {"round": jnp.int32(rnd), "key": jax.random.PRNGKey(0)})
    ctx = {"round": torch.tensor(rnd, dtype=torch.int32)}
    if stalled:
        js = jnp.asarray(stall)
        jnew = _freeze_nodes(jprog, js, jstate, jnew)
        jedge = jedge.replace(valid=jedge.valid & ~js[:, None, None])
        jclient = jclient.replace(valid=jclient.valid & ~js[:, None])
        ctx["stall"] = torch.tensor(stall)
    pnew, pedge, pclient = pprog.edge_step(
        {k: torch.tensor(v) for k, v in state.items()},
        PEdgeMsgs(**{k: torch.tensor(v) for k, v in edge_in.items()}),
        convert.msgs_from_numpy(client_in, device="cpu"), ctx)
    assert_trees_equal(jax_tree_to_numpy(jnew), as_numpy(pnew))
    assert_trees_equal(jax_tree_to_numpy(jedge), as_numpy(pedge))
    assert_trees_equal(jax_tree_to_numpy(jclient), as_numpy(pclient))
    out = as_numpy(pedge)
    assert out["valid"].any() and not out["valid"].all()
    # the payload plane and the quiescence planes
    jq = bool(jprog.quiescent(jnew))
    pq = not any(bool(p.any()) for p in pprog.quiet_planes(pnew))
    assert jq == pq
    idx = np.arange(n, dtype=np.int32)
    assert_trees_equal(np.asarray(jprog.reply_payload(jnew,
                                                      jnp.asarray(idx))),
                       pprog.reply_payload_plane(pnew).numpy())


# name: (program, nodes, program opts, latency mean, dist, NetConfig
#        flags, faults installed, rounds)
ROUNDS = {
    "gset20-fanout3": ("g-set", 20, {"gossip_fanout": 3, "seed": 11,
                                     "max_values": 64}, 0, "constant", {},
                       {}, 40),
    "gset20-fanout3-loss": ("g-set", 20, {"gossip_fanout": 3, "seed": 11,
                                          "max_values": 64}, 2, "constant",
                            {}, {"p_loss": 0.05}, 40),
    "pn5": ("pn-counter", 5, {}, 0, "constant", {}, {}, 40),
    "pn20-fanout3-loss-partition": (
        "pn-counter", 20, {"gossip_fanout": 3}, 2, "constant",
        {"partition_groups": 20},
        {"p_loss": 0.05, "grudge": "split_half"}, 40),
    "gcounter12-exponential-stall": (
        "g-counter", 12, {"gossip_fanout": 3}, 2, "exponential",
        {"enable_stall": True}, {"p_loss": 0.02, "down": 0.2}, 40),
}


@functools.lru_cache(maxsize=None)
def _round_setup(name):
    prog, n, popts, lat, dist, flags, _f, _R = ROUNDS[name]
    nodes = [f"n{i}" for i in range(n)]
    opts = {**popts, "latency": {"mean": lat, "dist": dist}}
    jprog = j_get_program(prog, opts, nodes)
    pprog = p_get_program(prog, opts, nodes, device="cpu")
    kw = dict(n_nodes=n, n_clients=3, pool_cap=64,
              inbox_cap=jprog.inbox_cap, client_cap=8,
              latency_mean_rounds=float(lat), latency_dist=dist, **flags)
    return jprog, pprog, JT.NetConfig(**kw), PT.NetConfig(**kw)


def _plan(n, R, M, prog, seed):
    """M client requests a round: adds (g-set: of fresh elements,
    counters: of deltas in [-5, 4]) and reads."""
    rng = np.random.default_rng(seed)
    read = rng.random((R, M)) < 0.3
    rr = np.arange(R)[:, None] * M + np.arange(M)[None, :]
    a = (rr % 64 if prog == "g-set"
         else rng.integers(-5, 5, (R, M)))
    return {"valid": rng.random((R, M)) < 0.7,
            "src": (n + rng.integers(0, 3, (R, M))).astype(np.int32),
            "dest": rng.integers(0, n, (R, M), dtype=np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": np.zeros((R, M), np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": np.where(read, T_READ, T_ADD).astype(np.int32),
            "a": a.astype(np.int32),
            "b": np.zeros((R, M), np.int32), "c": np.zeros((R, M), np.int32)}


@pytest.mark.parametrize("name", list(ROUNDS))
def test_crdt_rounds_match_jax(name):
    jprog, pprog, jcfg, pcfg = _round_setup(name)
    prog, n, _o, _l, _d, _fl, faults, R = ROUNDS[name]
    jsim = j_make_sim(jprog, jcfg, seed=17)
    start = jax_tree_to_numpy(jsim)
    jsim = jsim.replace(net=_install(JT, jsim.net, faults, n, 3))
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    psim = psim.replace(net=_install(PT, psim.net, faults, n, 3))
    plan = _plan(n, R, 3, prog, seed=R + n)
    jsim, jmsgs = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in plan.items()}))
    psim, pmsgs = p_make_run_fn(pprog, pcfg, collect_client_msgs=True,
                                device="cpu")(
        psim, convert.msgs_from_numpy(plan, device="cpu"))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    assert_msgs_equal_on_valid(jmsgs, pmsgs)
    st = JT.stats_dict(jsim.net)
    assert st["sent_servers"] > 0
    if "p_loss" in faults:
        assert st["lost"] > 0
    if "grudge" in faults:
        assert st["dropped_partition"] > 0
    if "down" in faults:
        assert st["dropped_down"] > 0


def test_pn_counter_scan_matches_jax():
    """The scan over pn-counter rounds: every reply row carries the
    serving node's value at its round, one int32 word (K5's int32 form),
    as JAX's `reply_payload` gathers it."""
    jprog, pprog, jcfg, pcfg = _round_setup("pn20-fanout3-loss-partition")
    n = jcfg.n_nodes
    jsim = j_make_sim(jprog, jcfg, seed=2)
    start = jax_tree_to_numpy(jsim)
    out_j = out_p = None
    inj = {k: v[0] for k, v in _plan(n, 1, 3, "pn-counter", 4).items()}
    inj["valid"] = np.ones(3, bool)
    for _ in range(2):      # adds, then reads of their sums
        out_j = j_make_scan_fn(jprog, jcfg, reply_cap=16)(
            jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in inj.items()}),
            jnp.int32(30), False)
        jsim = out_j[0]
        inj["type"] = np.full(3, T_READ, np.int32)
    inj["type"] = np.full(3, T_ADD, np.int32)
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    for _ in range(2):
        out_p = p_make_scan_fn(pprog, pcfg, reply_cap=16, device="cpu",
                               chunk=8)(
            psim, convert.msgs_from_numpy(inj, device="cpu"), 30, False)
        psim = out_p[0]
        inj["type"] = np.full(3, T_READ, np.int32)
    assert out_p[2] == int(out_j[2]) == 30
    assert_trees_equal(jax_tree_to_numpy(out_j[0]), as_numpy(out_p[0]))
    for name, a, b in zip(("rlog", "rounds", "plog", "rn"), out_j[3],
                          out_p[3]):
        assert_trees_equal(as_numpy(a), as_numpy(b), path=name)
    plog = out_p[3][2].numpy()
    assert int(out_p[3][3]) == 3 and plog[:3].any()


def test_append_replies_int32_rows():
    """K5's int32 form, plain: each valid row's payload is the int32 row
    of its clipped source node; rows past the log's end are dropped."""
    rng = np.random.default_rng(1)
    N, W, CW, rcap = 7, 2, 12, 10
    rows = rng.integers(-2**31, 2**31, (N, W), dtype=np.int64).astype(
        np.int32)
    cm = convert.msgs_from_numpy({
        "valid": rng.random(CW) < 0.7,
        "src": rng.integers(-2, N + 2, CW, dtype=np.int32),
        **{f: rng.integers(0, 9, CW, dtype=np.int32)
           for f in ("dest", "due", "mid", "reply_to", "type", "a", "b",
                     "c")}}, device="cpu")
    log = empty_reply_log(rcap, W, "cpu")
    log = log[:3] + (torch.tensor(4, dtype=torch.int32),)
    exit_k = torch.tensor(2**31 - 1, dtype=torch.int32)
    rn = append_replies_plain(log, cm, torch.tensor(rows), N,
                              torch.tensor(5, dtype=torch.int32), 1, 9,
                              False, exit_k)
    valid = cm.valid.numpy()
    src = np.clip(cm.src.numpy()[valid], 0, N - 1)
    kept = min(len(src), rcap - 4)
    assert int(rn) == 4 + valid.sum()
    np.testing.assert_array_equal(log[2].numpy()[4:4 + kept],
                                  rows[src[:kept]])
    assert not log[2].numpy()[:4].any()
    assert int(exit_k) == 1     # the log has no room for another round
