"""The port's Raft program (`maelstrom_tpu_torch/nodes/raft.py`, kernel
K10 raft_step, with and without the stall mask) against the JAX
package's `RaftProgram.edge_step`, on random states, lanes and client
slots, for one cluster and for a batch of clusters under `vmap`.
Tolerance: exact, on every state leaf, every edge-out lane and every
client reply field (all int32 or bool; the election jitter is bit-exact
threefry)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net.static import EdgeMsgs as JEdgeMsgs
from maelstrom_tpu.net.tpu import Msgs as JMsgs
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.sim import _freeze as j_freeze
from maelstrom_tpu_torch import prng
from maelstrom_tpu_torch.net.static import EdgeMsgs as PEdgeMsgs
from maelstrom_tpu_torch.net.tpu import Msgs as PMsgs
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.nodes import raft as R
from test_torch_kernels_gpu import random_raft_inputs as random_step_inputs
from test_torch_support import as_numpy, assert_trees_equal

MSG_FIELDS = ("valid", "src", "dest", "due", "mid", "reply_to", "type", "a",
              "b", "c")


def programs(n, **opts):
    nodes = [f"n{i}" for i in range(n)]
    opts = {"latency": {"mean": 0}, **opts}
    return (j_get_program("lin-kv", opts, nodes),
            p_get_program("lin-kv", opts, nodes, device="cpu"))


def jax_step(jprog, state, edge_in, client_in, rnd, key, stall=None):
    """JAX's step (under `vmap` when the leaves lead with a cluster
    axis), then the JAX round's freeze of stalled nodes."""
    def one(st, ei, ci, r, k, stl):
        new, eo, co = jprog.edge_step(st, ei, ci, {"round": r, "key": k})
        if stl is None:
            return new, eo, co
        return (j_freeze(stl, st, new),
                eo.replace(valid=eo.valid & ~stl[:, None, None]),
                co.replace(valid=co.valid & ~stl[:, None]))
    args = ({k: jnp.asarray(v) for k, v in state.items()},
            JEdgeMsgs(**{k: jnp.asarray(v) for k, v in edge_in.items()}),
            JMsgs(**{k: jnp.asarray(v) for k, v in client_in.items()}),
            jnp.asarray(rnd, jnp.int32), jnp.asarray(key, jnp.uint32),
            None if stall is None else jnp.asarray(stall))
    if np.ndim(rnd) == 0:
        return one(*args)
    return jax.vmap(one)(*args)


def port_step(pprog, state, edge_in, client_in, rnd, key, stall=None):
    """The port's step: `edge_step` for one cluster; for F clusters
    `step_rows` over the F * N rows, its outputs back at [F, N, ...]."""
    if np.ndim(rnd) == 0:
        ctx = {"round": torch.tensor(rnd, dtype=torch.int32),
               "key": torch.tensor(np.asarray(key, np.uint32))}
        if stall is not None:
            ctx["stall"] = torch.tensor(stall)
        return pprog.edge_step(
            {k: torch.tensor(v) for k, v in state.items()},
            PEdgeMsgs(**{k: torch.tensor(v) for k, v in edge_in.items()}),
            PMsgs(**{k: torch.tensor(v) for k, v in client_in.items()}), ctx)
    F, N = np.shape(rnd)[0], pprog.n_nodes

    def rows(v):
        v = torch.tensor(v)
        return v.reshape((F * N,) + tuple(v.shape[2:]))

    def back(t):
        return t.reshape((F, N) + tuple(t.shape[1:]))
    new, eo, co = pprog.step_rows(
        {k: rows(v) for k, v in state.items()},
        PEdgeMsgs(**{k: rows(v) for k, v in edge_in.items()}),
        PMsgs(**{k: rows(v) for k, v in client_in.items()}),
        torch.tensor(rnd, dtype=torch.int32),
        torch.tensor(np.asarray(key, np.uint32)),
        None if stall is None else rows(stall))
    return ({k: back(v) for k, v in new.items()},
            PEdgeMsgs(**{f: back(getattr(eo, f)) for f in
                         ("valid", "type", "a", "b", "c")}),
            PMsgs(**{f: back(getattr(co, f)) for f in MSG_FIELDS}))


def assert_step_equal(ref, got):
    for name, r, g in zip(("state", "edge_out", "client_out"), ref, got):
        r, g = as_numpy(r), as_numpy(g)
        if name == "edge_out":
            r.pop("sent", None)
            g.pop("sent", None)
        assert_trees_equal(r, g, path=name)


def raw_key(seed):
    return np.asarray(jax.random.PRNGKey(seed), np.uint32)


@pytest.mark.parametrize("n", [5, 3, 7])
@pytest.mark.parametrize("stalled", [False, True])
def test_edge_step_matches_jax(n, stalled):
    jprog, pprog = programs(n, log_cap=40, kv_keys=16)
    rng = np.random.default_rng(100 + n + 10 * stalled)
    for rnd in (40, 48):        # a heartbeat round and another
        state, edge_in, client_in = random_step_inputs(rng, pprog, rnd=rnd)
        stall = rng.random(n) < 0.4 if stalled else None
        key = raw_key(rnd)
        ref = jax_step(jprog, state, edge_in, client_in, rnd, key, stall)
        got = port_step(pprog, state, edge_in, client_in, rnd, key, stall)
        assert_step_equal(ref, got)


@pytest.mark.parametrize("stalled", [False, True])
def test_edge_step_clusters_matches_vmap(stalled):
    """F clusters stepped as F * N rows equal JAX's step under `vmap`,
    each cluster with its own round and key."""
    F, n = 4, 5
    jprog, pprog = programs(n, log_cap=24, kv_keys=8, inbox_cap=3)
    rng = np.random.default_rng(7 + stalled)
    state, edge_in, client_in = random_step_inputs(rng, pprog, lead=(F,))
    rnd = np.array([40, 41, 72, 45], np.int32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), F), np.uint32)
    stall = rng.random((F, n)) < 0.3 if stalled else None
    ref = jax_step(jprog, state, edge_in, client_in, rnd, keys, stall)
    got = port_step(pprog, state, edge_in, client_in, rnd, keys, stall)
    assert_step_equal(ref, got)


def test_election_jitter_matches_jax():
    """The jitter the step draws, randint(fold_in(k2, 17), (N,), 0,
    election), for a batch of keys in one pass."""
    _jprog, pprog = programs(5)
    jkeys = jax.random.split(jax.random.PRNGKey(11), 6)
    want = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(k, 17), (5,), 0, pprog.election)) for k in jkeys])
    got = pprog._jitter(torch.tensor(np.asarray(jkeys, np.uint32)), 6)
    assert np.array_equal(got.numpy().reshape(6, 5), want)
    one = prng.randint(prng.fold_in(torch.tensor(np.asarray(
        jkeys[2], np.uint32)), 17), (5,), 0, pprog.election)
    assert np.array_equal(one.numpy(), want[2])


def test_program_surface_matches_jax():
    """Sizing, initial state, the wire vocabulary and the flags the
    runner and the round read."""
    opts = {"latency": {"mean": 5, "dist": "exponential"}, "rate": 20,
            "time_limit": 2, "nemesis": {"duplicate"}}
    jprog, pprog = programs(5, **opts)
    for attr in ("D", "E", "lanes", "cap", "keys", "ring", "election",
                 "heartbeat", "inbox_cap", "outbox_cap", "durable_keys",
                 "edge_atomic_rpc", "tolerates_channel_overwrites",
                 "needs_state_reads"):
        assert getattr(jprog, attr) == getattr(pprog, attr), attr
    assert pprog.ring == 404
    assert jprog.edge_cfg == type(jprog.edge_cfg)(
        **{f: getattr(pprog.edge_cfg, f) for f in
           ("n_nodes", "degree", "lanes", "ring", "uniform_arrival")})
    assert np.array_equal(np.asarray(jprog.neighbors),
                          pprog.neighbors.numpy())
    assert np.array_equal(np.asarray(jprog.rev), pprog.rev.numpy())
    assert_trees_equal(as_numpy(jprog.init_state()),
                       as_numpy(pprog.init_state()))
    ops = [{"f": "read", "value": [3, None]}, {"f": "write", "value": [1, 4]},
           {"f": "cas", "value": [2, [0, 3]]}]
    for op in ops:
        body = pprog.request_for_op(op)
        assert body == jprog.request_for_op(op)
        assert pprog.encode_body(body, None) == jprog.encode_body(body, None)
    for words in ((R.T_READ_OK, 4, 0, 0), (R.T_WRITE_OK, 0, 0, 0),
                  (R.T_CAS_OK, 0, 0, 0), (1, 11, 0, 0), (1, 22, 0, 0)):
        body = pprog.decode_body(*words, None)
        assert body == jprog.decode_body(*words, None)
        assert (pprog.completion(ops[0], body, None, None)
                == jprog.completion(ops[0], body, None, None))
    st = pprog.init_state()
    st["log_overflow"][2] = 3
    assert int(pprog.invalid_counters(st)["log-overflow"].sum()) == 3
    assert pprog.quiet_planes is None


def test_restore_keeps_durable_keys():
    """Crash-restart rebuilds the volatile state and keeps the log, term
    and vote, as the JAX package's restore does."""
    jprog, pprog = programs(5, log_cap=16, kv_keys=8)
    rng = np.random.default_rng(5)
    state, _e, _c = random_step_inputs(rng, pprog)
    mask = np.array([True, False, True, False, False])
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    ref = jprog.restore(jprog.init_state(), jprog.durable_view(jst), jst,
                        jnp.asarray(mask))
    pst = {k: torch.tensor(v) for k, v in state.items()}
    got = pprog.restore(pprog.init_state(), pprog.durable_view(pst), pst,
                        torch.tensor(mask))
    assert_trees_equal(as_numpy(ref), as_numpy(got))


def _linkv_plan(rng, n, R, M):
    """Client reads, writes and CASes on 4 keys, into random nodes."""
    return {"valid": rng.random((R, M)) < 0.3,
            "src": (n + rng.integers(0, 3, (R, M))).astype(np.int32),
            "dest": rng.integers(0, n, (R, M), dtype=np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": (np.arange(R * M).reshape(R, M) + 1).astype(np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": np.array([R_.T_READ, R_.T_WRITE, R_.T_CAS], np.int32)[
                rng.integers(0, 3, (R, M))],
            "a": rng.integers(0, 4, (R, M), dtype=np.int32),
            "b": rng.integers(0, 5, (R, M), dtype=np.int32),
            "c": rng.integers(0, 5, (R, M), dtype=np.int32)}


R_ = R


def test_faulty_cluster_rounds_match_jax():
    """One 5-node cluster under exponential latency, loss, a directional
    partition, a kill with restart from the durable store, a pause and
    duplication: the rounds leaf for leaf with JAX's, the key and every
    NetStats counter included, and the faults show."""
    import random

    from maelstrom_tpu import nemesis as jnem
    from maelstrom_tpu.net import tpu as JT
    from maelstrom_tpu.sim import make_run_fn as j_run_fn
    from maelstrom_tpu.sim import make_sim as j_make_sim
    from maelstrom_tpu_torch import convert
    from maelstrom_tpu_torch.net import tpu as PT
    from maelstrom_tpu_torch.sim import make_run_fn as p_run_fn
    from test_torch_support import assert_msgs_equal_on_valid, \
        jax_tree_to_numpy

    n = 5
    opts = {"latency": {"mean": 3, "dist": "exponential"}, "rate": 20,
            "time_limit": 1, "nemesis": {"duplicate", "kill", "partition"}}
    jprog, pprog = programs(n, **opts)
    kw = dict(n_nodes=n, n_clients=3, pool_cap=64,
              inbox_cap=jprog.inbox_cap, client_cap=10,
              latency_mean_rounds=3.0, latency_dist="exponential",
              partition_groups=n, enable_stall=True,
              enable_duplication=True)
    jcfg, pcfg = JT.NetConfig(**kw), PT.NetConfig(**kw)
    nodes = [f"n{i}" for i in range(n)]
    _name, grudge = jnem.split_half(nodes, random.Random(4))
    groups, matrix = jnem.grudge_matrix(nodes, grudge)
    rng = np.random.default_rng(9)
    down = np.array([False, False, True, False, False])
    paused = np.array([False, False, False, False, True])

    def faults(T, net, stage):
        net = T.set_duplication(T.flaky(net, 0.05), 0.3)
        if stage == 1:
            net = T.partition_grudge(net, groups, matrix)
            net = T.set_paused(T.set_down(net, down), paused)
        return net

    jsim = j_make_sim(jprog, jcfg, seed=21)
    psim = convert.state_from_numpy(jax_tree_to_numpy(jsim), pprog, pcfg,
                                    device="cpu")
    jrun, prun = (j_run_fn(jprog, jcfg, collect_client_msgs=True),
                  p_run_fn(pprog, pcfg, collect_client_msgs=True,
                           device="cpu"))
    for stage, R in ((0, 70), (1, 60), (2, 70)):
        if stage == 2:      # heal, resume, restart the killed node
            jsim = jsim.replace(net=JT.heal(JT.set_paused(
                jsim.net, np.zeros(n, bool))))
            psim = psim.replace(net=PT.heal(PT.set_paused(
                psim.net, np.zeros(n, bool))))
            jn = jprog.restore(jprog.init_state(), jsim.durable, jsim.nodes,
                               jnp.asarray(down))
            jsim = jsim.replace(nodes=jn, durable=jprog.durable_view(jn),
                                net=JT.set_down(jsim.net, np.zeros(n, bool)))
            pn = pprog.restore(pprog.init_state(), psim.durable, psim.nodes,
                               torch.tensor(down))
            psim = psim.replace(nodes=pn, durable=pprog.durable_view(pn),
                                net=PT.set_down(psim.net, np.zeros(n, bool)))
        else:
            jsim = jsim.replace(net=faults(JT, jsim.net, stage))
            psim = psim.replace(net=faults(PT, psim.net, stage))
        plan = _linkv_plan(rng, n, R, 3)
        jsim, jm = jrun(jsim, JMsgs(**{k: jnp.asarray(v)
                                       for k, v in plan.items()}))
        psim, pm = prun(psim, convert.msgs_from_numpy(plan, device="cpu"))
        assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim),
                           path=f"stage{stage}")
        assert_msgs_equal_on_valid(jm, pm)
    st = PT.stats_dict(psim.net)
    for k in ("lost", "dropped_partition", "dropped_down", "duplicated"):
        assert st[k] > 0, k
    roles = psim.nodes["role"].numpy()
    assert (roles == R_.LEADER).sum() >= 1
