"""The port's kafka program against the JAX package's, leaf for leaf.

  - the program's sizing and refusals (keys, groups, members, log cap);
  - the wire helpers (`_pack_offsets`, `_unpack_offsets`,
    `_unpack_assign`, `_device_pack`, `_pack_assign`, `_assign_members`);
  - the step (K14's plain version) against `KafkaProgram.edge_step` on
    random states and inboxes (`random_kafka_inputs`): classic at the
    challenge-5b shape and with 6 keys; group mode with joins, evictions,
    fenced and banked commits, fetches and lists; with and without the
    stall mask (JAX's `_freeze_nodes`);
  - the host boundary: `request_for_op`, `encode_body`, `decode_body` and
    `completion` with a `read_state`, the consumer sessions among them;
  - R rounds of the simulation from one converted state (random kafka
    state, group mode's bool `gactive` among it) through both packages'
    `make_run_fn`, fault-free and under loss, latency, a partition and
    stalled nodes.

Tolerance: exact, on every state leaf (the threefry `key` and every
`NetStats` counter among them), on every field of the step's outputs and
on the collected client messages' valid rows."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.net.static import EdgeMsgs as JEdgeMsgs
from maelstrom_tpu.nodes import Intern as JIntern
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.nodes import kafka as JK
from maelstrom_tpu.sim import _freeze_nodes
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.net.static import EdgeMsgs as PEdgeMsgs
from maelstrom_tpu_torch.nodes import Intern as PIntern
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.nodes import kafka as PK
from maelstrom_tpu_torch.sim import make_run_fn as p_make_run_fn
from test_torch_faults import _install
from test_torch_kernels_gpu import KAFKA_SHAPES, random_kafka_inputs
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)


def _programs(n, **opts):
    nodes = [f"n{i}" for i in range(n)]
    return (j_get_program("kafka", opts, nodes),
            p_get_program("kafka", opts, nodes, device="cpu"))


@pytest.mark.parametrize("shape", list(KAFKA_SHAPES))
def test_program_sizing_matches_jax(shape):
    n, opts = KAFKA_SHAPES[shape]
    j, p = _programs(n, **opts)
    np.testing.assert_array_equal(p.neighbors.numpy(),
                                  np.asarray(j.neighbors))
    np.testing.assert_array_equal(p.rev.numpy(), np.asarray(j.rev))
    assert p.edge_cfg == type(p.edge_cfg)(**vars(j.edge_cfg))
    assert (p.K, p.cap, p.D, p.lanes, p.inbox_cap, p.beat_rounds, p.G) \
        == (j.K, j.cap, j.D, j.lanes, j.inbox_cap, j.beat_rounds, j.G)
    if p.G:
        assert (p.M, p.session_rounds, p.poll_batch) == \
            (j.M, j.session_rounds, j.poll_batch)
    assert_trees_equal(jax_tree_to_numpy(j.init_state()),
                       as_numpy(p.init_state()))


@pytest.mark.parametrize("opts,match", [
    ({"kafka_groups": 2, "key_count": 9}, "keys"),
    ({"kafka_groups": 17}, "kafka_groups"),
    ({"key_count": 7}, "keys"),
    ({"kafka_groups": 1, "concurrency": 255}, "member field"),
    ({"log_cap": 0x7FFF}, "log_cap"),
    ({"latency": {"mean": 2, "dist": "uniform"}, "nemesis": {"duplicate"}},
     None),
])
def test_refusals_match_jax(opts, match):
    nodes = [f"n{i}" for i in range(5)]
    if match is None:           # accepted by both
        j_get_program("kafka", opts, nodes)
        p_get_program("kafka", opts, nodes, device="cpu")
        return
    with pytest.raises(ValueError, match=match):
        j_get_program("kafka", opts, nodes)
    with pytest.raises(ValueError, match=match):
        p_get_program("kafka", opts, nodes, device="cpu")


def test_wire_helpers_match_jax():
    rng = np.random.default_rng(3)
    for keys, base in ((6, 0), (4, 0), (4, 4), (3, 4), (1, 0)):
        offs = {str(base + j): int(rng.integers(0, 0x7FFF))
                for j in range(keys) if rng.random() < 0.7}
        words = PK._pack_offsets(offs, keys, base)
        assert words == JK._pack_offsets(offs, keys, base)
        a, b, c = words
        assert PK._unpack_offsets(a, b, c, keys, base) == \
            JK._unpack_offsets(a, b, c, keys, base) == offs
    with pytest.raises(PK.EncodeCapacityError):
        PK._pack_offsets({"0": 0x7FFF}, 1)
    for _ in range(50):
        b, c = (int(x) for x in rng.integers(-2**31, 2**31, 2))
        assert PK._unpack_assign(b, c, 8) == JK._unpack_assign(b, c, 8)
    vals = rng.integers(0, 0x8000, (9, 8)).astype(np.int32)
    for k in (2, 5, 6, 8):
        got = PK._device_pack(torch.tensor(vals[:, :k]))
        ref = JK._device_pack(jnp.asarray(vals[:, :k]))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the assignment by member rank, and its packing (8-bit fields; the
    # top field wraps to the sign, as JAX's int32 shift does)
    for M, K in ((254, 8), (3, 8), (40, 5), (1, 4)):
        j, p = _programs(5, kafka_groups=2, concurrency=M, key_count=K)
        act = rng.random((6, M)) < rng.choice([0.0, 0.02, 0.5, 1.0],
                                              (6, 1))
        asg = p._assign_members(torch.tensor(act))
        np.testing.assert_array_equal(
            asg.numpy(), np.asarray(j._assign_members(jnp.asarray(act))))
        for g, r in zip(p._pack_assign(asg),
                        j._pack_assign(jnp.asarray(asg.numpy()))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("shape", list(KAFKA_SHAPES))
@pytest.mark.parametrize("rnd", [64, 37])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_kafka_step_matches_jax(shape, rnd, stalled):
    n, opts = KAFKA_SHAPES[shape]
    jprog, pprog = _programs(n, **opts)
    rng = np.random.default_rng(n + rnd + stalled)
    state, edge_in, client_in = random_kafka_inputs(rng, pprog, rnd)
    stall = rng.random(n) < 0.4
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
    pstate = {k: torch.tensor(v) for k, v in state.items()}
    pnew, pedge, pclient = pprog.edge_step(
        pstate, PEdgeMsgs(**{k: torch.tensor(v) for k, v in edge_in.items()}),
        convert.msgs_from_numpy(client_in, device="cpu"), ctx)
    assert_trees_equal(jax_tree_to_numpy(jnew), as_numpy(pnew))
    assert_trees_equal(jax_tree_to_numpy(jedge), as_numpy(pedge))
    assert_trees_equal(jax_tree_to_numpy(jclient), as_numpy(pclient))
    # the input state is never updated
    assert_trees_equal(state, as_numpy(pstate))
    assert as_numpy(pedge)["valid"].any()


def test_group_step_covers_the_protocol():
    """On group-mode inputs whose requests all reach the coordinator, the
    JAX-equal step answers with every group reply type: subscribe_ok,
    fetch_ok, rebalance (fenced commits), commit_ok and list_ok, and
    evicts members (generations bump)."""
    n, opts = KAFKA_SHAPES["odd-groups"]
    jprog, pprog = _programs(n, **opts)
    rng = np.random.default_rng(5)
    seen = set()
    for rnd in (64, 37, 12):
        state, edge_in, client_in = random_kafka_inputs(rng, pprog, rnd)
        new, _e, cout = pprog.edge_step(
            {k: torch.tensor(v) for k, v in state.items()},
            PEdgeMsgs(**{k: torch.tensor(v) for k, v in edge_in.items()}),
            convert.msgs_from_numpy(client_in, device="cpu"),
            {"round": torch.tensor(rnd, dtype=torch.int32)})
        jnew, _je, jcout = jprog.edge_step(
            {k: jnp.asarray(v) for k, v in state.items()},
            JEdgeMsgs(**{k: jnp.asarray(v) for k, v in edge_in.items()}),
            JT.Msgs(**{k: jnp.asarray(v) for k, v in client_in.items()}),
            {"round": jnp.int32(rnd), "key": jax.random.PRNGKey(0)})
        assert_trees_equal(jax_tree_to_numpy(jcout), as_numpy(cout))
        assert_trees_equal(jax_tree_to_numpy(jnew), as_numpy(new))
        valid = cout.valid.numpy()
        seen |= set(cout.type.numpy()[valid].tolist())
        assert (new["ggen"].numpy() > state["ggen"]).any()
    assert {PK.T_SUB_OK, PK.T_FETCH_OK, PK.T_REBAL, PK.T_GLIST_OK,
            PK.T_SEND_OK, 1} <= seen, seen


def _host_ops(groups, keys, rng, n_ops=120):
    """A stream of ops (with processes) for the host-boundary test."""
    ops = []
    counter = 0
    for i in range(n_ops):
        p = int(rng.integers(0, 6))
        r = rng.random()
        if r < 0.35:
            counter += 1
            k = int(rng.integers(-1, keys + 1)) if rng.random() < 0.1 \
                else counter % keys
            ops.append({"f": "send", "value": [k, counter], "process": p})
        elif r < 0.6:
            ops.append({"f": "poll", "process": p})
        elif r < 0.8:
            ops.append({"f": "commit", "process": p})
        elif r < 0.9 and groups:
            ops.append({"f": "subscribe", "process": p})
        else:
            ops.append({"f": "list", "process": p})
    return ops


def _reply_for(prog, body, rng, log_len):
    """A plausible reply (t, a, b, c) to an encoded request, in the wire
    forms the step produces."""
    t = body[0]
    K = prog.K
    gen = int(rng.integers(0, 5))
    asg = rng.integers(-1, 6, K)
    ab = ac = 0
    for k in range(K):
        f = int(asg[k]) + 1 if asg[k] >= 0 else 0
        if k < 4:
            ab |= f << (8 * k)
        else:
            ac |= f << (8 * (k - 4))
    ab, ac = (w - 2**32 if w >= 2**31 else w for w in (ab, ac))
    if rng.random() < 0.1:
        return (1, int(rng.choice([11, 14])), 0, 0)
    if t == PK.T_SEND:
        return (PK.T_SEND_OK, int(rng.integers(0, 40)), 0, 0)
    if t == PK.T_POLL:
        lens = {str(k): int(log_len[k]) - 1 for k in range(K)
                if log_len[k]}
        return (PK.T_POLL_OK, *PK._pack_offsets(lens, min(K, 6)))
    if t in (PK.T_COMMIT, PK.T_LIST):
        return (t + 1, body[1], body[2], body[3])
    if t == PK.T_SUB:
        return (PK.T_SUB_OK, gen, ab, ac)
    if t == PK.T_FETCH:
        key, cur = body[2] >> 16, (body[2] & 0xFFFF) - 1
        n = max(0, min(int(log_len[key]) - cur, body[3]))
        return (PK.T_FETCH_OK, body[2], n, 0)
    if t == PK.T_GCOMMIT:
        if rng.random() < 0.3:
            return (PK.T_REBAL, gen + 1, ab, ac)
        return (PK.T_GCOMMIT_OK, (body[1] >> 30 << 30) | gen, body[2],
                body[3])
    if t == PK.T_GLIST:
        return (PK.T_GLIST_OK, (body[1] >> 30 << 30) | gen,
                *PK._pack_offsets({str(k): int(rng.integers(0, 30))
                                   for k in range(K)}, 2,
                                  base=4 * (body[1] >> 30))[:2])
    raise AssertionError(t)


@pytest.mark.parametrize("groups,keys", [(0, 4), (0, 6), (2, 4), (3, 8)])
def test_host_boundary_matches_jax(groups, keys):
    """Routing, requests, encodings, reply decodes and completions (with a
    read_state serving a replica's log) through both programs, op by op,
    with the host sessions (polled offsets, consumer subscriptions,
    cursors, known floors, list bank) compared after every op."""
    opts = {"key_count": keys, "kafka_groups": groups, "concurrency": 6,
            "log_cap": 64}
    jprog, pprog = _programs(5, **opts)
    rng = np.random.default_rng(groups * 10 + keys)
    ji, pi = JIntern(), PIntern()
    log = rng.integers(0, 50, (keys, 64)).astype(np.int32)
    for v in range(60):
        assert ji.id(v) == pi.id(v)
    log_len = rng.integers(0, 64, keys)
    row = {"log": log, "log_len": log_len.astype(np.int32)}
    for op in _host_ops(groups, keys, rng):
        assert pprog.node_for_op(op) == jprog.node_for_op(op)
        jb, pb = jprog.request_for_op(op), pprog.request_for_op(op)
        assert pb == jb
        try:
            jw = jprog.encode_body(jb, ji)
        except JK.EncodeCapacityError as e:
            with pytest.raises(PK.EncodeCapacityError, match=str(e)[:20]):
                pprog.encode_body(pb, pi)
            continue
        assert pprog.encode_body(pb, pi) == jw
        reply = _reply_for(pprog, jw, rng, log_len)
        jbody = jprog.decode_body(*reply, ji)
        pbody = pprog.decode_body(*reply, pi)
        assert pbody == jbody
        if jbody["type"] == "error":
            continue
        reads = []

        def read_state(reads=reads):
            reads.append(1)
            return row
        jc = jprog.completion(op, jbody, read_state, ji)
        pc = pprog.completion(op, pbody, read_state, pi)
        assert pc == jc
        assert pprog.host_state() == jprog.host_state()
    if groups:
        assert pprog._subs, "no consumer session was opened"
    else:
        assert pprog._host_polled


# name: (nodes, program opts, latency mean, dist, NetConfig flags, faults,
#        rounds)
ROUNDS = {
    "classic5": (5, {}, 0, "constant", {}, {}, 40),
    "classic5-loss-latency-partition": (
        5, {}, 2, "uniform", {}, {"p_loss": 0.1, "components": True}, 40),
    "groups5-stall": (5, {"kafka_groups": 2, "concurrency": 5}, 2,
                      "exponential", {"enable_stall": True},
                      {"p_loss": 0.05, "down": 0.3}, 40),
    "wide8-groups": (8, {"kafka_groups": 3, "key_count": 8,
                         "concurrency": 12}, 1, "constant", {},
                     {"p_loss": 0.05}, 40),
}


@functools.lru_cache(maxsize=None)
def _round_setup(name):
    n, popts, lat, dist, flags, _f, _R = ROUNDS[name]
    opts = {"log_cap": 64, **popts, "latency": {"mean": lat, "dist": dist}}
    jprog, pprog = _programs(n, **opts)
    kw = dict(n_nodes=n, n_clients=3, pool_cap=64,
              inbox_cap=jprog.inbox_cap, client_cap=8,
              latency_mean_rounds=float(lat), latency_dist=dist, **flags)
    return jprog, pprog, JT.NetConfig(**kw), PT.NetConfig(**kw)


def _plan(prog, R, M, seed):
    """M client requests a round, to random nodes: sends (to owners and
    not), polls, commits and lists, and in group mode subscribes,
    fetches, banked commits and lists."""
    rng = np.random.default_rng(seed)
    n, K, G = prog.n_nodes, prog.K, prog.G
    kinds = ([10, 10, 10, 12, 14, 16] if not G
             else [10, 10, 10, 30, 32, 32, 34, 37])
    ty = rng.choice(np.array(kinds), (R, M))
    a = np.zeros((R, M), np.int64)
    b = np.zeros((R, M), np.int64)
    c = np.zeros((R, M), np.int64)
    key = rng.integers(0, K, (R, M))
    a = np.where(ty == 10, key, a)
    b = np.where(ty == 10, rng.integers(0, 50, (R, M)), b)
    small = rng.integers(0, 20, (R, M)) | (rng.integers(0, 20, (R, M)) << 16)
    a = np.where(ty == 14, small, a)
    b = np.where(ty == 14, small, b)
    if G:
        g = rng.integers(0, G, (R, M))
        m = rng.integers(0, prog.M, (R, M))
        a = np.where((ty == 30) | (ty == 32), (g << 10) | m, a)
        b = np.where(ty == 32, (key << 16) | rng.integers(1, 6, (R, M)), b)
        c = np.where(ty == 32, 4, c)
        bank = rng.integers(0, 2, (R, M)) if K > 4 else 0
        a = np.where(ty == 34, (bank << 30) | (g << 26) | (m << 16)
                     | rng.integers(0, 3, (R, M)), a)
        b = np.where(ty == 34, small, b)
        a = np.where(ty == 37, (bank << 30) | g, a)
    dest = np.where(ty == 10, key % n, rng.integers(0, n, (R, M)))
    dest = np.where((ty >= 14) & (ty != 32) & (rng.random((R, M)) < 0.7),
                    0, dest)
    return {"valid": rng.random((R, M)) < 0.7,
            "src": (n + rng.integers(0, 3, (R, M))).astype(np.int32),
            "dest": dest.astype(np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": np.zeros((R, M), np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": ty.astype(np.int32), "a": a.astype(np.int32),
            "b": b.astype(np.int32), "c": c.astype(np.int32)}


@pytest.mark.parametrize("name", list(ROUNDS))
def test_kafka_rounds_match_jax(name):
    jprog, pprog, jcfg, pcfg = _round_setup(name)
    n, _o, _l, _d, _fl, faults, R = ROUNDS[name]
    jsim = j_make_sim(jprog, jcfg, seed=17)
    # one random kafka state (the group planes among it) for both
    rng = np.random.default_rng(R + n)
    state, _e, _c = random_kafka_inputs(rng, pprog, 40)
    state["log_len"] = np.minimum(state["log_len"], 8)
    state["peer_len"] = np.minimum(state["peer_len"], 8)
    jsim = jsim.replace(nodes={k: jnp.asarray(v) for k, v in state.items()})
    start = jax_tree_to_numpy(jsim)
    jsim = jsim.replace(net=_install(JT, jsim.net, faults, n, 3))
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    psim = psim.replace(net=_install(PT, psim.net, faults, n, 3))
    plan = _plan(pprog, R, 3, seed=R + n)
    jsim, jmsgs = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in plan.items()}))
    psim, pmsgs = p_make_run_fn(pprog, pcfg, collect_client_msgs=True,
                                device="cpu")(
        psim, convert.msgs_from_numpy(plan, device="cpu"))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    assert_msgs_equal_on_valid(jmsgs, pmsgs)
    st = JT.stats_dict(jsim.net)
    assert st["sent_servers"] > 0
    assert (np.asarray(jsim.nodes["log_len"]) > state["log_len"]).any()
    if "p_loss" in faults:
        assert st["lost"] > 0
    if faults.get("components"):
        assert st["dropped_partition"] > 0
    if "down" in faults:
        assert st["dropped_down"] > 0
