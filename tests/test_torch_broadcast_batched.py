"""The port's batched atomic broadcast (`maelstrom_tpu_torch/nodes/
broadcast_batched.py`, kernel K15's plain version) against the JAX
package's, on the CPU.

The step on random states and inboxes (ranges at and past both ends of
the table, digests of every window, client batches, stray types), with
and without the stall mask, and at a 70,000-value table where the
proof's int32 sum wraps; whole rounds of 5- and 25-node grids for 50+
rounds under loss, partitions, duplication and stall with the units
counters; the host halves, the distiller and the proof checker.
Tolerance: exact, on every state leaf, every edge lane field and every
client field, valid or not."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ops_projection
from maelstrom_tpu import generators as jg
from maelstrom_tpu.checkers import set_full as jsf
from maelstrom_tpu.history import History as JHistory
from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.net.static import EdgeMsgs as JEdgeMsgs
from maelstrom_tpu.nodes import Intern as JIntern
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.sim import _freeze_nodes
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch import generators as pg
from maelstrom_tpu_torch.checkers import set_full as psf
from maelstrom_tpu_torch.history import History as PHistory
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.net.static import EdgeMsgs as PEdgeMsgs
from maelstrom_tpu_torch.nodes import EncodeCapacityError, Intern
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from test_torch_faults import _install
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

T_BATCH, T_BREAD, T_GRANGE, T_DIGEST = 20, 22, 24, 15


def _programs(n, V, per_nb=None, eager=False, **extra):
    nodes = [f"n{i}" for i in range(n)]
    opts = {"topology": "grid", "max_values": V, "latency": {"mean": 0},
            "eager_resend": eager, **extra}
    if per_nb is not None:
        opts["gossip_per_neighbor"] = per_nb
    return (j_get_program("broadcast-batched", opts, nodes),
            p_get_program("broadcast-batched", opts, nodes, device="cpu"))


def random_batched_inputs(rng, prog, span=16):
    """A step's inputs: pending planes of sparse, half and dense runs,
    range lanes at and past both ends (some of the whole table), digests
    of every window and past the last, stray lane types; client batches
    of up to `span` ids (some of the whole table when `span` >= V),
    reads and stray types."""
    N, D, V, W = prog.n_nodes, prog.D, prog.V, prog.n_windows
    L = prog.edge_cfg.lanes
    dens = np.array([0.02, 0.5, 0.97])[rng.integers(0, 3, (N, D, 1))]
    state = {"seen": rng.random((N, V)) < 0.3,
             "pending": rng.random((N, D, V)) < dens,
             "inflight": rng.random((N, D, V)) < 0.2,
             "inflight_old": rng.random((N, D, V)) < 0.2,
             "owed": rng.random((N, D, W)) < 0.3}
    shape = (N, D, L)
    typ = rng.choice(np.array([T_GRANGE, T_GRANGE, T_DIGEST, 14, 0],
                              np.int32), shape)
    words = [rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
        np.int32) for _ in range(2)]
    a = np.where(typ == T_DIGEST, rng.integers(0, W + 1, shape),
                 rng.integers(-2, V + 3, shape)).astype(np.int32)
    b = np.where(rng.random(shape) < 0.1, V + 5,
                 rng.integers(-2, max(V // 8, 4), shape))
    b = np.where(typ == T_DIGEST, words[0], b).astype(np.int32)
    edge_in = {"valid": rng.random(shape) < 0.6, "type": typ, "a": a,
               "b": b, "c": words[1]}
    K = prog.inbox_cap
    cs = (N, K)
    client_in = {
        "valid": rng.random(cs) < 0.5,
        "type": rng.choice(np.array([T_BATCH, T_BATCH, T_BREAD, 10, 0],
                                    np.int32), cs),
        "a": np.where(rng.random(cs) < 0.1, 0,
                      rng.integers(-1, V + 2, cs)).astype(np.int32),
        "b": np.where(rng.random(cs) < 0.1, span,
                      rng.integers(-1, span + 2, cs)).astype(np.int32)}
    for f in ("src", "dest", "due", "mid", "reply_to", "c"):
        client_in[f] = rng.integers(-5, 1000, cs, dtype=np.int32)
    if span >= V:
        client_in["valid"][:, 0] = True
        client_in["type"][:, 0] = T_BATCH
        client_in["a"][:, 0] = 0
        client_in["b"][:, 0] = V
    return state, edge_in, client_in


def _step_both(jprog, pprog, state, edge_in, client_in, rnd, stall=None):
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    nodes, eo, co = jprog.edge_step(
        jstate, JEdgeMsgs(**{k: jnp.asarray(v) for k, v in edge_in.items()}),
        JT.Msgs(**{k: jnp.asarray(v) for k, v in client_in.items()}),
        {"round": jnp.int32(rnd), "key": jax.random.PRNGKey(0)})
    if stall is not None:
        js = jnp.asarray(stall)
        nodes = _freeze_nodes(jprog, js, jstate, nodes)
        eo = eo.replace(valid=eo.valid & ~js[:, None, None])
        co = co.replace(valid=co.valid & ~js[:, None])
    ctx = {"round": torch.tensor(rnd, dtype=torch.int32)}
    if stall is not None:
        ctx["stall"] = torch.tensor(stall)
    got = pprog.edge_step(
        {k: torch.tensor(v) for k, v in state.items()},
        PEdgeMsgs(**{k: torch.tensor(v) for k, v in edge_in.items()}),
        PT.Msgs(**{k: torch.tensor(v) for k, v in client_in.items()}), ctx)
    ref = [jax_tree_to_numpy(x) for x in (nodes, eo, co)]
    for r, g, what in zip(ref, got, ("state", "edge_out", "client_out")):
        assert_trees_equal(r, as_numpy(g), path=what)
    return ref


@pytest.mark.parametrize("stall", [False, True])
@pytest.mark.parametrize("V,per_nb,eager", [(64, None, False),
                                            (100, 1, True), (300, 3, False)])
def test_edge_step_matches_jax(V, per_nb, eager, stall):
    jprog, pprog = _programs(12, V, per_nb, eager)
    rng = np.random.default_rng(V + 7 * (per_nb or 0) + stall)
    state, edge_in, client_in = random_batched_inputs(rng, pprog)
    mask = rng.random(12) < 0.4 if stall else None
    # a retry-tick round, then an ordinary round from the stepped state
    for rnd in (3 * pprog.retry_rounds, 3 * pprog.retry_rounds + 1):
        ref = _step_both(jprog, pprog, state, edge_in, client_in, rnd, mask)
        state = ref[0]
        _s, edge_in, client_in = random_batched_inputs(rng, pprog)


def test_proof_sum_wraps_as_jax():
    """A 70,000-value table: whole-table batches prove a checksum whose
    int32 id sum (2,449,965,000) wraps, as JAX's does."""
    V = 70_000
    jprog, pprog = _programs(4, V)
    rng = np.random.default_rng(70)
    state, edge_in, client_in = random_batched_inputs(rng, pprog, span=V)
    ref = _step_both(jprog, pprog, state, edge_in, client_in, 5)
    co = ref[2]
    whole = co["type"][:, 0] == 21
    assert whole.all() and (co["b"][:, 0] == V).all()
    s = V * (V - 1) // 2
    assert s > 2**31 - 1
    wrapped = (s + 2**31) % 2**32 - 2**31
    assert (co["c"][:, 0] == wrapped % jsf.PROOF_MOD).all()
    assert wrapped % jsf.PROOF_MOD != jsf.range_checksum(0, V)


def test_fresh_state_and_sizing_match_jax():
    jprog, pprog = _programs(25, 1024)
    assert_trees_equal(jax_tree_to_numpy(jprog.init_state()),
                       as_numpy(pprog.init_state()))
    assert (pprog.lanes, pprog.per_nb, pprog.retry_rounds,
            pprog.max_batch, pprog.unit_words, pprog.reply_payload_words) \
        == (jprog.lanes, jprog.per_nb, jprog.retry_rounds, jprog.max_batch,
            jprog.unit_words, jprog.reply_payload_words)
    assert pprog.edge_cfg == type(pprog.edge_cfg)(**vars(jprog.edge_cfg))
    # under the byzantine adversary the program names its forged-proof
    # surface, the state and sizing unchanged; without it, none
    byz = p_get_program("broadcast-batched", {"nemesis": {"byzantine"}},
                        ["n0", "n1"], device="cpu")
    assert byz.byz_wire_edge().msg_type == 21
    assert pprog.byz_wire_edge() is None


# name: (nodes, rounds, cfg flags, faults installed)
ROUND_CONFIGS = {
    "grid5-loss-dup": (5, 60, {"enable_duplication": True},
                       {"p_loss": 0.1, "p_dup": 0.3}),
    "grid25-partitions": (25, 56, {"partition_groups": 25},
                          {"components": True,
                           "grudge": "one_way_halves"}),
    "grid25-stall-loss": (25, 56, {"enable_stall": True},
                          {"down": 0.2, "paused": 0.2, "p_loss": 0.05}),
}


def _batched_plan(n, V, R, seed):
    """One client batch or read a round (two slots), batches of fresh
    contiguous ids of 1-6 values, proven by the arithmetic checksum."""
    rng = np.random.default_rng(seed)
    M = 2
    nxt, rows = 0, []
    for r in range(R):
        for m in range(M):
            if rng.random() < 0.6 and nxt < V:
                b = int(min(rng.integers(1, 7), V - nxt))
                rows.append((T_BATCH, nxt, b, jsf.range_checksum(nxt, b)))
                nxt += b
            else:
                rows.append((T_BREAD, 0, 0, 0))
    t, a, b, c = (np.array(x, np.int32).reshape(R, M) for x in zip(*rows))
    return {"valid": rng.random((R, M)) < 0.8,
            "src": (n + rng.integers(0, 3, (R, M))).astype(np.int32),
            "dest": rng.integers(0, n, (R, M), dtype=np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": np.zeros((R, M), np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": t, "a": a, "b": b, "c": c}


@pytest.mark.parametrize("name", sorted(ROUND_CONFIGS))
def test_rounds_match_jax(name):
    """Whole rounds through both packages' `make_run_fn`, leaf for leaf
    on the `SimState` (the key, every NetStats counter with sent_units
    and recv_units, the channels) and on the client messages."""
    n, R, flags, faults = ROUND_CONFIGS[name]
    V = 96
    opts = {}
    if flags.get("enable_duplication"):
        opts["nemesis"] = {"duplicate"}
    jprog, pprog = _programs(n, V, latency={"mean": 2}, **opts)
    kw = dict(n_nodes=n, n_clients=3, pool_cap=64,
              inbox_cap=jprog.inbox_cap, client_cap=6,
              latency_mean_rounds=2.0, unit_words=jprog.unit_words, **flags)
    jcfg, pcfg = JT.NetConfig(**kw), PT.NetConfig(**kw)
    jsim = j_make_sim(jprog, jcfg, seed=3)
    jsim = jsim.replace(net=_install(JT, jsim.net, faults, n, 9))
    psim = convert.state_from_numpy(
        jax_tree_to_numpy(j_make_sim(jprog, jcfg, seed=3)), pprog, pcfg,
        device="cpu")
    psim = psim.replace(net=_install(PT, psim.net, faults, n, 9))
    plan = _batched_plan(n, V, R, seed=n + R)
    jsim, jmsgs = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in plan.items()}))
    psim, pmsgs = p_make_run_fn(pprog, pcfg)(
        psim, convert.msgs_from_numpy(plan, device="cpu"))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    assert_msgs_equal_on_valid(jmsgs, pmsgs)
    st = JT.stats_dict(jsim.net)
    assert st["recv_units"] > st["recv_all"] > 0
    for key, stat in (("p_loss", "lost"), ("p_dup", "duplicated"),
                      ("components", "dropped_partition"),
                      ("down", "dropped_down")):
        if key in faults:
            assert st[stat] > 0, stat


def p_make_run_fn(prog, cfg):
    from maelstrom_tpu_torch.sim import make_run_fn
    return make_run_fn(prog, cfg, collect_client_msgs=True, device="cpu")


def test_host_halves_match_jax():
    jprog, pprog = _programs(5, 64, batch_max=4)
    ji, pi = JIntern(), Intern()
    bodies = [{"type": "batch", "values": [0, 1, 2]},
              {"type": "batch", "values": [3]}, {"type": "read"}]
    for body in bodies:
        assert pprog.encode_body(body, pi) == jprog.encode_body(body, ji)
    for bad in ([], [4, 4], [0, 2], [4, 5, 6, 7, 8]):
        for prog, it in ((pprog, pi), (jprog, ji)):
            with pytest.raises(Exception) as e:
                prog.encode_body({"type": "batch", "values": bad}, it)
            assert type(e.value).__name__ == "EncodeCapacityError"
    for op in ({"f": "broadcast-batch", "value": [1, 2]}, {"f": "read"}):
        assert pprog.request_for_op(op) == jprog.request_for_op(op)
    for words in ((21, 1, 2, 3), (23, 0, 0, 0), (1, 22, 0, 0)):
        assert pprog.decode_body(*words, pi) == jprog.decode_body(*words, ji)
    op = {"f": "broadcast-batch", "value": [0, 1, 2], "process": 0}
    body = {"type": "batch_ok", "lo": 0, "n": 3, "proof": 3}
    assert pprog.completion_payload(op, body, None, pi) == \
        jprog.completion_payload(op, body, None, ji)
    payload = np.array([0b1011, 0], dtype=np.int32)
    rop = {"f": "read", "process": 1}
    assert pprog.completion_payload(rop, {"type": "read_ok"}, payload, pi) \
        == jprog.completion_payload(rop, {"type": "read_ok"}, payload, ji)
    small = p_get_program("broadcast-batched", {"max_values": 2},
                          ["n0", "n1"], device="cpu")
    with pytest.raises(EncodeCapacityError, match="value table full"):
        small.encode_body({"type": "batch", "values": [0, 1, 2]}, Intern())


def test_batch_counting_matches_jax():
    ctx = {"time": 0, "free": [0, 1], "processes": [0, 1]}
    jgen = jg.BatchCounting(batch_max=8, dup_rate=0.5, seed=11)
    pgen = pg.BatchCounting(batch_max=8, dup_rate=0.5, seed=11)
    for i in range(40):
        free = [] if i % 7 == 3 else [0, 1]
        c = {**ctx, "free": free}
        jr, jgen = jgen.op(c)
        pr, pgen = pgen.op(c)
        assert (jr == jg.PENDING) == (pr == pg.PENDING)
        if jr != jg.PENDING:
            assert pr == jr


def _history(cls, rows):
    h = cls()
    for r in rows:
        h.append_row(*r)
    return h


def test_checker_matches_jax():
    """Honest, forged, truncated, replayed and duplicate batches and a
    lost value: the same verdict, proof errors, set-full fields and
    convictions as the JAX checker's."""
    def ok(lo, vals, proof=None, n=None):
        return {"lo": lo, "n": len(vals) if n is None else n,
                "proof": (jsf.range_checksum(lo, len(vals)) if proof is None
                          else proof), "expanded": list(vals)}
    rows = [
        ("invoke", "broadcast-batch", [0, 1, 2], 0, 0),
        ("ok", "broadcast-batch", ok(0, [0, 1, 2]), 0, 5),
        ("invoke", "broadcast-batch", [3, 4], 1, 6),
        ("ok", "broadcast-batch", ok(3, [3, 4], proof=99), 1, 9),
        ("invoke", "broadcast-batch", [5, 6], 2, 10),
        ("ok", "broadcast-batch", ok(5, [5], n=2), 2, 12),
        ("invoke", "broadcast-batch", [7, 7], 3, 13),
        ("ok", "broadcast-batch", ok(7, [7, 7]), 3, 14),
        ("invoke", "broadcast-batch", [0, 1, 2], 4, 15),
        ("ok", "broadcast-batch", ok(0, [0, 1, 2]), 4, 16),
        ("invoke", "read", None, 0, 20),
        ("ok", "read", [0, 2, 3, 4, 5, 6, 7], 0, 25),
        ("invoke", "read", None, 1, 30),
        ("ok", "read", [0, 2, 3, 4, 5, 6, 7], 1, 35),
    ]
    test = {"nodes": ["n0", "n1", "n2"]}
    jh, ph = _history(JHistory, rows), _history(PHistory, rows)
    ref = jsf.BatchedBroadcastChecker().check(test, jh)
    got = psf.BatchedBroadcastChecker().check(test, ph)
    assert got == ref and got["valid"] is False
    assert {e["error"] for e in got["proof-errors"]} >= {
        "forged-proof", "forged-count", "truncated-batch", "replayed-batch",
        "duplicate-in-batch"}
    conv = psf.BatchedBroadcastChecker().convictions(test, ph)
    assert conv == jsf.BatchedBroadcastChecker().convictions(test, jh)
    assert psf.verify_batch_proofs(ph) == jsf.verify_batch_proofs(jh)
    assert ops_projection(psf.expand_batched_history(ph)) == \
        ops_projection(jsf.expand_batched_history(jh))
