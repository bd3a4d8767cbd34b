"""The port's broadcast node program (`maelstrom_tpu_torch/nodes/
broadcast.py`, kernel K3 edge_step, with and without the stall mask)
against the JAX package's, on random states and inboxes in every mode.
Tolerance: exact, on every state leaf, every edge-out lane and the client
replies."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net.static import EdgeMsgs as JEdgeMsgs
from maelstrom_tpu.net.tpu import Msgs as JMsgs
from maelstrom_tpu.nodes import Intern as JIntern
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu_torch.net.static import EdgeMsgs as PEdgeMsgs
from maelstrom_tpu_torch.net.tpu import Msgs as PMsgs
from maelstrom_tpu_torch.nodes import EncodeCapacityError, Intern
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from test_torch_support import (assert_trees_equal, jax_tree_to_numpy,
                                as_numpy)

MODES = {"efficient": {}, "eager": {"eager_resend": True},
         "naive": {"naive_broadcast": True},
         "naive-all-edges": {"naive_broadcast": True, "skip_sender": False}}
N_NODES = 12


def _programs(mode, V, per_nb):
    nodes = [f"n{i}" for i in range(N_NODES)]
    opts = {"topology": "grid", "max_values": V,
            "gossip_per_neighbor": per_nb, "latency": {"mean": 0},
            **MODES[mode]}
    return (j_get_program("broadcast", opts, nodes),
            p_get_program("broadcast", opts, nodes, device="cpu"))


def _random_step_inputs(rng, prog):
    N, D, V, W = prog.n_nodes, prog.D, prog.V, prog.n_windows
    L = prog.edge_cfg.lanes
    state = {"seen": rng.random((N, V)) < 0.3,
             "pending": rng.random((N, D, V)) < 0.2,
             "inflight": rng.random((N, D, V)) < 0.2,
             "inflight_old": rng.random((N, D, V)) < 0.2,
             "owed": rng.random((N, D, W)) < 0.3}
    etype = rng.choice(np.array([14, 14, 15, 0], np.int32), (N, D, L))
    ea = np.where(etype == 15, rng.integers(0, W + 1, (N, D, L)),
                  rng.integers(-2, V + 3, (N, D, L))).astype(np.int32)
    edge_in = {"valid": rng.random((N, D, L)) < 0.6, "type": etype,
               "a": ea,
               "b": rng.integers(-2**31, 2**31, (N, D, L), dtype=np.int64
                                 ).astype(np.int32),
               "c": rng.integers(-2**31, 2**31, (N, D, L), dtype=np.int64
                                 ).astype(np.int32)}
    K = prog.inbox_cap
    client_in = {"valid": rng.random((N, K)) < 0.5,
                 "type": rng.choice(np.array([10, 10, 12, 0], np.int32),
                                    (N, K)),
                 "a": rng.integers(-1, V + 2, (N, K), dtype=np.int32)}
    for f in ("src", "dest", "due", "mid", "reply_to", "b", "c"):
        client_in[f] = rng.integers(-5, 1000, (N, K), dtype=np.int32)
    return state, edge_in, client_in


def _step_both(jprog, pprog, state, edge_in, client_in, rnd):
    ref = jprog.edge_step(
        {k: jnp.asarray(v) for k, v in state.items()},
        JEdgeMsgs(**{k: jnp.asarray(v) for k, v in edge_in.items()}),
        JMsgs(**{k: jnp.asarray(v) for k, v in client_in.items()}),
        {"round": jnp.int32(rnd), "key": jax.random.PRNGKey(0)})
    got = pprog.edge_step(
        {k: torch.tensor(v) for k, v in state.items()},
        PEdgeMsgs(**{k: torch.tensor(v) for k, v in edge_in.items()}),
        PMsgs(**{k: torch.tensor(v) for k, v in client_in.items()}),
        {"round": torch.tensor(rnd, dtype=torch.int32)})
    return ref, got


@pytest.mark.parametrize("per_nb", [1, 4])
@pytest.mark.parametrize("V", [32, 64, 100])
@pytest.mark.parametrize("mode", list(MODES))
def test_edge_step_matches_jax(mode, V, per_nb):
    jprog, pprog = _programs(mode, V, per_nb)
    rng = np.random.default_rng(V * 10 + per_nb)
    state, edge_in, client_in = _random_step_inputs(rng, pprog)
    # a retry-tick round, then an ordinary round from the stepped state
    for rnd in (3 * pprog.retry_rounds, 3 * pprog.retry_rounds + 1):
        ref, got = _step_both(jprog, pprog, state, edge_in, client_in, rnd)
        ref_np = [jax_tree_to_numpy(x) for x in ref]
        for r, g, what in zip(ref_np, got, ("state", "edge_out",
                                            "client_out")):
            assert_trees_equal(r, as_numpy(g), path=what)
        state = ref_np[0]
        _s, edge_in, client_in = _random_step_inputs(rng, pprog)


def test_host_halves_match_jax():
    jprog, pprog = _programs("efficient", 64, 1)
    ji, pi = JIntern(), Intern()
    for body in ({"type": "broadcast", "message": 7},
                 {"type": "broadcast", "message": "x"},
                 {"type": "broadcast", "message": 7}, {"type": "read"}):
        assert pprog.encode_body(body, pi) == jprog.encode_body(body, ji)
    for t in (11, 13):
        assert pprog.decode_body(t, 0, 0, 0, pi) == \
            jprog.decode_body(t, 0, 0, 0, ji)
    op = {"f": "read", "process": 0}
    payload = np.array([1 << 31 | 0b1011, 1 << 31 | 1],
                       dtype=np.int64).astype(np.int32)
    for i in (pi, ji):
        for v in range(64):
            i.id(f"v{v}")
    assert pprog.completion_payload(op, {"type": "read_ok"}, payload, pi) \
        == jprog.completion_payload(op, {"type": "read_ok"}, payload, ji)
    assert pprog.request_for_op({"f": "broadcast", "value": 3}) == \
        jprog.request_for_op({"f": "broadcast", "value": 3})
    small = p_get_program("broadcast", {"max_values": 1}, ["n0", "n1"],
                          device="cpu")
    small.encode_body({"type": "broadcast", "message": 1}, Intern())
    with pytest.raises(EncodeCapacityError):
        small.encode_body({"type": "broadcast", "message": 1},
                          _full_intern())


def _full_intern():
    i = Intern()
    i.id("taken")
    return i


def test_fresh_state_and_payload_match_jax():
    jprog, pprog = _programs("efficient", 100, 4)
    assert_trees_equal(jax_tree_to_numpy(jprog.init_state()),
                       as_numpy(pprog.init_state()))
    rng = np.random.default_rng(5)
    seen = rng.random((N_NODES, 100)) < 0.5
    idx = np.array([3, 0, 11], dtype=np.int32)
    ref = jprog.reply_payload({"seen": jnp.asarray(seen)}, jnp.asarray(idx))
    got = pprog.reply_payload({"seen": torch.tensor(seen)},
                              torch.tensor(idx).long())
    assert_trees_equal(np.asarray(ref), got.numpy())
    np.testing.assert_array_equal(pprog.neighbors.numpy(),
                                  np.asarray(jprog.neighbors))
    assert (pprog.retry_rounds, pprog.edge_cfg.ring, pprog.lanes) == \
        (jprog.retry_rounds, jprog.edge_cfg.ring, jprog.lanes)


def test_other_programs_and_random_latency_are_refused():
    """Other programs are still refused, naming the slice that brings
    each (lin-kv runs since the raft slice, echo, unique-ids and the CRDT
    programs since the pool-path slice, broadcast-batched since its own,
    the transaction programs since theirs, the services since the
    role-partition slice, the compartment since its own: a cluster that
    its roles do not size is refused);
    randomized latency, refused
    until the fault slice, now sizes the channels as the JAX package
    does (the spill write and its doubled lanes on 4,096 nodes or fewer,
    the ring's slack and slow! headroom, two cells for duplicates)."""
    assert p_get_program("txn-list-append", {}, ["n0"],
                         device="cpu").name == "txn-list-append"
    assert p_get_program("services", {}, [f"n{i}" for i in range(5)],
                         device="cpu").name == "services"
    assert p_get_program("compartment", {}, [f"n{i}" for i in range(9)],
                         device="cpu").name == "compartment"
    with pytest.raises(ValueError, match="needs 9 nodes"):
        p_get_program("compartment", {}, ["n0"], device="cpu")
    for n, opts in ((5, {"latency": {"mean": 5, "dist": "uniform"}}),
                    (25, {"latency": {"mean": 3, "dist": "exponential"},
                          "nemesis": {"duplicate", "kill"}}),
                    (9, {"latency": {"mean": 3, "dist": "exponential"},
                         "naive_broadcast": True, "max_latency_scale": 2}),
                    (4100, {"latency": {"mean": 5, "dist": "uniform"},
                            "max_values": 8}),
                    (16, {"latency": {"mean": 10}, "nemesis": ["duplicate"]})):
        nodes = [f"n{i}" for i in range(n)]
        j = j_get_program("broadcast", opts, nodes)
        p = p_get_program("broadcast", opts, nodes, device="cpu")
        assert p.edge_cfg == type(p.edge_cfg)(**vars(j.edge_cfg))
        assert (p.lanes, p.retry_rounds) == (j.lanes, j.retry_rounds)


@pytest.mark.parametrize("mode", list(MODES))
def test_edge_step_with_stall_matches_jax(mode):
    """A stalled node (killed or paused) keeps its state and sends
    nothing: the JAX round's `_freeze_nodes` and output masks after its
    step, against the port's step given ctx["stall"]."""
    from maelstrom_tpu.sim import _freeze_nodes
    jprog, pprog = _programs(mode, 64, 4)
    rng = np.random.default_rng(len(mode))
    state, edge_in, client_in = _random_step_inputs(rng, pprog)
    stall = rng.random(N_NODES) < 0.4
    rnd = 3 * pprog.retry_rounds
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    nodes, eo, co = jprog.edge_step(
        jstate, JEdgeMsgs(**{k: jnp.asarray(v) for k, v in edge_in.items()}),
        JMsgs(**{k: jnp.asarray(v) for k, v in client_in.items()}),
        {"round": jnp.int32(rnd), "key": jax.random.PRNGKey(0)})
    js = jnp.asarray(stall)
    ref = (_freeze_nodes(jprog, js, jstate, nodes),
           eo.replace(valid=eo.valid & ~js[:, None, None]),
           co.replace(valid=co.valid & ~js[:, None]))
    got = pprog.edge_step(
        {k: torch.tensor(v) for k, v in state.items()},
        PEdgeMsgs(**{k: torch.tensor(v) for k, v in edge_in.items()}),
        PMsgs(**{k: torch.tensor(v) for k, v in client_in.items()}),
        {"round": torch.tensor(rnd, dtype=torch.int32),
         "stall": torch.tensor(stall)})
    for r, g, what in zip(ref, got, ("state", "edge_out", "client_out")):
        assert_trees_equal(jax_tree_to_numpy(r), as_numpy(g), path=what)
