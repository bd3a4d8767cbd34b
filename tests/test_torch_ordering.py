"""The port's ordering axis (`maelstrom_tpu_torch/ordering/`,
`services.PersistentKV`) against the JAX package's, on the CPU: the
appliers and the pure KV machine on seeded op streams, the engines' host
halves (proposal words, stream positions, replay from the intern table
and from replica state read node by node), and the axis's wiring and
refusals. Tolerance: exact (equal dicts and words)."""

from __future__ import annotations

import random
from types import SimpleNamespace

import numpy as np
import pytest

from maelstrom_tpu import services as jservices
from maelstrom_tpu.nodes import Intern as JIntern
from maelstrom_tpu.ordering import appliers as japp
from maelstrom_tpu.ordering import make_ordered as j_make_ordered
from maelstrom_tpu_torch import core as pcore
from maelstrom_tpu_torch import services as pservices
from maelstrom_tpu_torch.nodes import EncodeCapacityError, Intern
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.ordering import appliers as papp
from maelstrom_tpu_torch.ordering import (get_applier, make_ordered,
                                          ordered_node_count)
from maelstrom_tpu_torch.ordering.engines import StreamLagError

NODES5 = [f"n{i}" for i in range(5)]


def _linkv_ops(seed, n):
    rng = random.Random(seed)
    for _ in range(n):
        k, r = rng.randrange(4), rng.random()
        if r < 0.4:
            yield {"f": "read", "value": [k, None], "process": 0}
        elif r < 0.7:
            yield {"f": "write", "value": [k, rng.randrange(5)],
                   "process": 0}
        else:
            yield {"f": "cas", "value": [k, [rng.randrange(5),
                                             rng.randrange(5)]],
                   "process": 0}


def _kafka_ops(seed, n):
    rng = random.Random(seed)
    for i in range(n):
        r = rng.random()
        if r < 0.5:
            yield {"f": "send", "value": [i % 3, i], "process": 1}
        elif r < 0.8:
            yield {"f": "poll", "process": 1}
        elif r < 0.9:
            yield {"f": "commit", "process": 1}
        else:
            yield {"f": "list", "process": 1}


@pytest.mark.parametrize("name,ops", [("lin-kv", _linkv_ops),
                                      ("kafka", _kafka_ops)])
def test_appliers_match_jax(name, ops):
    ja, pa = japp.APPLIERS[name]({}), papp.APPLIERS[name]({})
    js, ps = ja.init_state(), pa.init_state()
    for op in ops(42, 300):
        jc, pc = ja.command(op), pa.command(op)
        assert pc == jc
        js, jr = ja.apply(js, jc)
        ps, pr = pa.apply(ps, pc)
        assert pr == jr
        assert pa.completed(op, pr) == ja.completed(op, jr)
        assert pa.host_view() == ja.host_view()


def test_persistent_kv_matches_jax():
    j, p = jservices.PersistentKV(), pservices.PersistentKV()
    rng = random.Random(7)
    for _ in range(200):
        body = {"type": rng.choice(["read", "write", "cas", "nope"]),
                "key": rng.randrange(3), "value": rng.randrange(4),
                "from": rng.randrange(4), "to": rng.randrange(4),
                "create_if_not_exists": rng.random() < 0.3}
        msg = SimpleNamespace(body=body)
        j, jr = j.handle(msg)
        p, pr = p.handle(msg)
        assert pr == jr and p.m == j.m


@pytest.mark.parametrize("engine", ["raft", "batched"])
def test_engine_host_halves_match_jax(engine):
    """Proposals carry the same words through the same intern ids; a
    re-encode proposes the same id; the reply's stream position, the
    replay and the completion match."""
    opts = {"workload": "lin-kv", "ordering": engine, "rate": 10.0,
            "time_limit": 1.0, "latency": {"mean": 0}}
    jp = j_make_ordered(opts, NODES5)
    pp = make_ordered(opts, NODES5, device="cpu")
    assert type(pp).__name__ == type(jp).__name__
    assert pp.name == jp.name == "ordered"
    ji, pi = JIntern(), Intern()
    jops = list(_linkv_ops(3, 12))
    pops = [dict(o) for o in jops]
    for jo, po in zip(jops, pops):
        jw = jp.encode_body(jp.request_for_op(jo), ji)
        pw = pp.encode_body(pp.request_for_op(po), pi)
        assert pw == jw
        assert pp.encode_body(pp.request_for_op(po), pi) == pw
    assert po["_oseq"] == jo["_oseq"] and po["_ocmd"] == jo["_ocmd"]
    if engine == "batched":
        assert pp.V == jp.V == 2 * 10 + 256
        for slot, (jo, po) in enumerate(zip(jops, pops)):
            words = (21, slot, 1, 0)
            jb, pb = jp.decode_body(*words, ji), pp.decode_body(*words, pi)
            assert pb == jb
            assert pp.completion_payload(po, pb, None, pi) == \
                jp.completion_payload(jo, jb, None, ji)
    else:
        # a replicated log holding the commands in order; replica 0 lags,
        # replica 2 has committed them all: completions read replicas in
        # turn until one covers the slot
        C = pp.cap
        log_a = np.zeros(C, np.int32)
        log_b = np.zeros(C, np.int32)
        for s in range(len(jops)):
            log_a[s] = 4                        # OP_TXN
            log_b[s] = ((s >> 8) & 0xFF) << 8 | (s & 0xFF)
        rows = [{"commit": -1, "log_len": 0, "log_a": log_a,
                 "log_b": log_b}] * 2 + [
            {"commit": len(jops) - 1, "log_len": len(jops),
             "log_a": log_a, "log_b": log_b}] * 3
        seen = []

        def read_state(i):
            seen.append(i)
            return rows[i]
        for slot, (jo, po) in enumerate(zip(jops, pops)):
            words = (17, slot, 0, 0)
            jb, pb = jp.decode_body(*words, ji), pp.decode_body(*words, pi)
            assert pb == jb
            assert pp.completion(po, pb, read_state, pi) == \
                jp.completion(jo, jb, read_state, ji)
        assert seen[:3] == [0, 1, 2]

        def lagging(i):
            return rows[0]
        fresh = make_ordered(opts, NODES5, device="cpu")
        op, it = {k: v for k, v in jops[0].items()
                  if not k.startswith("_")}, Intern()
        fresh.encode_body(fresh.request_for_op(op), it)
        done = fresh.completion(op, {"type": "txn_ok", "position": 0},
                                lagging, it)
        assert done["type"] == "info" and done["error"][0] == "stream-lag"
        assert issubclass(StreamLagError, RuntimeError)


def test_capacity_and_refusals():
    small = make_ordered({"workload": "kafka", "ordering": "batched",
                          "max_values": 2}, NODES5, device="cpu")
    it = Intern()
    for i in range(2):
        small.encode_body(small.request_for_op({"f": "poll"}), it)
    with pytest.raises(EncodeCapacityError, match="command table full"):
        small.encode_body(small.request_for_op({"f": "poll"}), it)
    # the compartment engine sizes its cluster from --roles; an elected
    # tier's layout is refused only where JAX's is, in its words
    with pytest.raises(ValueError, match="needs 9 nodes"):
        make_ordered({"workload": "lin-kv", "ordering": "compartment"},
                     NODES5, device="cpu")
    with pytest.raises(ValueError, match="ballot_width must be"):
        make_ordered({"workload": "lin-kv", "ordering": "compartment",
                      "roles": "sequencers=2", "ballot_width": 9},
                     [f"n{i}" for i in range(10)], device="cpu")
    assert get_applier("txn-list-append", {}).name == "txn-list-append"
    assert get_applier("lin-mutex", {}).name == "lin-kv"
    with pytest.raises(ValueError, match="no applier serves"):
        get_applier("echo", {})
    with pytest.raises(ValueError, match="drop --node tpu:lin-kv"):
        pcore.build_test({"workload": "lin-kv", "ordering": "raft",
                          "node": "tpu:lin-kv"})
    test = pcore.build_test({"workload": "kafka", "ordering": "batched"})
    assert test["node"] == "tpu:ordered"
    assert ordered_node_count({"ordering": "raft"}) is None
    prog = p_get_program("ordered", {"workload": "kafka",
                                     "ordering": "raft"}, NODES5,
                         device="cpu")
    assert prog.stream_engine == "raft" and prog.needs_state_reads
    assert prog.state_reads_final
