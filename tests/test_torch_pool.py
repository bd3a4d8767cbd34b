"""The port's flight pool (`maelstrom_tpu_torch/net/tpu.py` `_send` and
`_deliver`) against the JAX package's `_send` and `_deliver`, on random
pools. Tolerance: exact on every net-state leaf and on the inbox; client
batches compare on their valid rows (the JAX version skips delivery when
nothing is due and returns an empty batch, the port always runs it)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu_torch import prng
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.tree import from_numpy
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

N, CLIENTS, P, K = 6, 2, 40, 3
FIELDS = ("src", "dest", "due", "mid", "reply_to", "type", "a", "b", "c")


def _cfg(mod, **kw):
    return mod.NetConfig(n_nodes=N, n_clients=CLIENTS, pool_cap=P,
                         inbox_cap=K, client_cap=kw.pop("client_cap", 4),
                         latency_mean_rounds=kw.pop("lat", 2.0), **kw)


def _random_msgs(rng, n, p_valid, rnd, dests):
    m = {"valid": rng.random(n) < p_valid,
         "src": rng.integers(0, N + CLIENTS, n, dtype=np.int32),
         # few destinations and few due rounds: ties in (dest, age), and
         # more than K due messages for one node
         "dest": rng.choice(np.asarray(dests, np.int32), n),
         "due": rng.integers(rnd - 2, rnd + 2, n, dtype=np.int32)}
    for f in FIELDS[3:]:
        m[f] = rng.integers(-9, 99, n, dtype=np.int32)
    return m


def _nets(rng, pool, rnd, component=None, **kw):
    jnet = JT.make_net(_cfg(JT, **kw))
    jnet = jnet.replace(pool=JT.Msgs(**{k: jnp.asarray(v)
                                        for k, v in pool.items()}),
                        round=jnp.int32(rnd), next_mid=jnp.int32(77))
    if component is not None:
        jnet = jnet.replace(component=jnp.asarray(component, jnp.int32))
    tree = jax_tree_to_numpy(jnet)
    return jnet, from_numpy(PT.make_net(_cfg(PT, **kw), "cpu"), tree, "cpu")


@pytest.mark.parametrize("case", ["ties", "partition", "nothing-due",
                                  "count-only"])
def test_deliver_matches_jax(case):
    rng = np.random.default_rng(len(case))
    rnd = 10
    pool = _random_msgs(rng, P, 0.7, rnd, [0, 1, 1, 2, 6, 7])
    if case == "nothing-due":
        pool["due"] = np.full(P, rnd + 1, np.int32)
    comp = None
    if case == "partition":
        comp = np.array([0, 0, 1, 1, 0, 1, 0, 0], np.int32)
    cc = 0 if case == "count-only" else 4
    jcfg, pcfg = _cfg(JT, client_cap=cc), _cfg(PT, client_cap=cc)
    jnet, pnet = _nets(rng, pool, rnd, comp)
    jnet2, j_inbox, j_client = JT._deliver(jcfg, jnet)
    pnet2, p_inbox, p_client = PT._deliver(pcfg, pnet)
    assert_trees_equal(jax_tree_to_numpy(jnet2), as_numpy(pnet2))
    assert_trees_equal(jax_tree_to_numpy(j_inbox), as_numpy(p_inbox))
    assert_msgs_equal_on_valid(j_client, p_client)
    if case == "ties":
        assert np.asarray(j_inbox.valid).sum(axis=1).max() == K
        assert np.asarray(j_client.valid).any()
    if case == "nothing-due":
        assert not np.asarray(p_inbox.valid).any()


@pytest.mark.parametrize("free_slots", [30, 2])
def test_send_matches_jax(free_slots):
    rng = np.random.default_rng(free_slots)
    rnd = 4
    pool = _random_msgs(rng, P, 1.0, rnd, [0, 1, 2])
    pool["valid"][:free_slots] = False
    rng.shuffle(pool["valid"])
    jnet, pnet = _nets(rng, pool, rnd)
    out = _random_msgs(rng, 7, 0.7, rnd, [0, 3, 5, 6, 7])
    jnet2, j_sent = JT._send(_cfg(JT), jnet, JT.Msgs(
        **{k: jnp.asarray(v) for k, v in out.items()}),
        jax.random.PRNGKey(0))
    pnet2, p_sent = PT._send(_cfg(PT), pnet, PT.Msgs(
        **{k: torch.tensor(v) for k, v in out.items()}),
        prng.PRNGKey(0, "cpu"))
    assert_trees_equal(jax_tree_to_numpy(jnet2), as_numpy(pnet2))
    assert_trees_equal(jax_tree_to_numpy(j_sent), as_numpy(p_sent))
    overflow = int(pnet2.stats.dropped_overflow)
    assert (overflow > 0) == (free_slots < out["valid"].sum())


def test_net_helpers_match_jax():
    assert_trees_equal(jax_tree_to_numpy(JT.make_net(_cfg(JT))),
                       as_numpy(PT.make_net(_cfg(PT), "cpu")))
    rng = np.random.default_rng(3)
    types = rng.integers(-3, 80, (5, 4), dtype=np.int32)
    valid = rng.random((5, 4)) < 0.5
    ref = JT.count_by_type(jnp.zeros(64, jnp.int32), jnp.asarray(types),
                           jnp.asarray(valid))
    got = PT.count_by_type(torch.zeros(64, dtype=torch.int32),
                           torch.tensor(types), torch.tensor(valid))
    assert_trees_equal(np.asarray(ref), got.numpy())
    cfg = _cfg(JT, lat=2.5)
    ref = JT.draw_latency_rounds(cfg, None, jnp.float32(1.0), (3,))
    got = PT.draw_latency_rounds(_cfg(PT, lat=2.5), None, torch.tensor(1.0),
                                 (3,))
    assert_trees_equal(np.asarray(ref), got.numpy())
    words = [rng.integers(-2, 9, (5, 4), dtype=np.int32) for _ in range(3)]
    ucfg = {"n_nodes": 4, "unit_words": ((10, 1), (12, 0))}
    ref = JT.payload_units(JT.NetConfig(**ucfg), jnp.asarray(types % 16),
                           [jnp.asarray(w) for w in words],
                           jnp.asarray(valid))
    got = PT.payload_units(PT.NetConfig(**ucfg), torch.tensor(types % 16),
                           [torch.tensor(w) for w in words],
                           torch.tensor(valid))
    assert int(ref) == int(got) and got.dtype == torch.int32
    jnet = JT.make_net(cfg)
    assert PT.stats_dict(PT.make_net(_cfg(PT), "cpu")) == \
        JT.stats_dict(jnet)


def test_scope_guards_raise():
    """An unknown latency distribution is refused; the fault paths, the
    batched-broadcast unit accounting, the telemetry ring and (since the
    byzantine slice) the adversary are not."""
    for kw in ({"latency_dist": "uniform"}, {"enable_duplication": True},
               {"enable_stall": True}, {"partition_groups": 2},
               {"unit_words": ((10, 0),)}, {"enable_byz": True},
               {"telemetry": True, "telemetry_roles": ((0, 4),)}):
        PT.check_scope(PT.NetConfig(n_nodes=4, **kw))
    with pytest.raises(ValueError, match="latency dist"):
        PT.check_scope(PT.NetConfig(n_nodes=4, latency_dist="pareto"))


# (NetConfig flags, fault surgery) of the pool under faults
FAULT_CASES = {
    "loss-exponential": ({"latency_dist": "exponential"},
                         lambda T, n: T.flaky(n, 0.3)),
    "dup-uniform": ({"latency_dist": "uniform", "enable_duplication": True},
                    lambda T, n: T.set_duplication(T.flaky(n, 0.1), 0.5)),
    "stall": ({"enable_stall": True},
              lambda T, n: T.set_paused(T.set_down(
                  n, np.array([0, 1, 0, 0, 0, 1], bool)),
                  np.array([0, 0, 1, 0, 0, 0], bool))),
    "grudge": ({"partition_groups": N},
               lambda T, n: T.partition_grudge(
                   n, np.arange(N, dtype=np.int32),
                   np.random.default_rng(4).random((N, N)) < 0.5)),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_pool_faults_match_jax(case):
    """`_send` (loss roll, latency draws, duplication of server-to-server
    rows) and `_deliver` (directional grudges, down and paused
    destinations) under faults, from the same key."""
    flags, surgery = FAULT_CASES[case]
    rng = np.random.default_rng(len(case))
    rnd = 10
    pool = _random_msgs(rng, P, 0.5, rnd, [0, 1, 1, 2, 5, 6, 7])
    pool["src"] = rng.integers(0, N, P, dtype=np.int32)
    jnet, pnet = _nets(rng, pool, rnd, **flags)
    jnet, pnet = surgery(JT, jnet), surgery(PT, pnet)
    jcfg, pcfg = _cfg(JT, **flags), _cfg(PT, **flags)
    out = _random_msgs(rng, 12, 0.9, rnd, [0, 1, 3, 4, 5, 6])
    out["src"] = rng.integers(0, N + CLIENTS, 12, dtype=np.int32)
    jnet, j_sent = JT._send(jcfg, jnet, JT.Msgs(
        **{k: jnp.asarray(v) for k, v in out.items()}),
        jax.random.PRNGKey(9))
    pnet, p_sent = PT._send(pcfg, pnet, PT.Msgs(
        **{k: torch.tensor(v) for k, v in out.items()}),
        prng.PRNGKey(9, "cpu"))
    assert_trees_equal(jax_tree_to_numpy(jnet), as_numpy(pnet))
    assert_trees_equal(jax_tree_to_numpy(j_sent), as_numpy(p_sent))
    jnet, j_inbox, j_client = JT._deliver(jcfg, jnet)
    pnet, p_inbox, p_client = PT._deliver(pcfg, pnet)
    assert_trees_equal(jax_tree_to_numpy(jnet), as_numpy(pnet))
    assert_trees_equal(jax_tree_to_numpy(j_inbox), as_numpy(p_inbox))
    assert_msgs_equal_on_valid(j_client, p_client)
    st = PT.stats_dict(pnet)
    want = {"loss-exponential": "lost", "dup-uniform": "duplicated",
            "stall": "dropped_down", "grudge": "dropped_partition"}[case]
    assert st[want] > 0
