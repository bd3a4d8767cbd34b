"""The port's cluster axis (`maelstrom_tpu_torch/parallel.py`:
`make_cluster_sims`, `make_cluster_round_fn`) against the JAX package's
`vmap`ped round, leaf for leaf with the keys and every per-cluster
`NetStats` counter, on the JAX package's raft golden scenario (client
reads, writes and CASes injected through the per-cluster pools).
Tolerance: exact (int32, bool and uint32 leaves)."""

from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.parallel import make_cluster_round_fn as j_round_fn
from maelstrom_tpu.parallel import make_cluster_sims as j_sims
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch import parallel as PP
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.tree import to_numpy
from test_torch_support import assert_trees_equal, jax_tree_to_numpy

NODES = [f"n{i}" for i in range(5)]


def programs(**opts):
    opts = {"latency": {"mean": 0}, **opts}
    return (j_get_program("lin-kv", opts, NODES),
            p_get_program("lin-kv", opts, NODES, device="cpu"))


def configs(prog_j, n_clients):
    kw = dict(n_nodes=5, n_clients=n_clients, pool_cap=64,
              inbox_cap=prog_j.inbox_cap, client_cap=4)
    return JT.NetConfig(**kw), PT.NetConfig(**kw)


def golden_plan(F, rounds):
    """tests/test_raft_golden.py's injection plan at F clusters (the
    smoke's copy: every third round past 50 one client request a
    cluster, reads, writes and CASes on 8 keys)."""
    import chip_smoke
    return chip_smoke.golden_plan(F, rounds)


def jax_run(F, rounds, seed, plan=None, n_clients=3):
    jprog, _ = programs()
    jcfg, _ = configs(jprog, n_clients)
    fn = j_round_fn(jprog, jcfg)
    sims = j_sims(jprog, jcfg, F, seed=seed)
    empty = JT.Msgs.empty((F, n_clients))
    for r in range(rounds):
        rows = plan[r] if plan else None
        inj = empty if rows is None else empty.replace(
            **{k: jnp.asarray(v) for k, v in rows.items()})
        sims, _cm, _io = fn(sims, inj)
    return jax_tree_to_numpy(sims)


def port_run(F, rounds, seed, plan=None, n_clients=3, sims=None):
    _, pprog = programs()
    _, pcfg = configs(pprog, n_clients)
    fn = PP.make_cluster_round_fn(pprog, pcfg, device="cpu")
    if sims is None:
        sims = PP.make_cluster_sims(pprog, pcfg, F, seed=seed, device="cpu")
    empty = PT.Msgs.empty((F, n_clients), "cpu")
    for r in range(rounds):
        rows = plan[r] if plan else None
        inj = empty if rows is None else PP.injection_msgs(rows, "cpu")
        sims, _cm, _io = fn(sims, inj)
    return sims


def digest(tree, clusters):
    return PP.cluster_digest(tree["nodes"], tree["key"],
                             tree["net"]["stats"], tree["channels"],
                             clusters)


def test_cluster_sims_match_jax():
    """make_cluster_sims equals JAX's, and a JAX cluster state converts
    into the port's (durable view rebuilt) and back unchanged."""
    jprog, pprog = programs()
    jcfg, pcfg = configs(jprog, 3)
    ref = jax_tree_to_numpy(j_sims(jprog, jcfg, 6, seed=7))
    got = to_numpy(PP.make_cluster_sims(pprog, pcfg, 6, seed=7,
                                        device="cpu"))
    assert_trees_equal(ref, got)
    jfn = j_round_fn(jprog, jcfg)
    js = j_sims(jprog, jcfg, 6, seed=7)
    for _ in range(30):
        js = jfn(js, JT.Msgs.empty((6, 3)))[0]
    mid = jax_tree_to_numpy(js)
    ps = convert.cluster_state_from_numpy(mid, pprog, pcfg, device="cpu")
    assert ps.durable["log_a"] is ps.nodes["log_a"]
    assert_trees_equal(mid, to_numpy(ps))


def test_golden_scenario_matches_jax():
    """300 rounds of the golden test's traffic at F 8, leaf for leaf."""
    plan = golden_plan(8, 300)
    ref = jax_run(8, 300, 7, plan)
    got = to_numpy(port_run(8, 300, 7, plan))
    assert_trees_equal(ref, got)
    roles = got["nodes"]["role"]
    assert ((roles == 2).sum(axis=1) == 1).all()
    assert int(got["nodes"]["applied"].max()) > 50


def test_cluster_prefix_is_independent_of_cluster_count():
    """Cluster i's key and run do not depend on F: the first 8 clusters
    of an F 64 run equal an F 8 run (the property chip_smoke.py's pin of
    clusters 0-63 of the 10,000-cluster bench rests on)."""
    big = to_numpy(port_run(64, 30, 1, n_clients=1))
    small = to_numpy(port_run(8, 30, 1, n_clients=1))
    assert digest(big, 8) == digest(small, 8)
    assert digest(big, 9) != digest(small, 8)


def test_out_of_scope_configs_raise():
    _, pprog = programs()
    _, pcfg = configs(pprog, 1)
    sims = PP.make_cluster_sims(pprog, pcfg, 4, seed=1, device="cpu")
    inj = PT.Msgs.empty((4, 1), "cpu")
    fn = PP.make_cluster_round_fn(pprog, pcfg, device="cpu")
    sims, _cm, _io = fn(sims, inj)
    lossy = sims.replace(net=PT.flaky(sims.net, 0.1))
    with pytest.raises(NotImplementedError, match="fleet slice"):
        fn(lossy, inj)
    split = sims.replace(net=sims.net.replace(
        component=torch.tensor([[0, 0, 1, 1, 1, 0]] * 4, dtype=torch.int32)))
    with pytest.raises(NotImplementedError, match="fleet slice"):
        fn(split, inj)
    fn(sims, inj)           # the unchanged state still runs
    for kw in ({"latency_dist": "uniform", "latency_mean_rounds": 2.0},
               {"enable_stall": True}, {"enable_duplication": True},
               {"partition_groups": 5}):
        cfg = PT.NetConfig(**{**pcfg.__dict__, **kw})
        with pytest.raises(NotImplementedError, match="fleet slice"):
            PP.make_cluster_round_fn(pprog, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        PP.make_cluster_round_fn(pprog, pcfg, mesh=object(), device="cpu")


@pytest.mark.slow
def test_pins_match_live_jax_runs():
    """Re-derives chip_smoke.py's PINNED_RAFT (`parallel.cluster_digest`
    of the JAX raft bench's state after 300 rounds of
    make_cluster_sims(F=64, seed=1): bench.py bench_raft_clusters' config,
    no injections) and PINNED_RAFT_GOLDEN (`parallel.nodes_digest` of
    tests/test_raft_golden.py's final state: 32 clusters, 400 rounds,
    seed 7, its injection plan) from live JAX runs on the CPU (about a
    minute), and holds the port's CPU run to the first."""
    import chip_smoke
    ref = jax_run(64, 300, 1, n_clients=1)
    print("PINNED_RAFT", digest(ref, 64))
    golden = jax_run(32, 400, 7, golden_plan(32, 400))
    print("PINNED_RAFT_GOLDEN", PP.nodes_digest(golden["nodes"]))
    assert digest(ref, 64) == chip_smoke.PINNED_RAFT
    assert PP.nodes_digest(golden["nodes"]) == chip_smoke.PINNED_RAFT_GOLDEN
    got = to_numpy(port_run(64, 300, 1, n_clients=1))
    assert digest(got, 64) == chip_smoke.PINNED_RAFT
