"""The port's cluster axis (`maelstrom_tpu_torch/parallel.py`:
`make_cluster_sims`, `make_fleet_sims`, `make_cluster_round_fn`) against
the JAX package's `vmap`ped round, leaf for leaf with the keys and every
per-cluster `NetStats` counter: the JAX package's raft golden scenario
(client reads, writes and CASes injected through the per-cluster pools),
and raft and broadcast clusters under faults of their own (uniform and
exponential latency, loss 0.03, component and directional partitions,
kill and pause, duplication, each cluster at its own round).
Tolerance: exact (int32, bool and uint32 leaves)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
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
    """Faults, partitions and per-cluster rounds run on the cluster axis
    since the fleet slice (`test_cluster_round_under_faults_matches_jax`);
    what stays refused names its slice: a mesh, the byzantine adversary
    (the JAX package's words), a program without a row step, client-op
    unit counters, telemetry rings and journaled channels."""
    _, pprog = programs()
    _, pcfg = configs(pprog, 1)
    sims = PP.make_cluster_sims(pprog, pcfg, 4, seed=1, device="cpu")
    inj = PT.Msgs.empty((4, 1), "cpu")
    fn = PP.make_cluster_round_fn(pprog, pcfg, device="cpu")
    sims, _cm, _io = fn(sims, inj)
    lossy = sims.replace(net=PT.flaky(sims.net, 0.1))
    fn(lossy, inj)          # loss on the axis runs now
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        PP.make_cluster_round_fn(pprog, pcfg, mesh=object(), device="cpu")
    for kw, what in (({"enable_byz": True}, "does not compose with --fleet"),
                     ({"unit_words": ((1, 0),)}, "fleets of kafka"),
                     ({"telemetry": True}, "continuous fleet")):
        cfg = PT.NetConfig(**{**pcfg.__dict__, **kw})
        with pytest.raises(NotImplementedError, match=what):
            PP.make_cluster_round_fn(pprog, cfg, device="cpu")
    echo = p_get_program("echo", {}, NODES, device="cpu")
    with pytest.raises(NotImplementedError, match="row step"):
        PP.make_cluster_round_fn(echo, pcfg, device="cpu")


# --- the cluster axis under faults -------------------------------------------

# name: (program, latency mean, dist, cfg flags, per-cluster faults)
FAULTED = {
    "raft-uniform-loss-stall": (
        "lin-kv", 2, "uniform", {"enable_stall": True},
        {"p_loss": 0.03, "stall": True}),
    "raft-exponential-partitions-dup": (
        "lin-kv", 2, "exponential",
        {"partition_groups": 5, "enable_duplication": True},
        {"p_loss": 0.03, "components": True, "grudge": True, "p_dup": 0.3,
         "scale": True}),
    "raft-constant-soup": (
        "lin-kv", 0, "constant",
        {"partition_groups": 5, "enable_stall": True,
         "enable_duplication": True},
        {"components": True, "grudge": True, "stall": True, "p_dup": 0.3}),
    "broadcast-uniform-loss-stall": (
        "broadcast", 2, "uniform", {"enable_stall": True},
        {"p_loss": 0.03, "stall": True}),
    "broadcast-exponential-partitions-dup": (
        "broadcast", 2, "exponential",
        {"partition_groups": 5, "enable_duplication": True},
        {"p_loss": 0.03, "components": True, "grudge": True, "p_dup": 0.3,
         "scale": True}),
    "broadcast-constant-soup": (
        "broadcast", 1, "constant",
        {"partition_groups": 5, "enable_stall": True,
         "enable_duplication": True},
        {"components": True, "grudge": True, "stall": True, "p_dup": 0.3,
         "p_loss": 0.03}),
}


def _faulted_setup(name, F=3, seed=3):
    prog, lat, dist, flags, faults = FAULTED[name]
    opts = {"latency": {"mean": lat, "dist": dist}, "max_values": 32}
    if flags.get("enable_duplication"):
        opts["nemesis"] = {"duplicate"}
    jprog = j_get_program(prog, opts, NODES)
    pprog = p_get_program(prog, opts, NODES, device="cpu")
    kw = dict(n_nodes=5, n_clients=3, pool_cap=64,
              inbox_cap=jprog.inbox_cap, client_cap=4,
              latency_mean_rounds=float(lat), latency_dist=dist, **flags)
    jcfg, pcfg = JT.NetConfig(**kw), PT.NetConfig(**kw)
    js = j_sims(jprog, jcfg, F, seed=seed)
    rng = np.random.default_rng(seed)
    C, N, G = 8, 5, kw.get("partition_groups", 1)
    upd = {"round": np.array([0, 7, 13, 2, 9, 4][:F], np.int32)}
    if "p_loss" in faults:
        upd["p_loss"] = np.full(F, faults["p_loss"], np.float32)
    if faults.get("scale"):
        upd["latency_scale"] = np.array([1.0, 2.0, 0.5, 1.5, 3.0, 1.0][:F],
                                        np.float32)
    if "p_dup" in faults:
        upd["p_dup"] = np.array([faults["p_dup"], 0.0, 0.6, 0.3, 0.1,
                                 0.2][:F], np.float32)
    if faults.get("components"):
        comp = np.zeros((F, C), np.int32)
        comp[:, :N] = rng.integers(0, 2, (F, N))
        upd["component"] = comp
    if faults.get("grudge"):
        bg = np.zeros((F, C), np.int32)
        bg[:, :N] = rng.integers(0, G, (F, N))
        upd["block_groups"] = bg
        bm = rng.random((F, G, G)) < 0.3
        bm[:, np.arange(G), np.arange(G)] = False
        upd["block_matrix"] = bm
    if faults.get("stall"):
        upd["down"] = rng.random((F, N)) < 0.2
        upd["paused"] = rng.random((F, N)) < 0.2
    js = js.replace(net=js.net.replace(
        **{k: jnp.asarray(v) for k, v in upd.items()}))
    ps = convert.cluster_state_from_numpy(jax_tree_to_numpy(js), pprog,
                                          pcfg, device="cpu")
    return prog, jprog, pprog, jcfg, pcfg, js, ps


def _bcast_plan(F, rounds, seed):
    from maelstrom_tpu_torch.nodes.broadcast import T_BCAST, T_READ
    rng = np.random.default_rng(seed)
    plan = []
    for r in range(rounds):
        shape = (F, 3)
        plan.append({
            "valid": rng.random(shape) < 0.3,
            "src": (5 + rng.integers(0, 3, shape)).astype(np.int32),
            "dest": rng.integers(0, 5, shape, dtype=np.int32),
            "type": np.where(rng.random(shape) < 0.5, T_READ,
                             T_BCAST).astype(np.int32),
            "a": rng.integers(0, 32, shape, dtype=np.int32)})
    return plan


@pytest.mark.parametrize("name", sorted(FAULTED))
def test_cluster_round_under_faults_matches_jax(name):
    """60 rounds of 3 clusters, each under its own faults and at its own
    round, leaf for leaf with JAX's vmapped round (and the digest)."""
    prog, jprog, pprog, jcfg, pcfg, js, ps = _faulted_setup(name)
    F, R = 3, 60
    plan = (golden_plan(F, R) if prog == "lin-kv" else _bcast_plan(F, R, 5))
    jfn = j_round_fn(jprog, jcfg)
    pfn = PP.make_cluster_round_fn(pprog, pcfg, device="cpu")
    empty_j = JT.Msgs.empty((F, 3))
    for r in range(R):
        rows = plan[r]
        inj_j = empty_j if rows is None else empty_j.replace(
            **{k: jnp.asarray(v) for k, v in rows.items()})
        inj_p = (PT.Msgs.empty((F, 3), "cpu") if rows is None
                 else PP.injection_msgs(rows, "cpu"))
        js, jcm, _ = jfn(js, inj_j)
        ps, pcm, _ = pfn(ps, inj_p)
    ref, got = jax_tree_to_numpy(js), to_numpy(ps)
    assert_trees_equal(ref, got)
    assert digest(ref, F) == digest(got, F)
    st = got["net"]["stats"]
    moved = [k for k in ("lost", "dropped_partition", "dropped_down",
                         "duplicated") if st[k].sum()]
    assert moved, "no fault counter moved"


def test_fleet_sims_rows_are_standalone_sims():
    """make_fleet_sims row i is make_sim(seed_i): JAX's make_fleet_sims
    leaf for leaf, and each row the port's own standalone state."""
    from maelstrom_tpu.parallel import make_fleet_sims as j_fleet_sims
    from maelstrom_tpu_torch.sim import make_sim as p_make_sim
    jprog, pprog = programs()
    jcfg, pcfg = configs(jprog, 3)
    seeds = [7, 8, 2**31 + 5]
    ref = jax_tree_to_numpy(j_fleet_sims(jprog, jcfg, seeds))
    got = to_numpy(PP.make_fleet_sims(pprog, pcfg, seeds, device="cpu"))
    assert_trees_equal(ref, got)
    for i, s in enumerate(seeds):
        row = jax.tree.map(lambda a, i=i: a[i], got)
        assert_trees_equal(to_numpy(p_make_sim(pprog, pcfg, seed=s,
                                               device="cpu")), row)


def test_value_free_test_reads_the_config_and_the_state():
    """The round skips the loss roll and K8 only where no draw can change
    a value: constant latency 0, one partition group, no stall or
    duplication, and in the state the loss probability 0, one component
    a cluster and a finite latency scale; a leaf written in place is read
    again."""
    import dataclasses
    jprog, pprog = programs()
    _, pcfg = configs(jprog, 3)
    sims = PP.make_cluster_sims(pprog, pcfg, 3, seed=1, device="cpu")
    test = PP.value_free_test(pcfg)
    assert test(sims.net)
    net = sims.net.replace(p_loss=sims.net.p_loss.clone())
    net.p_loss[1] = 0.03
    assert not test(net)
    net.p_loss[1] = 0.0
    assert test(net)
    comp = sims.net.component.clone()
    comp[2, 0] = 1
    assert not test(sims.net.replace(component=comp))
    scale = sims.net.latency_scale.clone()
    scale[0] = float("inf")
    assert not test(sims.net.replace(latency_scale=scale))
    assert test(sims.net)
    for over in ({"latency_mean_rounds": 1.0}, {"latency_dist": "uniform"},
                 {"partition_groups": 5}, {"enable_stall": True},
                 {"enable_duplication": True}):
        cfg = dataclasses.replace(pcfg, **over)
        assert not PP.value_free_test(cfg)(sims.net), over


def test_value_free_round_equals_the_fault_pass():
    """The value-free round (no loss roll, no K8) leaves every leaf as
    the round with the fault pass does: 200 rounds of the golden
    scenario's traffic at F 4, leaf for leaf."""
    from maelstrom_tpu_torch.sim import _round_edge
    _, pprog = programs()
    _, pcfg = configs(pprog, 3)
    plan = golden_plan(4, 200)
    fast = PP.make_cluster_sims(pprog, pcfg, 4, seed=3, device="cpu")
    slow = PP.make_cluster_sims(pprog, pcfg, 4, seed=3, device="cpu")
    axis = PP.cluster_axis(pprog, 4)
    test = PP.value_free_test(pcfg)
    empty = PT.Msgs.empty((4, 3), "cpu")
    for rows in plan:
        inj = empty if rows is None else PP.injection_msgs(rows, "cpu")
        assert test(fast.net)
        fast = _round_edge(pprog, pcfg, fast, inj, axis, True)[0]
        slow = _round_edge(pprog, pcfg, slow, inj, axis, False)[0]
    assert_trees_equal(to_numpy(slow), to_numpy(fast))
    assert int(to_numpy(fast.nodes)["applied"].max()) > 10


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
