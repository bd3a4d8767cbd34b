"""The port's round under faults against the JAX package's, leaf for leaf.

The same broadcast program, `NetConfig` and seed go through both
packages' `make_run_fn` for R rounds, with the same faults installed
through each package's fault API (`net/tpu.py` partition_components,
partition_grudge, set_down, set_paused, flaky, set_duplication,
set_latency_scale) and the same plan of client injections. Tolerance:
exact, on every `SimState` leaf (the threefry `key`, every `NetStats`
counter, `lat_clipped` and `overwrites` among them) and on the collected
client messages' valid rows. The exponential configs hold because their
latency rounds agree (`tests/test_torch_prng.py`)."""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu import nemesis as jnem
from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.nodes.broadcast import T_BCAST, T_READ
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch import nemesis as pnem
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.sim import make_run_fn as p_make_run_fn
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

# name: (nodes, topology, latency mean, dist, program opts, cfg flags,
#        faults installed, rounds)
CONFIGS = {
    "grid64-loss": (64, "grid", 2, "constant", {}, {},
                    {"p_loss": 0.05}, 40),
    "grid64-uniform": (64, "grid", 3, "uniform", {}, {},
                       {"p_loss": 0.05}, 40),
    "grid64-exponential": (64, "grid", 3, "exponential", {}, {},
                           {"p_loss": 0.05, "scale": 2.0}, 40),
    "grid64-partitions": (64, "grid", 2, "constant", {},
                          {"partition_groups": 64},
                          {"components": True, "grudge": "one_way_halves"},
                          40),
    "grid64-stall": (64, "grid", 2, "constant", {}, {"enable_stall": True},
                     {"down": 0.2, "paused": 0.2}, 40),
    "grid64-dup": (64, "grid", 2, "constant", {},
                   {"enable_duplication": True}, {"p_dup": 0.3}, 40),
    "grid64-dup-uniform": (64, "grid", 3, "uniform", {},
                           {"enable_duplication": True, "enable_stall": True},
                           {"p_dup": 0.3, "down": 0.1, "p_loss": 0.02}, 40),
    # past 4,096 nodes randomized latency takes the plain per-lane write
    # (no spill): a duplicate can land on its original's cell
    "grid4100-uniform-dup": (4100, "grid", 2, "uniform", {},
                             {"enable_duplication": True},
                             {"p_dup": 0.5, "p_loss": 0.01}, 16),
    "grid9-spill-exponential": (9, "grid", 3, "exponential",
                                {"naive_broadcast": True,
                                 "max_latency_scale": 2}, {}, {}, 60),
}


def _setup(name):
    n, topo, lat, dist, popts, flags, faults, R = CONFIGS[name]
    nodes = [f"n{i}" for i in range(n)]
    opts = {"topology": topo, "max_values": 32,
            "latency": {"mean": lat, "dist": dist}, **popts}
    if flags.get("enable_duplication"):
        opts["nemesis"] = {"duplicate"}
    jprog = j_get_program("broadcast", opts, nodes)
    pprog = p_get_program("broadcast", opts, nodes, device="cpu")
    kw = dict(n_nodes=n, n_clients=3, pool_cap=256,
              inbox_cap=jprog.inbox_cap, client_cap=4,
              latency_mean_rounds=float(lat), latency_dist=dist, **flags)
    return (jprog, pprog, JT.NetConfig(**kw), PT.NetConfig(**kw), faults,
            R)


def _plan(n, V, R, M, seed):
    rng = np.random.default_rng(seed)
    rr = np.arange(R)[:, None] * M + np.arange(M)[None, :]
    read = (rr >= V) & (rng.random((R, M)) < 0.6)
    return {"valid": rng.random((R, M)) < 0.8,
            "src": (n + rng.integers(0, 3, (R, M))).astype(np.int32),
            "dest": rng.integers(0, n, (R, M), dtype=np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": np.zeros((R, M), np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": np.where(read, T_READ, T_BCAST).astype(np.int32),
            "a": (rr % V).astype(np.int32),
            "b": np.zeros((R, M), np.int32), "c": np.zeros((R, M), np.int32)}


def _install(T, net, faults, n, seed):
    """The faults of a config through package T's fault API."""
    rng = np.random.default_rng(seed)
    if "p_loss" in faults:
        net = T.flaky(net, faults["p_loss"])
    if "scale" in faults:
        net = T.set_latency_scale(net, faults["scale"])
    if "p_dup" in faults:
        net = T.set_duplication(net, faults["p_dup"])
    if faults.get("components"):
        net = T.partition_components(net, (np.arange(n) % 3).astype(
            np.int32))
    if "grudge" in faults:
        nodes = [f"n{i}" for i in range(n)]
        fn = getattr(jnem, faults["grudge"])
        _name, grudge = fn(nodes, random.Random(seed))
        groups, matrix = jnem.grudge_matrix(nodes, grudge)
        net = T.partition_grudge(net, groups, matrix)
    if "down" in faults:
        net = T.set_down(net, rng.random(n) < faults["down"])
    if "paused" in faults:
        net = T.set_paused(net, rng.random(n) < faults["paused"])
    return net


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_faulty_rounds_match_jax(name):
    jprog, pprog, jcfg, pcfg, faults, R = _setup(name)
    n = jcfg.n_nodes
    jsim = j_make_sim(jprog, jcfg, seed=11)
    jsim = jsim.replace(net=_install(JT, jsim.net, faults, n, 5))
    # the port starts from the JAX state (key included) and installs the
    # same faults through its own fault API
    start = jax_tree_to_numpy(j_make_sim(jprog, jcfg, seed=11))
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    psim = psim.replace(net=_install(PT, psim.net, faults, n, 5))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    plan = _plan(n, 32, R, 3, seed=R + n)
    jsim, jmsgs = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in plan.items()}))
    psim, pmsgs = p_make_run_fn(pprog, pcfg, collect_client_msgs=True,
                                device="cpu")(
        psim, convert.msgs_from_numpy(plan, device="cpu"))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    assert_msgs_equal_on_valid(jmsgs, pmsgs)
    st = JT.stats_dict(jsim.net)
    # the config's faults happened
    if "p_loss" in faults:
        assert st["lost"] > 0
    if "p_dup" in faults:
        assert st["duplicated"] > 0
    if "components" in faults or "grudge" in faults:
        assert st["dropped_partition"] > 0
    if "down" in faults or "paused" in faults:
        assert st["dropped_down"] > 0
    if pprog.edge_cfg.spill:
        # the collision case: spill lanes were used, nothing destroyed
        assert int(psim.channels.overwrites) == 0
    if name == "grid4100-uniform-dup":
        assert not pprog.edge_cfg.spill
        assert int(psim.channels.overwrites) > 0
    if name == "grid9-spill-exponential":
        assert pprog.edge_cfg.spill and pprog.edge_cfg.lanes == 8


def test_nemesis_decisions_match_jax():
    """The copy of the decision streams draws what the JAX package's
    draws, package by package, and the schedules emit the same ops."""
    nodes = [f"n{i}" for i in range(11)]
    jd = jnem.NemesisDecisions(nodes, 7)
    pd = pnem.NemesisDecisions(nodes, 7)
    for _ in range(6):
        assert jd.next_grudge() == pd.next_grudge()
        assert jd.next_kill_targets() == pd.next_kill_targets()
        assert jd.next_pause_targets() == pd.next_pause_targets()
        assert jd.next_dup_prob() == pd.next_dup_prob()
        assert jd.next_weather() == pd.next_weather()
    for name in ("split_half", "isolate_node", "bridge", "majorities_ring",
                 "one_way_halves"):
        _n, grudge = getattr(jnem, name)(nodes, random.Random(3))
        for a, b in zip(jnem.grudge_matrix(nodes, grudge),
                        pnem.grudge_matrix(nodes, grudge)):
            np.testing.assert_array_equal(a, b)
    faults = {"partition", "kill", "pause", "duplicate", "weather"}
    jp, pp = jnem.package(faults, 0.5), pnem.package(faults, 0.5)
    assert jp["faults"] == pp["faults"]
    # the byzantine package schedules its windows as JAX's does
    faults = faults | {"byzantine"}
    jp, pp = jnem.package(faults, 0.5), pnem.package(faults, 0.5)
    assert jp["faults"] == pp["faults"]


def test_restore_and_fault_api_match_jax():
    """Crash-restart from the durable store and the rest of the fault
    API (heal, slow, fast, set_weather) against the JAX package's."""
    jprog, pprog, jcfg, pcfg, _f, _R = _setup("grid64-stall")
    jnet = _install(JT, JT.make_net(jcfg), {"components": True,
                                            "down": 0.3}, 64, 1)
    pnet = _install(PT, PT.make_net(pcfg, "cpu"), {"components": True,
                                                   "down": 0.3}, 64, 1)
    for jf, pf in ((JT.heal, PT.heal), (lambda n: JT.slow(n, 3.0),
                                        lambda n: PT.slow(n, 3.0)),
                   (JT.fast, PT.fast),
                   (lambda n: JT.set_weather(n, 0.1, 5.0),
                    lambda n: PT.set_weather(n, 0.1, 5.0))):
        jnet, pnet = jf(jnet), pf(pnet)
        assert_trees_equal(jax_tree_to_numpy(jnet), as_numpy(pnet))
    rng = np.random.default_rng(2)
    mask = rng.random(64) < 0.3
    state = {k: rng.random(v.shape) < 0.5 for k, v in
             as_numpy(pprog.init_state()).items()}
    for durable_keys in (None, ("seen",)):
        jprog.durable_keys = pprog.durable_keys = durable_keys
        fresh = pprog.init_state()
        durable = pprog.durable_view({k: torch.tensor(v) for k, v in
                                      state.items()})
        got = pprog.restore(fresh, durable, {k: torch.tensor(v) for k, v
                                             in state.items()},
                            torch.tensor(mask))
        ref = jprog.restore(jprog.init_state(), jprog.durable_view(
            {k: jnp.asarray(v) for k, v in state.items()}),
            {k: jnp.asarray(v) for k, v in state.items()},
            jnp.asarray(mask))
        assert_trees_equal(jax_tree_to_numpy(ref), as_numpy(got))
