"""The port's slice as a whole: `make_sim` + `make_run_fn` in both
packages run a plan of broadcasts, then reads, for R rounds, and the
port's bench reports the reference's message count. Tolerance: exact, on
every `SimState` leaf (the threefry `key` included), on the per-round
reply counts, and on the collected client messages' valid rows."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.nodes.broadcast import T_BCAST, T_READ
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch.bench import injection_plan, run_broadcast_bench
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.sim import _freeze, make_round_fn
from maelstrom_tpu_torch.sim import make_run_fn as p_make_run_fn
from maelstrom_tpu_torch.sim import make_sim as p_make_sim
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

MODES = {"efficient": {}, "eager": {"eager_resend": True},
         "naive": {"naive_broadcast": True}}


def _setup(n, V, mode, lat=0, client_cap=2, pool=256, n_clients=3,
           per_nb=None):
    nodes = [f"n{i}" for i in range(n)]
    opts = {"topology": "grid", "max_values": V, "latency": {"mean": lat},
            **MODES[mode]}
    if per_nb is not None:
        opts["gossip_per_neighbor"] = per_nb
    jprog = j_get_program("broadcast", opts, nodes)
    pprog = p_get_program("broadcast", opts, nodes, device="cpu")
    kw = dict(n_nodes=n, n_clients=n_clients, pool_cap=pool,
              inbox_cap=jprog.inbox_cap, client_cap=client_cap,
              latency_mean_rounds=float(lat))
    return jprog, pprog, JT.NetConfig(**kw), PT.NetConfig(**kw)


def _plan(n, V, R, M, n_clients, seed):
    """M injections a round: broadcasts of every value first, then a mix
    of reads and broadcasts, from random clients to random nodes."""
    rng = np.random.default_rng(seed)
    rr = np.arange(R)[:, None] * M + np.arange(M)[None, :]
    read = (rr >= V) & (rng.random((R, M)) < 0.7)
    return {"valid": rng.random((R, M)) < 0.8,
            "src": (n + rng.integers(0, n_clients, (R, M))).astype(np.int32),
            "dest": rng.integers(0, n, (R, M), dtype=np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": np.zeros((R, M), np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": np.where(read, T_READ, T_BCAST).astype(np.int32),
            "a": (rr % V).astype(np.int32),
            "b": np.zeros((R, M), np.int32), "c": np.zeros((R, M), np.int32)}


def _run_both(jprog, pprog, jcfg, pcfg, plan, seed=3):
    jsim = j_make_sim(jprog, jcfg, seed=seed)
    psim = p_make_sim(pprog, pcfg, seed=seed, device="cpu")
    start = jax_tree_to_numpy(jsim)
    assert_trees_equal(start, as_numpy(psim))
    jsim, jmsgs = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in plan.items()}))
    # the port starts from the JAX state itself, carried across
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    psim, pmsgs = p_make_run_fn(pprog, pcfg, collect_client_msgs=True,
                                device="cpu")(
        psim, convert.msgs_from_numpy(plan, device="cpu"))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    assert_msgs_equal_on_valid(jmsgs, pmsgs)
    return jsim, psim, jmsgs, pmsgs


@pytest.mark.parametrize("mode,V,lat", [("efficient", 32, 0),
                                        ("eager", 64, 0),
                                        ("naive", 64, 0),
                                        ("efficient", 64, 2)])
def test_run_matches_jax_64_node_grid(mode, V, lat):
    jprog, pprog, jcfg, pcfg = _setup(64, V, mode, lat=lat)
    plan = _plan(64, V, R=36, M=3, n_clients=3, seed=V + lat)
    jsim, psim, jmsgs, pmsgs = _run_both(jprog, pprog, jcfg, pcfg, plan)
    # several injections a round against client_cap 2: the compaction
    # truncates, and the stats still count every reply
    per_round = np.asarray(jmsgs.valid).sum(axis=1)
    assert per_round.max() >= 2
    assert int(psim.net.stats.recv_all) > 0
    # the count-only run gives the same per-round reply counts
    psim2 = convert.state_from_numpy(
        jax_tree_to_numpy(j_make_sim(jprog, jcfg, seed=3)), pprog, pcfg,
        device="cpu")
    _s, counts = p_make_run_fn(pprog, pcfg, device="cpu")(
        psim2, convert.msgs_from_numpy(plan, device="cpu"))
    np.testing.assert_array_equal(counts.numpy(), per_round)
    assert counts.dtype == torch.int32


def test_run_matches_jax_graft_shape():
    """The shape of the graft entry point (`__graft_entry__.entry`): 1024-node
    grid, pool 16384, 32 values, 4 gossip lanes a edge."""
    jprog, pprog, jcfg, pcfg = _setup(1024, 32, "efficient", client_cap=0,
                                      pool=16384, n_clients=1)
    plan = _plan(1024, 32, R=24, M=2, n_clients=1, seed=7)
    _run_both(jprog, pprog, jcfg, pcfg, plan)


# the least round count at which the 1024-node, 64-value bench converges
# in both modes (injections end at round 128; the grid's diameter is 62)
BENCH_ROUNDS = 181


def test_bench_matches_jax_message_count():
    rec = run_broadcast_bench(n_nodes=1024, values=64, rounds=BENCH_ROUNDS,
                              device="cpu")
    N, V = 1024, 64
    nodes = [f"n{i}" for i in range(N)]
    for eager, key in ((True, "eager_"), (False, "")):
        prog = j_get_program("broadcast", {
            "topology": "grid", "max_values": V, "gossip_per_neighbor": 1,
            "latency": {"mean": 0}, "eager_resend": eager}, nodes)
        cfg = JT.NetConfig(n_nodes=N, n_clients=1, pool_cap=8192,
                           inbox_cap=prog.inbox_cap, client_cap=0)
        plan = injection_plan(N, V, BENCH_ROUNDS, "cpu")
        sim, _ = j_make_run_fn(prog, cfg)(
            j_make_sim(prog, cfg, seed=1),
            JT.Msgs(**{k: jnp.asarray(v) for k, v in
                       as_numpy(plan).items()}))
        st = JT.stats_dict(sim.net)
        converged = bool(np.asarray(sim.nodes["seen"][:, :V]).all())
        assert rec[f"{key}messages_delivered"] == st["recv_all"]
        assert rec[f"{key}converged"] is converged is True
        assert rec[f"{key}dropped_overflow"] == 0
        assert rec[f"{key}overwrites"] == 0


def test_round_fn_and_freeze():
    jprog, pprog, jcfg, pcfg = _setup(16, 32, "efficient")
    sim = p_make_sim(pprog, pcfg, device="cpu")
    inject = convert.msgs_from_numpy(
        {k: v[0] for k, v in _plan(16, 32, 1, 3, 3, 0).items()},
        device="cpu")
    sim2, client_msgs, io = make_round_fn(pprog, pcfg, device="cpu")(
        sim, inject)
    assert int(sim2.net.round) == 1 and len(io) == 5
    # the loss roll runs whatever p_loss is: at 0.5 the round equals the
    # JAX package's, its key split as there
    from maelstrom_tpu.sim import _round as j_round
    jsim = j_make_sim(jprog, jcfg, seed=0)
    jsim = jsim.replace(net=JT.flaky(jsim.net, 0.5))
    psim = convert.state_from_numpy(jax_tree_to_numpy(jsim), pprog, pcfg,
                                    device="cpu")
    jinj = JT.Msgs(**{k: jnp.asarray(v) for k, v in
                      as_numpy(inject).items()})
    for _ in range(3):
        jsim, _jm, _jio = j_round(jprog, jcfg, jsim, jinj)
        psim, _pm, _pio = make_round_fn(pprog, pcfg, device="cpu")(
            psim, inject)
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    assert int(psim.net.stats.lost) > 0
    from maelstrom_tpu.sim import _freeze as j_freeze
    rng = np.random.default_rng(0)
    stall = rng.random(16) < 0.5
    old, new = (rng.random((16, 4, 32)) < 0.5 for _ in range(2))
    ref = j_freeze(jnp.asarray(stall), {"x": jnp.asarray(old)},
                   {"x": jnp.asarray(new)})
    got = _freeze(torch.tensor(stall), {"x": torch.tensor(old)},
                  {"x": torch.tensor(new)})
    assert_trees_equal(jax_tree_to_numpy(ref), as_numpy(got))


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["efficient", "eager"])
def test_reference_counts_16k(mode):
    """Re-derives the JAX reference's message counts that `chip_smoke.py`
    pins for the port's 16,384-node bench (about six minutes a mode on
    eight CPU cores)."""
    from chip_smoke import PINNED_16K
    N, V, R = 16_384, 64, 700
    prog = j_get_program("broadcast", {
        "topology": "grid", "max_values": V, "gossip_per_neighbor": 1,
        "latency": {"mean": 0}, "eager_resend": mode == "eager"},
        [f"n{i}" for i in range(N)])
    cfg = JT.NetConfig(n_nodes=N, n_clients=1, pool_cap=8192,
                       inbox_cap=prog.inbox_cap, client_cap=0)
    plan = as_numpy(injection_plan(N, V, R, "cpu"))
    sim, _ = j_make_run_fn(prog, cfg)(
        j_make_sim(prog, cfg, seed=1),
        JT.Msgs(**{k: jnp.asarray(v) for k, v in plan.items()}))
    assert JT.stats_dict(sim.net)["recv_all"] == PINNED_16K[mode]
    assert bool(np.asarray(sim.nodes["seen"]).all())
