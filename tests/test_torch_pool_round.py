"""The port's pool-path round against the JAX package's, leaf for leaf.

Echo and unique-ids are pool-path programs: node replies travel through
the flight pool, not the edge channels (the JAX package's `_round` for
programs without `is_edge`, `sim.py:412-460`). The same program,
`NetConfig`, seed, faults (installed through each package's fault API)
and plan of injections go through both packages' `make_run_fn` for R
rounds. A plan mixes client requests with requests a node sends another
node, so node-to-node pool traffic meets latency, partitions,
duplication and stalled destinations too. The configs are the JAX
tests' pool shapes: the flight-pool oracle's 4 nodes, 64-slot pool and
2-slot inboxes (`tests/test_tpu_net_oracle.py`), the fault soup's 5
nodes under a partition with 3% loss at constant latency 5 or 2% loss
at exponential latency 3 (`tests/test_fault_soup.py`), and 64 nodes
under kills, pauses, duplication and component partitions. Tolerance:
exact, on every `SimState` leaf (the threefry `key` and every `NetStats`
counter among them), on the collected client messages' valid rows, and,
at the step level, on every field of the outbox, invalid rows
included."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.sim import _freeze_nodes
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_scan_fn as j_make_scan_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.sim import make_run_fn as p_make_run_fn
from maelstrom_tpu_torch.sim import make_scan_fn as p_make_scan_fn
from test_torch_faults import _install
from test_torch_kernels_gpu import random_pool_inbox
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

# the request type code of each program (T_ECHO, T_GEN)
REQUEST = {"echo": 10, "unique-ids": 10}
N_CLIENTS = 3

# name: (program, nodes, inbox cap (None: the program's), pool, latency
#        mean, dist, NetConfig flags, faults installed, rounds)
CONFIGS = {
    "echo5": ("echo", 5, None, 256, 0, "constant", {}, {}, 30),
    "uid4-oracle-inbox2": ("unique-ids", 4, 2, 64, 2, "constant", {}, {},
                           30),
    "echo5-soup-constant": ("echo", 5, None, 256, 5, "constant",
                            {"partition_groups": 5},
                            {"p_loss": 0.03, "grudge": "split_half"}, 40),
    "uid5-soup-reordering": ("unique-ids", 5, None, 256, 3, "exponential",
                             {"partition_groups": 5},
                             {"p_loss": 0.02, "scale": 2.0,
                              "grudge": "one_way_halves"}, 40),
    "echo64-stall-dup-uniform": ("echo", 64, None, 1024, 2, "uniform",
                                 {"enable_stall": True,
                                  "enable_duplication": True},
                                 {"down": 0.2, "paused": 0.2, "p_dup": 0.3,
                                  "p_loss": 0.02}, 30),
    "uid64-components-stall": ("unique-ids", 64, None, 1024, 2, "constant",
                               {"enable_stall": True},
                               {"components": True, "down": 0.1,
                                "paused": 0.1}, 30),
}


@functools.lru_cache(maxsize=None)
def _setup(name):
    prog, n, inbox, pool, lat, dist, flags, _f, _R = CONFIGS[name]
    nodes = [f"n{i}" for i in range(n)]
    jprog = j_get_program(prog, {}, nodes)
    pprog = p_get_program(prog, {}, nodes, device="cpu")
    if inbox is not None:
        for p in (jprog, pprog):
            p.inbox_cap = p.outbox_cap = inbox
    kw = dict(n_nodes=n, n_clients=N_CLIENTS, pool_cap=pool,
              inbox_cap=jprog.inbox_cap, client_cap=8,
              latency_mean_rounds=float(lat), latency_dist=dist, **flags)
    return jprog, pprog, JT.NetConfig(**kw), PT.NetConfig(**kw)


def _plan(n, R, M, req, seed):
    """M injections a round: requests (and some other type codes, which
    the programs ignore) from clients, or from a node to another node."""
    rng = np.random.default_rng(seed)
    from_node = rng.random((R, M)) < 0.4
    src = np.where(from_node, rng.integers(0, n, (R, M)),
                   n + rng.integers(0, N_CLIENTS, (R, M)))
    typ = np.where(rng.random((R, M)) < 0.85, req, req + 5)
    return {"valid": rng.random((R, M)) < 0.8,
            "src": src.astype(np.int32),
            "dest": rng.integers(0, n, (R, M), dtype=np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": np.zeros((R, M), np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": typ.astype(np.int32),
            "a": rng.integers(0, 100, (R, M), dtype=np.int32),
            "b": np.zeros((R, M), np.int32), "c": np.zeros((R, M), np.int32)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pool_rounds_match_jax(name):
    jprog, pprog, jcfg, pcfg = _setup(name)
    prog, n, _i, _p, _l, _d, _fl, faults, R = CONFIGS[name]
    jsim = j_make_sim(jprog, jcfg, seed=13)
    assert jsim.channels is None
    start = jax_tree_to_numpy(jsim)
    jsim = jsim.replace(net=_install(JT, jsim.net, faults, n, 5))
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    psim = psim.replace(net=_install(PT, psim.net, faults, n, 5))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    plan = _plan(n, R, 6, REQUEST[prog], seed=R + n)
    jsim, jmsgs = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in plan.items()}))
    psim, pmsgs = p_make_run_fn(pprog, pcfg, collect_client_msgs=True,
                                device="cpu")(
        psim, convert.msgs_from_numpy(plan, device="cpu"))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    assert_msgs_equal_on_valid(jmsgs, pmsgs)
    st = JT.stats_dict(jsim.net)
    assert st["recv_all"] > 0 and st["sent_servers"] > 0
    # the config's faults happened
    if "p_loss" in faults:
        assert st["lost"] > 0
    if "p_dup" in faults:
        assert st["duplicated"] > 0
    if "grudge" in faults or "components" in faults:
        assert st["dropped_partition"] > 0
    if "down" in faults:
        assert st["dropped_down"] > 0
    # the state round-trips through convert
    assert_trees_equal(convert.state_to_numpy(psim), as_numpy(psim))


@pytest.mark.parametrize("prog", list(REQUEST))
@pytest.mark.parametrize("stalled", [False, True])
def test_pool_steps_match_jax(prog, stalled):
    """The step (K11's and K12's plain versions) on a random inbox,
    counters near the int32 limit included (minted ids and the counter
    wrap as XLA's int32 arithmetic does), and with the stall mask the
    JAX round's freeze and output mask after the step."""
    n, K = 37, 8
    nodes = [f"n{i}" for i in range(n)]
    jprog = j_get_program(prog, {}, nodes)
    pprog = p_get_program(prog, {}, nodes, device="cpu")
    rng = np.random.default_rng(int(stalled) + len(prog))
    inbox = random_pool_inbox(rng, n, K, REQUEST[prog])
    key = "rounds" if prog == "echo" else "counter"
    counter = rng.integers(0, 1000, n).astype(np.int32)
    counter[:4] = 2**31 - 1 - np.arange(4)
    stall = rng.random(n) < 0.4
    rnd = np.int32(17)
    jstate = {key: jnp.asarray(counter)}
    jnew, jout = jprog.step(jstate, JT.Msgs(**{
        k: jnp.asarray(v) for k, v in inbox.items()}),
        {"round": jnp.asarray(rnd), "key": None})
    ctx = {"round": torch.tensor(rnd)}
    if stalled:
        jnew = _freeze_nodes(jprog, jnp.asarray(stall), jstate, jnew)
        jout = jout.replace(valid=jout.valid & ~jnp.asarray(stall)[:, None])
        ctx["stall"] = torch.tensor(stall)
    pnew, pout = pprog.step({key: torch.tensor(counter)},
                            convert.msgs_from_numpy(inbox, device="cpu"),
                            ctx)
    assert_trees_equal(jax_tree_to_numpy(jnew), as_numpy(pnew))
    assert_trees_equal(jax_tree_to_numpy(jout), as_numpy(pout))
    assert as_numpy(pout)["valid"].any()


@pytest.mark.parametrize("prog,journal", [("echo", True),
                                          ("unique-ids", False)])
def test_pool_scan_matches_jax(prog, journal):
    """The scan-ahead over the pool round (the runner's dispatch), with
    the reply log and, journaled, the [cap, ...] io buffers of inject,
    outbox and inbox rows."""
    name = "echo5" if prog == "echo" else "uid5-soup-reordering"
    jprog, pprog, jcfg, pcfg = _setup(name)
    n = jcfg.n_nodes
    jsim = j_make_sim(jprog, jcfg, seed=5)
    start = jax_tree_to_numpy(jsim)
    inj = {k: v[0] for k, v in _plan(n, 1, N_CLIENTS, REQUEST[prog],
                                     seed=9).items()}
    inj["src"] = (n + np.arange(N_CLIENTS)).astype(np.int32)
    kw = {"reply_cap": 16, "journal_cap": 48 if journal else None}
    out_j = j_make_scan_fn(jprog, jcfg, **kw)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in inj.items()}),
        jnp.int32(40), False)
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    out_p = p_make_scan_fn(pprog, pcfg, device="cpu", chunk=8, **kw)(
        psim, convert.msgs_from_numpy(inj, device="cpu"), 40, False)
    assert out_p[2] == int(out_j[2]) == 40
    assert_trees_equal(jax_tree_to_numpy(out_j[0]), as_numpy(out_p[0]))
    rlog_j, rounds_j, plog_j, rn_j = out_j[3]
    rlog_p, rounds_p, plog_p, rn_p = out_p[3]
    for name_, a, b in (("rlog", rlog_j, rlog_p),
                        ("rounds", rounds_j, rounds_p), ("rn", rn_j, rn_p)):
        assert_trees_equal(as_numpy(a), as_numpy(b), path=name_)
    # no payload: JAX keeps an empty [rcap, 0] plane, the port none
    assert plog_p is None and np.asarray(plog_j).size == 0
    assert int(out_p[3][3]) > 0
    if journal:
        for i, (a, b) in enumerate(zip(out_j[4], out_p[4])):
            assert_trees_equal(jax_tree_to_numpy(a), as_numpy(b),
                               path=f"buf[{i}]")
