"""The port's fleet scan (`sim.make_fleet_scan_fn`, K32 holds and K5's
fleet form) against the JAX package's vmapped scan
(`maelstrom_tpu/sim.py` `make_fleet_scan_fn`), with
`parallel.make_fleet_sims` against JAX's.

Three lanes (clusters) of raft lin-kv and of broadcast, under
randomized latency and loss, each lane with its own k_max; one lane
stops on its first reply, one is inactive (held whole: it returns its
input row, k 0 and rn 0). A second dispatch starts from the first's
output. Equal: every state leaf (the keys among them: a held lane's key
does not advance), k, rn and each lane's reply rows below its rn; cm on
the active lanes. Tolerance: exact (int32, bool and uint32 leaves)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.parallel import make_fleet_sims as j_fleet_sims
from maelstrom_tpu.sim import make_fleet_scan_fn as j_fleet_scan
from maelstrom_tpu_torch import parallel as PP
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.sim import (fleet_hold, fleet_hold_plain,
                                     make_fleet_scan_fn)
from maelstrom_tpu_torch.tree import to_numpy
from test_torch_support import assert_trees_equal, jax_tree_to_numpy

NODES = [f"n{i}" for i in range(5)]
SEEDS = [7, 8, 9]
# program: (workload, latency mean, dist, request types)
PROGRAMS = {"lin-kv": ("lin-kv", 2, "uniform", (10, 12)),
            "broadcast": ("broadcast", 1, "exponential", (10, 12))}


def _setup(name):
    prog, lat, dist, _types = PROGRAMS[name]
    opts = {"latency": {"mean": lat, "dist": dist}, "max_values": 32}
    jprog = j_get_program(prog, opts, NODES)
    pprog = p_get_program(prog, opts, NODES, device="cpu")
    kw = dict(n_nodes=5, n_clients=3, pool_cap=64,
              inbox_cap=jprog.inbox_cap, client_cap=6,
              latency_mean_rounds=float(lat), latency_dist=dist)
    jcfg, pcfg = JT.NetConfig(**kw), PT.NetConfig(**kw)
    js = j_fleet_sims(jprog, jcfg, SEEDS)
    js = js.replace(net=js.net.replace(
        p_loss=jnp.asarray(np.array([0.03, 0.0, 0.05], np.float32))))
    ps = PP.make_fleet_sims(pprog, pcfg, SEEDS, device="cpu")
    ps = ps.replace(net=ps.net.replace(
        p_loss=torch.tensor([0.03, 0.0, 0.05], dtype=torch.float32)))
    return jprog, pprog, jcfg, pcfg, js, ps


def _inject(name, seed):
    types = PROGRAMS[name][3]
    rng = np.random.default_rng(seed)
    F, C = len(SEEDS), 3
    return {"valid": rng.random((F, C)) < 0.7,
            "src": (5 + rng.integers(0, 3, (F, C))).astype(np.int32),
            "dest": rng.integers(0, 5, (F, C), dtype=np.int32),
            "type": rng.choice(np.array(types, np.int32), (F, C)),
            "a": rng.integers(0, 8, (F, C), dtype=np.int32),
            "b": rng.integers(0, 5, (F, C), dtype=np.int32),
            "c": rng.integers(0, 5, (F, C), dtype=np.int32)}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fleet_scan_matches_jax(name):
    jprog, pprog, jcfg, pcfg, js, ps = _setup(name)
    jfn = j_fleet_scan(jprog, jcfg, reply_cap=64)
    pfn = make_fleet_scan_fn(pprog, pcfg, reply_cap=64, device="cpu")
    empty = JT.Msgs.empty((len(SEEDS), 3))
    # dispatch 1: distinct k_max, lane 1 stops on a reply, lane 2 held;
    # dispatch 2: lane 0 held, the others run on
    for kmax, stop, active, seed in (([40, 300, 25], [False, True, False],
                                      [True, True, False], 1),
                                     ([17, 60, 90], [False, False, True],
                                      [False, True, True], 2)):
        rows = _inject(name, seed)
        inj = empty.replace(**{k: jnp.asarray(v) for k, v in rows.items()})
        js, jcm, jk, jlog = jfn(js, inj, np.asarray(kmax, np.int32),
                                np.asarray(stop), np.asarray(active))
        ps, pcm, pk, plog = pfn(ps, PP.injection_msgs(rows, "cpu"), kmax,
                                stop, active)
        ref, got = jax_tree_to_numpy(js), to_numpy(ps)
        assert_trees_equal(ref, got)
        jk, pk = np.asarray(jk), pk.numpy()
        np.testing.assert_array_equal(pk, jk)
        assert (pk[~np.asarray(active)] == 0).all()
        assert pk[np.asarray(active)].min() >= 1
        jrl, jrounds, jplog, jrn = (
            None if isinstance(x, tuple) else jax_tree_to_numpy(x)
            for x in jlog)
        prl, prounds, pplog, prn = (None if x is None else to_numpy(x)
                                    for x in plog)
        np.testing.assert_array_equal(prn, jrn)
        for f in range(len(SEEDS)):
            n = min(int(prn[f]), prounds.shape[1])
            assert_trees_equal({k: v[f, :n] for k, v in jrl.items()},
                               {k: v[f, :n] for k, v in prl.items()})
            np.testing.assert_array_equal(prounds[f, :n], jrounds[f, :n])
            if pplog is not None:
                np.testing.assert_array_equal(pplog[f, :n], jplog[f, :n])
        jcm, pcm = jax_tree_to_numpy(jcm), to_numpy(pcm)
        act = np.asarray(active)
        assert_trees_equal({k: v[act] for k, v in jcm.items()},
                           {k: v[act] for k, v in pcm.items()})
    assert pfn.rounds > 0


def test_fleet_scan_with_no_active_lane_returns_its_input():
    _jprog, pprog, _jcfg, pcfg, _js, ps = _setup("broadcast")
    before = to_numpy(ps)
    pfn = make_fleet_scan_fn(pprog, pcfg, reply_cap=64, device="cpu")
    out, _cm, k, log = pfn(ps, PP.injection_msgs(_inject("broadcast", 3),
                                                 "cpu"),
                           [5, 5, 5], [True] * 3, [False] * 3)
    assert_trees_equal(before, to_numpy(out))
    assert k.tolist() == [0, 0, 0] and log[3].tolist() == [0, 0, 0]
    assert pfn.rounds == 0


def test_fleet_hold_is_where_live_new_old():
    """K32's plain version and the wrapper's pair handling: held rows of
    every dtype revert, live rows keep the new values, a pair whose dst
    is its src and a repeated dst are skipped."""
    rng = np.random.default_rng(0)
    F = 6
    live = torch.tensor([True, False, True, False, False, True])
    new = [torch.from_numpy(rng.integers(0, 9, (F, 3, 2)).astype(np.int32)),
           torch.from_numpy(rng.random((F, 4)) < 0.5),
           torch.from_numpy(rng.integers(0, 2**32, (F, 2), dtype=np.uint64)
                            .astype(np.int64)).to(torch.uint32)]
    old = [t.clone() for t in new]
    for t in old:
        t.view(torch.uint8).bitwise_xor_(0xFF) if t.dtype != torch.bool \
            else t.logical_not_()
    want = [torch.where(live.reshape((-1,) + (1,) * (n.dim() - 1)),
                        n.view(torch.int32) if n.dtype == torch.uint32
                        else n,
                        o.view(torch.int32) if o.dtype == torch.uint32
                        else o) for n, o in zip(new, old)]
    same = torch.arange(F)
    row = fleet_hold(live, list(zip(new, old)) + [(same, same),
                                                  (new[0], old[0])])
    assert row == 3 * 2 * 4 + 4 + 2 * 4
    for n, w in zip(new, want):
        got = n.view(torch.int32) if n.dtype == torch.uint32 else n
        assert torch.equal(got, w)
    a, b = torch.zeros(F, 2, dtype=torch.int32), torch.ones(F, 2,
                                                            dtype=torch.int32)
    fleet_hold_plain(live, [(a, b)])
    assert a[:, 0].tolist() == [0, 1, 0, 1, 1, 0]


def test_fleet_scan_prefix_of_a_bigger_fleet():
    """Lane i of a 3-lane fleet equals lane i of the same lanes inside a
    5-lane fleet whose extra lanes run other k_max: a lane's run depends
    only on its own row and bounds."""
    _jprog, pprog, _jcfg, pcfg, _js, _ps = _setup("lin-kv")
    outs = []
    for seeds, kmax in ((SEEDS, [30, 12, 45]),
                        (SEEDS + [3, 4], [30, 12, 45, 80, 2])):
        ps = PP.make_fleet_sims(pprog, pcfg, seeds, device="cpu")
        pfn = make_fleet_scan_fn(pprog, pcfg, reply_cap=64, device="cpu")
        F = len(seeds)
        rows = {k: np.concatenate([v, v[:F - 3]]) if F > 3 else v
                for k, v in _inject("lin-kv", 4).items()}
        out, _cm, k, log = pfn(ps, PP.injection_msgs(rows, "cpu"), kmax,
                               [False] * F, [True] * F)
        outs.append((jax.tree.map(lambda a: a[:3], to_numpy(out)),
                     k[:3].tolist()))
    assert_trees_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
