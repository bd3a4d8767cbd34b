"""The port's edge exchange (`maelstrom_tpu_torch/net/static.py`, kernels
K1 edge_read, K2 edge_write and K9 edge_write_spill) against the JAX
package's, on random channel states, outboxes, masks and latencies, with
and without the journaled runs' `sent` plane. Tolerance: exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.net import static as JS
from maelstrom_tpu.workloads.broadcast import TOPOLOGIES, topology_indices
from maelstrom_tpu_torch.net import static as PS
from test_torch_support import assert_trees_equal, jax_tree_to_numpy

LANES = 3

# (ring, uniform_arrival, topology, n_nodes): uniform arrival takes one
# latency a round; ring 3 is the JAX version's ring <= 4 form and ring 8
# its broadcast-select form, with a latency for each lane; the line has
# missing edges (its end nodes have degree 1 of 2)
CASES = [(2, True, "grid", 16), (6, True, "grid", 14), (3, False, "grid", 9),
         (8, False, "grid", 12), (4, True, "line", 7), (8, False, "line", 6)]


def _topology(name, n):
    nodes = [f"n{i}" for i in range(n)]
    nb = topology_indices(TOPOLOGIES[name](nodes), nodes)
    return nb, JS.reverse_index(nb)


def _random_inputs(seed, ring, uniform, topo, n, sent=False):
    rng = np.random.default_rng(seed)
    nb, rev = _topology(topo, n)
    D = nb.shape[1]
    shape = (n, D, ring, LANES)
    ch = {"valid": rng.random(shape) < 0.4,
          **{f: rng.integers(-50, 50, shape, dtype=np.int32)
             for f in ("type", "a", "b", "c")},
          "overwrites": np.int32(rng.integers(0, 9)),
          "lat_clipped": np.int32(rng.integers(0, 9))}
    if sent:
        ch["sent"] = rng.integers(0, 5000, shape, dtype=np.int32)
    oshape = (n, D, LANES)
    out = {"valid": rng.random(oshape) < 0.6,
           **{f: rng.integers(-1000, 1000, oshape, dtype=np.int32)
              for f in ("type", "a", "b", "c")}}
    if uniform:
        lat = np.full(oshape, rng.integers(0, ring + 2), dtype=np.int32)
    else:
        lat = rng.integers(0, ring + 2, oshape, dtype=np.int32)
    mask = rng.random(oshape) < 0.8
    rnd = int(rng.integers(0, 50))
    return nb, rev, ch, out, lat, mask, rnd


def _configs(ring, uniform, nb):
    n, D = nb.shape
    kw = dict(n_nodes=n, degree=D, lanes=LANES, ring=ring,
              uniform_arrival=uniform)
    return JS.EdgeConfig(**kw), PS.EdgeConfig(**kw)


def _jax_channels(ch):
    return JS.EdgeChannels(**{k: jnp.asarray(v) for k, v in ch.items()})


def _torch_channels(ch):
    return PS.EdgeChannels(**{k: torch.tensor(np.asarray(v))
                              for k, v in ch.items()})


@pytest.mark.parametrize("sent", [False, True], ids=["", "sent"])
@pytest.mark.parametrize("ring,uniform,topo,n", CASES)
def test_edge_write_matches_jax(ring, uniform, topo, n, sent):
    nb, rev, ch, out, lat, mask, rnd = _random_inputs(ring * 31 + n, ring,
                                                      uniform, topo, n, sent)
    jcfg, pcfg = _configs(ring, uniform, nb)
    ref = JS.edge_write(
        jcfg, _jax_channels(ch),
        JS.EdgeMsgs(**{k: jnp.asarray(v) for k, v in out.items()}),
        jnp.int32(rnd), jnp.asarray(lat), jnp.asarray(mask))
    got = PS.edge_write(
        pcfg, _torch_channels(ch),
        PS.EdgeMsgs(**{k: torch.tensor(v) for k, v in out.items()}),
        torch.tensor(rnd, dtype=torch.int32), torch.tensor(lat),
        torch.tensor(mask))
    ref_np = jax_tree_to_numpy(ref)
    assert_trees_equal(ref_np, jax_tree_to_numpy(got))
    assert int(got.overwrites) > int(ch["overwrites"])   # collisions hit


@pytest.mark.parametrize("sent", [False, True], ids=["", "sent"])
@pytest.mark.parametrize("ring,uniform,topo,n", CASES)
def test_edge_read_matches_jax(ring, uniform, topo, n, sent):
    nb, rev, ch, _out, _lat, _mask, rnd = _random_inputs(ring * 17 + n, ring,
                                                         uniform, topo, n,
                                                         sent)
    jcfg, pcfg = _configs(ring, uniform, nb)
    ref_ch, ref_in = JS.edge_read(jcfg, _jax_channels(ch), jnp.asarray(nb),
                                  jnp.asarray(rev), jnp.int32(rnd))
    got_ch, got_in = PS.edge_read(pcfg, _torch_channels(ch),
                                  torch.tensor(nb), torch.tensor(rev),
                                  torch.tensor(rnd, dtype=torch.int32))
    for ref, got in ((ref_ch, got_ch), (ref_in, got_in)):
        ref_np = jax_tree_to_numpy(ref)
        assert_trees_equal(ref_np, jax_tree_to_numpy(got))
    if topo == "line":
        assert (nb < 0).any()


def test_spill_and_send_round_tracking_are_refused():
    """Nothing of the channels is refused any more: spill channels
    (refused until the fault slice) and send-round tracking (refused in
    slice 1) make the JAX package's zero planes."""
    for spill in (False, True):
        kw = dict(n_nodes=4, degree=2, lanes=2, spill=spill)
        for track in (False, True):
            ref = JS.make_channels(JS.EdgeConfig(**kw),
                                   track_send_round=track)
            got = PS.make_channels(PS.EdgeConfig(**kw), "cpu",
                                   track_send_round=track)
            assert_trees_equal(jax_tree_to_numpy(ref),
                               jax_tree_to_numpy(got))
            assert (got.sent is not None) == track


# (ring, channel lanes, out lanes, occupancy bound): cells are filled
# from lane 0 up, as the writer and edge_read keep them; a low bound
# leaves room, a full one makes the write overflow its cells
SPILL_CASES = [(6, 6, 3, 3), (12, 4, 3, 4), (5, 10, 5, 6)]


def _spill_inputs(seed, ring, Lc, Lo, occ_max, sent):
    rng = np.random.default_rng(seed)
    nb, _rev = _topology("grid", 9)
    n, D = nb.shape
    shape = (n, D, ring, Lc)
    occ = rng.integers(0, occ_max + 1, (n, D, ring, 1))
    ch = {"valid": np.arange(Lc)[None, None, None, :] < occ,
          **{f: rng.integers(-50, 50, shape, dtype=np.int32)
             for f in ("type", "a", "b", "c")},
          "overwrites": np.int32(3), "lat_clipped": np.int32(1)}
    if sent:
        ch["sent"] = rng.integers(0, 5000, shape, dtype=np.int32)
    oshape = (n, D, Lo)
    out = {"valid": rng.random(oshape) < 0.7,
           **{f: rng.integers(-1000, 1000, oshape, dtype=np.int32)
              for f in ("type", "a", "b", "c")}}
    # few distinct latencies: lanes of one edge collide on a cell
    lat = rng.integers(0, 4, oshape, dtype=np.int32)
    mask = rng.random((n, D, 1)) < 0.8
    lat[0, 0, 0] = ring + 3                     # a clipped draw
    out["valid"][0, 0, 0] = mask[0, 0, 0] = True
    return nb, ch, out, lat, mask, int(rng.integers(0, 50))


@pytest.mark.parametrize("sent", [False, True], ids=["", "sent"])
@pytest.mark.parametrize("ring,Lc,Lo,occ_max", SPILL_CASES)
def test_edge_write_spill_matches_jax(ring, Lc, Lo, occ_max, sent):
    nb, ch, out, lat, mask, rnd = _spill_inputs(ring * 7 + Lc, ring, Lc, Lo,
                                                occ_max, sent)
    n, D = nb.shape
    kw = dict(n_nodes=n, degree=D, lanes=Lc, ring=ring, spill=True)
    ref = JS.edge_write(
        JS.EdgeConfig(**kw), _jax_channels(ch),
        JS.EdgeMsgs(**{k: jnp.asarray(v) for k, v in out.items()}),
        jnp.int32(rnd), jnp.asarray(lat), jnp.asarray(mask))
    got = PS.edge_write(
        PS.EdgeConfig(**kw), _torch_channels(ch),
        PS.EdgeMsgs(**{k: torch.tensor(v) for k, v in out.items()}),
        torch.tensor(rnd, dtype=torch.int32), torch.tensor(lat),
        torch.tensor(mask))
    assert_trees_equal(jax_tree_to_numpy(ref), jax_tree_to_numpy(got))
    assert int(got.lat_clipped) > 1
    assert (int(got.overwrites) > 3) == (occ_max == Lc)


def test_reverse_index_matches_jax():
    for topo, n in (("grid", 10), ("line", 5), ("tree3", 13), ("total", 5)):
        nb, rev = _topology(topo, n)
        np.testing.assert_array_equal(PS.reverse_index(nb), rev)
