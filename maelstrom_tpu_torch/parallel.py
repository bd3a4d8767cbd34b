"""The cluster axis: many independent clusters advancing in lockstep.

Counterpart of the cluster-axis half of `maelstrom_tpu/parallel/__init__.py`
(`make_cluster_sims`, `make_cluster_round_fn` with `mesh=None`): the "10k
independent 5-node raft clusters" configuration of BASELINE.json. Where
the JAX package maps the round over clusters with `vmap`, here the cluster
axis is written out: every leaf of the state leads with F, the leaf
layout of JAX's vmapped state, and the round is `sim._round_edge` given
a `sim.ClusterAxis`: each device step of it is one launch for all F
clusters (no Python loop over clusters):

  - the round's key split: K7 over the [F, 2] keys;
  - the flight pool: `net/tpu.py` `_send` and `_deliver` over [F, P]
    pools (sorts along the last axis, prefix sums, scatters by row);
  - the edge exchange: K1 and K2 over the F * N node rows of the
    contiguous channels, with a global neighbour table (a cluster's own
    table plus cluster * N) and per-cluster counters;
  - the node step: K10 over the F * N node rows, with the local table;
  - the reply compaction: K4 with one segment a cluster.

Scope: the configurations the raft bench and the JAX package's golden
test run, constant latency 0 with the loss probability 0, one
component, no stall and no duplication, with client injections through
the per-cluster pools. There every fault draw of the round is value-free
(the loss roll `u < 0` is all False, constant latency draws nothing), so
the round skips them: the edge fault pass (K8) and the pool's loss roll.
The state's fault leaves are checked once each time the round sees new
ones (one host read), since the round passes them on unchanged. Any
other configuration raises, naming the fleet slice, which brings K8 over
per-cluster keys with the graded fleet's partitions."""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from . import prng
from .net import tpu as T
from .net.tpu import I32, Msgs, NetConfig
from .sim import ClusterAxis, SimState, _round_edge, make_sim
from .tree import resolve_device, tree_map

FLEET_SLICE = ("the graded raft fleet slice (K8 over per-cluster keys, "
               "partitions on the cluster axis)")


def make_cluster_sims(program, cfg: NetConfig, n_clusters: int,
                      seed: int = 0, device="cuda") -> SimState:
    """A batch of independent cluster simulations: every leaf gains a
    leading cluster axis; the keys are split from one root key (cluster
    i's key is the same at any cluster count)."""
    base = make_sim(program, cfg, seed=seed, device=device)
    F = int(n_clusters)

    def batch(t):
        return t.expand((F,) + tuple(t.shape)).contiguous()
    sims = tree_map(batch, base.replace(durable=None))
    return sims.replace(key=prng.split(base.key, F),
                        durable=program.durable_view(sims.nodes))


def _check_config(program, cfg: NetConfig, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "make_cluster_round_fn: a device mesh comes with the "
            "multi-GPU slice (torch.distributed)")
    T.check_scope(cfg)
    if cfg.enable_byz:
        # the JAX package's words (its fleet runner refuses the same)
        raise NotImplementedError(
            "--nemesis byzantine does not compose with --fleet yet: run "
            "the adversary on a standalone cluster (--fleet 1)")
    if not hasattr(program, "step_rows"):
        raise NotImplementedError(
            f"{program.name}: the cluster axis runs programs whose step "
            f"takes node rows (raft); others come with {FLEET_SLICE}")
    out = [(cfg.latency_dist != "constant", "randomized latency"),
           (cfg.latency_mean_rounds != 0, "nonzero latency"),
           (cfg.partition_groups > 1, "directional partitions"),
           (cfg.enable_stall, "kill and pause"),
           (cfg.enable_duplication, "duplication"),
           (bool(cfg.unit_words), "client-op unit counters")]
    for hit, what in out:
        if hit:
            raise NotImplementedError(
                f"the cluster axis runs constant latency 0 with no fault "
                f"draws; {what} comes with {FLEET_SLICE}")


class _ValueFree:
    """The state leaves whose values make the round's fault draws
    value-free, checked once for each new tensor: the loss probability
    (0), the component labels (one component a cluster), the latency
    scale (finite, so constant latency 0 stays 0) and the round (the
    same in every cluster: the exchange reads cluster 0's). The round
    passes the first three on unchanged and advances the round of every
    cluster by one, so a run checks them once."""

    def __init__(self, n_nodes: int):
        self.n = n_nodes
        self.seen = {}      # name -> (tensor, its version when checked)

    def check(self, net) -> None:
        cur = {"p_loss": net.p_loss, "component": net.component,
               "latency_scale": net.latency_scale, "round": net.round}
        if all(k in self.seen and self.seen[k][0] is t
               and self.seen[k][1] == t._version for k, t in cur.items()):
            return
        comp = net.component[:, :self.n]
        ok = ((net.p_loss == 0).all()
              & (comp == comp[:, :1]).all()
              & torch.isfinite(net.latency_scale).all()
              & (net.round == net.round[:1]).all())
        if not bool(ok):
            raise NotImplementedError(
                f"the cluster axis runs one component with the loss "
                f"probability 0 and one round in every cluster; loss, "
                f"partitions and per-cluster rounds come with "
                f"{FLEET_SLICE}")
        self.trust(cur)

    def trust(self, leaves: dict) -> None:
        self.seen.update({k: (t, t._version) for k, t in leaves.items()})


def global_neighbors(neighbors, n_clusters: int):
    """[F * N, D] neighbour rows of F clusters' nodes: cluster f's table
    plus f * N, missing edges kept at -1."""
    N = neighbors.shape[0]
    off = (torch.arange(n_clusters, dtype=I32, device=neighbors.device)
           * N)[:, None, None]
    nb = torch.where(neighbors >= 0, neighbors[None] + off, -1)
    return nb.reshape(n_clusters * N, -1).contiguous()


def make_cluster_round_fn(program, cfg: NetConfig, mesh=None,
                          example=None, example_inject=None,
                          device="cuda"):
    """round_fn(sims, inject [F, M]) -> (sims', client_msgs, io): one round
    of every cluster of a batch made by `make_cluster_sims` (`sim`'s
    round on the cluster axis, JAX's `vmap` of it). The mesh
    argument (JAX's sharded form) is refused: it comes with the multi-GPU
    slice."""
    dev = resolve_device(device)
    _check_config(program, cfg, mesh)
    if program.device != dev:
        raise ValueError(f"program built for {program.device}, round asked "
                         f"for {dev}")
    guard = _ValueFree(cfg.n_nodes)
    cache = {}

    def round_fn(sims: SimState, inject: Msgs):
        F = sims.key.shape[0]
        if F not in cache:
            cache.clear()
            cache[F] = ClusterAxis(
                F=F, ecfg=dataclasses.replace(program.edge_cfg,
                                              n_nodes=F * cfg.n_nodes),
                neighbors=global_neighbors(program.neighbors, F),
                rev=program.rev.repeat(F, 1))
        if sims.channels.sent is not None:
            raise NotImplementedError("the cluster axis tracks no send "
                                      "rounds (journaled runs)")
        guard.check(sims.net)
        out = _round_edge(program, cfg, sims, inject, cache[F])
        guard.trust({"round": out[0].net.round})
        return out
    return round_fn


# --- hashes of cluster states ------------------------------------------------

def cluster_digest(nodes: dict, key, stats: dict, channels: dict,
                   clusters: int) -> str:
    """sha256 of the first `clusters` clusters of a cluster-batched state,
    from numpy arrays (either package's, as `tree.to_numpy` or the tests'
    JAX conversion give them): every node leaf by sorted name, the
    uint32 keys, every `NetStats` counter by sorted name, then the edge
    channels' counters (`overwrites`, `lat_clipped`)."""
    h = hashlib.sha256()
    for k in sorted(nodes):
        h.update(k.encode())
        h.update(np.ascontiguousarray(np.asarray(nodes[k])[:clusters])
                 .tobytes())
    h.update(b"key")
    h.update(np.ascontiguousarray(np.asarray(key)[:clusters]
                                  .astype("<u4")).tobytes())
    for k in sorted(stats) + ["overwrites", "lat_clipped"]:
        v = stats[k] if k in stats else channels[k]
        h.update(k.encode())
        h.update(np.ascontiguousarray(np.asarray(v)[:clusters]
                                      .astype("<i4")).tobytes())
    return h.hexdigest()


def nodes_digest(nodes: dict) -> str:
    """sha256 of every node leaf by sorted name (the JAX package's
    `tests/test_raft_golden.py` hash)."""
    h = hashlib.sha256()
    for k in sorted(nodes):
        h.update(k.encode())
        h.update(np.ascontiguousarray(np.asarray(nodes[k])).tobytes())
    return h.hexdigest()


def injection_msgs(rows: dict, device) -> Msgs:
    """A cluster-batched injection Msgs [F, M] from numpy fields (absent
    fields empty)."""
    shape = np.asarray(rows["valid"]).shape
    m = Msgs.empty(shape, device)
    return m.replace(**{k: torch.as_tensor(np.asarray(v)).to(
        getattr(m, k).dtype).to(device) for k, v in rows.items()})
