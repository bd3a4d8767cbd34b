"""The cluster axis: many independent clusters advancing in lockstep.

Counterpart of the cluster-axis half of `maelstrom_tpu/parallel/__init__.py`
(`make_cluster_sims`, `make_fleet_sims`, `make_cluster_round_fn` with
`mesh=None`): the "10k independent 5-node raft clusters" configuration of
BASELINE.json and the fleet's batched tree (`runner/fleet_runner.py`).
Where the JAX package maps the round over clusters with `vmap`, here the
cluster axis is written out: every leaf of the state leads with F, the
leaf layout of JAX's vmapped state, and the round is `sim._round_edge`
given a `sim.ClusterAxis`: each device step of it is one launch for all
F clusters (no Python loop over clusters):

  - the round's key split: K7 over the [F, 2] keys, and every draw of
    the round (the pool's loss roll and latency, the edge faults') from
    each cluster's own keys;
  - the flight pool: `net/tpu.py` `_send` and `_deliver` over [F, P]
    pools (sorts along the last axis, prefix sums, scatters by row);
  - the edge exchange: K1 and K2 (K9 for spill channels) over the F * N
    node rows of the contiguous channels, with a global neighbour table
    (a cluster's own table plus cluster * N), per-cluster counters and
    each row reading its own cluster's round;
  - the edge faults: K8 over [F, N, D, L] with each cluster's component
    labels, directional block matrix, down and paused masks (in local
    node ids), loss and duplication probabilities and latency scale;
  - the node step: K10 (raft) or K3 (broadcast) over the F * N node
    rows, with the local table and the [F * N] stall mask;
  - the reply compaction: K4 with one segment a cluster.

Clusters may sit at different rounds (a fleet holds finished lanes and
bumps quiescent ones one by one) and run under faults of their own: the
state's fault leaves are F-led and the nemesis rewrites one cluster's
row (`runner/fleet_runner.FleetRunner.apply_net_row`).

Scope: programs with a row step (`step_rows`: raft and broadcast). A
device mesh, the byzantine adversary, client-op unit counters
(broadcast-batched), telemetry rings and journaled channels are
refused, each naming the slice that brings it."""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from . import prng
from .net import tpu as T
from .net.tpu import I32, Msgs, NetConfig
from .sim import (FLEET_STREAM_SLICE, ClusterAxis, SimState, _round_edge,
                  make_sim)
from .tree import resolve_device, tree_map

MULTI_GPU_SLICE = "the multi-GPU slice (torch.distributed)"
FLEET_PROGRAMS_SLICE = ("the fleets of kafka, the pool-path programs, the "
                        "role partitions and the batched broadcast")


def _batched(program, base: SimState, F: int) -> SimState:
    def batch(t):
        return t.expand((F,) + tuple(t.shape)).contiguous()
    sims = tree_map(batch, base.replace(durable=None))
    return sims.replace(durable=program.durable_view(sims.nodes))


def make_cluster_sims(program, cfg: NetConfig, n_clusters: int,
                      seed: int = 0, device="cuda") -> SimState:
    """A batch of independent cluster simulations: every leaf gains a
    leading cluster axis; the keys are split from one root key (cluster
    i's key is the same at any cluster count)."""
    base = make_sim(program, cfg, seed=seed, device=device)
    sims = _batched(program, base, int(n_clusters))
    return sims.replace(key=prng.split(base.key, int(n_clusters)))


def seed_keys(seeds, device) -> torch.Tensor:
    """uint32 [F, 2]: `prng.PRNGKey(seeds[i])` a row, made on the host and
    copied once."""
    return torch.stack([prng.PRNGKey(s, "cpu") for s in seeds]).to(device)


def make_fleet_sims(program, cfg: NetConfig, seeds,
                    device="cuda") -> SimState:
    """A cluster-batched state whose row i equals `make_sim(program, cfg,
    seed=seeds[i])` leaf for leaf: the initial tree is seed-independent,
    so rows copy one base, and row i's key is `PRNGKey(seeds[i])`, not a
    split of one root key (the fleet's contract: every cluster replays
    its standalone run)."""
    dev = resolve_device(device)
    base = make_sim(program, cfg, seed=0, device=dev)
    return _batched(program, base, len(seeds)).replace(
        key=seed_keys(seeds, dev))


def check_config(program, cfg: NetConfig, mesh=None) -> None:
    """Refuses what the cluster axis does not run, naming the slice that
    brings it (the byzantine adversary in the JAX package's words)."""
    if mesh is not None:
        raise NotImplementedError(
            f"make_cluster_round_fn: a device mesh comes with "
            f"{MULTI_GPU_SLICE}")
    if cfg.enable_byz:
        # the JAX package's words (its fleet runner refuses the same)
        raise NotImplementedError(
            "--nemesis byzantine does not compose with --fleet yet: run "
            "the adversary on a standalone cluster (--fleet 1)")
    if not hasattr(program, "step_rows"):
        raise NotImplementedError(
            f"{program.name}: the cluster axis runs a program with a row "
            f"step (raft, broadcast); others come with "
            f"{FLEET_PROGRAMS_SLICE}")
    if cfg.unit_words:
        raise NotImplementedError(
            f"client-op unit counters on the cluster axis come with "
            f"{FLEET_PROGRAMS_SLICE}")
    if cfg.telemetry:
        raise NotImplementedError(
            f"telemetry on the cluster axis comes with {FLEET_STREAM_SLICE}")


def global_neighbors(neighbors, n_clusters: int):
    """[F * N, D] neighbour rows of F clusters' nodes: cluster f's table
    plus f * N, missing edges kept at -1."""
    N = neighbors.shape[0]
    off = (torch.arange(n_clusters, dtype=I32, device=neighbors.device)
           * N)[:, None, None]
    nb = torch.where(neighbors >= 0, neighbors[None] + off, -1)
    return nb.reshape(n_clusters * N, -1).contiguous()


def cluster_axis(program, F: int) -> ClusterAxis:
    """The cluster axis of F clusters of `program`: the edge config of
    F * N node rows and the global neighbour and reverse-slot tables."""
    return ClusterAxis(
        F=F, ecfg=dataclasses.replace(program.edge_cfg,
                                      n_nodes=F * program.n_nodes),
        neighbors=global_neighbors(program.neighbors, F),
        rev=program.rev.repeat(F, 1))


def value_free_test(cfg: NetConfig):
    """net -> whether no fault draw of a cluster-axis round can change a
    value: constant latency 0 with one partition group and no stall or
    duplication (the config), and the loss probability 0, one component
    a cluster and a finite latency scale (the state). Those three leaves
    are read on the host once for each new tensor or version: a round
    passes them on unchanged and the nemesis writes fresh copies, so a
    run reads them once, and again after each surgery."""
    if (cfg.latency_dist != "constant" or cfg.latency_mean_rounds != 0
            or cfg.partition_groups > 1 or cfg.enable_stall
            or cfg.enable_duplication):
        return lambda net: False
    memo = {"seen": (), "free": False}

    def value_free(net) -> bool:
        seen = tuple((t, t._version) for t in (net.p_loss, net.component,
                                               net.latency_scale))
        if len(memo["seen"]) != len(seen) or any(
                a is not b or va != vb
                for (a, va), (b, vb) in zip(memo["seen"], seen)):
            comp = net.component[:, :cfg.n_nodes]
            memo["free"] = bool((net.p_loss == 0).all()
                                & (comp == comp[:, :1]).all()
                                & torch.isfinite(net.latency_scale).all())
            memo["seen"] = seen
        return memo["free"]
    return value_free


def make_cluster_round_fn(program, cfg: NetConfig, mesh=None,
                          example=None, example_inject=None,
                          device="cuda"):
    """round_fn(sims, inject [F, M]) -> (sims', client_msgs, io): one round
    of every cluster of a batch made by `make_cluster_sims` or
    `make_fleet_sims` (`sim`'s round on the cluster axis, JAX's `vmap`
    of it). Where no fault draw can change a value (`value_free_test`)
    the round skips the loss roll and K8. The mesh argument (JAX's
    sharded form) is refused: it comes with the multi-GPU slice."""
    dev = resolve_device(device)
    check_config(program, cfg, mesh)
    T.check_scope(cfg)
    if program.device != dev:
        raise ValueError(f"program built for {program.device}, round asked "
                         f"for {dev}")
    cache = {}
    value_free = value_free_test(cfg)

    def round_fn(sims: SimState, inject: Msgs):
        F = sims.key.shape[0]
        if F not in cache:
            cache.clear()
            cache[F] = cluster_axis(program, F)
        if sims.channels.sent is not None:
            raise NotImplementedError("the cluster axis tracks no send "
                                      "rounds (journaled runs)")
        return _round_edge(program, cfg, sims, inject, cache[F],
                           value_free(sims.net))
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
