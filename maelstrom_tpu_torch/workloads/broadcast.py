"""Broadcast workload (reference `src/maelstrom/workload/broadcast.clj`).

A copy of `maelstrom_tpu/workloads/broadcast.py` without the host-network
client and its RPC schemas (external node processes are not ported): the
topologies (grid/line/total/tree2/3/4, reference `broadcast.clj:39-177`)
as node-id maps, `topology_indices`, the dense neighbour array the edge
channels use, and `workload()`, the generator and checker of a test."""

from __future__ import annotations

import math

import numpy as np

from .. import generators as g
from ..checkers.set_full import BroadcastChecker


def grid_topology(nodes):
    """Roughly-square grid; each node has at most 4 neighbors
    (reference `broadcast.clj:39-64`)."""
    nodes = list(nodes)
    n = len(nodes)
    side = math.ceil(math.sqrt(n))

    def node(i, j):
        if 0 <= i and 0 <= j < side:
            idx = i * side + j
            if idx < n:
                return nodes[idx]
        return None

    topo = {}
    for i in range(side):
        for j in range(side):
            me = node(i, j)
            if me is None:
                continue
            topo[me] = [x for x in (node(i + 1, j), node(i - 1, j),
                                    node(i, j + 1), node(i, j - 1))
                        if x is not None]
    return topo


def line_topology(nodes):
    """All nodes in a single line (reference `broadcast.clj:66-79`)."""
    nodes = list(nodes)
    n = len(nodes)
    if n < 2:
        return {nodes[0]: []} if nodes else {}
    topo = {nodes[0]: [nodes[1]], nodes[-1]: [nodes[-2]]}
    for i in range(1, n - 1):
        topo[nodes[i]] = [nodes[i - 1], nodes[i + 1]]
    return topo


def total_topology(nodes):
    """Every node connected to every other (reference
    `broadcast.clj:81-88`)."""
    nodes = list(nodes)
    return {me: [x for x in nodes if x != me] for me in nodes}


def tree_topology(b, nodes):
    """A b-ary tree laid out breadth-first; neighbors = parent + children
    (reference `broadcast.clj:90-166`)."""
    nodes = list(nodes)
    n = len(nodes)
    if n == 0:
        return {}
    topo = {me: [] for me in nodes}
    for i, me in enumerate(nodes):
        if i > 0:
            parent = nodes[(i - 1) // b]
            topo[me].append(parent)
        for c in range(b * i + 1, min(b * i + b + 1, n)):
            topo[me].append(nodes[c])
    return topo


TOPOLOGIES = {
    "line": line_topology,
    "grid": grid_topology,
    "tree": lambda ns: tree_topology(2, ns),
    "tree2": lambda ns: tree_topology(2, ns),
    "tree3": lambda ns: tree_topology(3, ns),
    "tree4": lambda ns: tree_topology(4, ns),
    "total": total_topology,
}


def topology_indices(topo: dict, nodes: list[str], max_degree=None):
    """Dense [n, max_degree] neighbor index array (padded with -1) for the
    TPU path."""
    idx = {n: i for i, n in enumerate(nodes)}
    deg = max((len(v) for v in topo.values()), default=0)
    if max_degree is not None:
        deg = max(deg, max_degree)
    out = np.full((len(nodes), max(deg, 1)), -1, dtype=np.int32)
    for n, neighbors in topo.items():
        for j, m in enumerate(neighbors):
            out[idx[n], j] = idx[m]
    return out


def workload(opts: dict) -> dict:
    return {
        "generator": g.mix([
            g.Counting("broadcast"),
            g.Repeat({"f": "read"})]),
        "final_generator": g.each_thread({"f": "read", "final": True}),
        "checker": BroadcastChecker(),
    }
