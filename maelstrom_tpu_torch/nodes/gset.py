"""Batched grow-only set node (the workload of `workloads/g_set.py`): the
broadcast gossip machine with the g-set RPC surface.

Counterpart of `maelstrom_tpu/nodes/gset.py`, held against it by
`tests/test_torch_crdt.py`. A g-set is broadcast state, a monotone set
replicated by gossip, so this is the port's `BroadcastProgram` (its step
is kernel K3) with other RPCs at the boundary: `add`/`add_ok` and
`read`/`read_ok`. The gossip graph is fully connected unless the test
names a topology, or, with `gossip_fanout`, a fixed random graph of
about that many links a node (`fanout_topology`, drawn with Python's
`random.Random(seed)` exactly as the JAX package draws it)."""

from __future__ import annotations

import random

from .broadcast import (BroadcastProgram, T_BCAST, T_BCAST_OK, T_READ,
                        T_READ_OK)
from . import EncodeCapacityError, NodeProgram, register


def fanout_topology(nodes, k: int, seed: int = 0):
    """A fixed random symmetric graph with ~k links per node (degree in
    [k, 2k] after symmetrization); connected via a Hamiltonian backbone."""
    rng = random.Random(seed)
    n = len(nodes)
    k = min(k, n - 1)           # a node has at most n-1 distinct neighbors
    order = list(range(n))
    rng.shuffle(order)
    adj = {i: set() for i in range(n)}
    for i in range(n):                       # ring backbone: connectivity
        a, b = order[i], order[(i + 1) % n]
        if a != b:
            adj[a].add(b)
            adj[b].add(a)
    for i in range(n):
        while len(adj[i]) < k and n > 1:
            j = rng.randrange(n)
            if j != i:
                adj[i].add(j)
                adj[j].add(i)
    return {nodes[i]: [nodes[j] for j in sorted(adj[i])] for i in range(n)}


def gossip_topology_opts(opts: dict, nodes) -> dict:
    """The CRDT programs' gossip graph: an explicit `gossip_fanout`
    builds a fixed random graph; otherwise gossip with all peers unless a
    topology is named."""
    opts = dict(opts)
    fan = opts.get("gossip_fanout")
    if fan:
        opts["topology_map"] = fanout_topology(nodes, int(fan),
                                               opts.get("seed", 0))
    else:
        opts.setdefault("topology", "total")
    return opts


@register
class GSetProgram(BroadcastProgram):
    name = "g-set"

    def __init__(self, opts, nodes, device="cuda"):
        super().__init__(gossip_topology_opts(opts, nodes), nodes,
                         device=device)

    # --- host boundary (the RPC surface of workload/g_set.clj) ---

    def request_for_op(self, op):
        if op["f"] == "add":
            return {"type": "add", "element": op["value"]}
        return {"type": "read"}

    def encode_body(self, body, intern):
        if body["type"] == "add":
            i = intern.peek(body["element"])
            if i is None:
                if len(intern) >= self.V:
                    # checked before interning: a survivable failure must
                    # not grow the table
                    raise EncodeCapacityError(
                        f"g-set value table full ({self.V}); "
                        f"raise --max-values")
                i = intern.id(body["element"])
            return (T_BCAST, i, 0, 0)
        return (T_READ, 0, 0, 0)

    def decode_body(self, t, a, b, c, intern):
        if t == T_BCAST_OK:
            return {"type": "add_ok"}
        if t == T_READ_OK:
            return {"type": "read_ok"}
        return NodeProgram.decode_body(self, t, a, b, c, intern)
