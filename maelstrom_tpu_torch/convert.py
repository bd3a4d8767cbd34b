"""State carried between the JAX package and the port.

Both packages name their state by the same dataclass fields, so a state
travels as nested dicts of numpy arrays keyed by field name
(`net.pool.valid`, `nodes.seen`, `channels.a`, the threefry `key`, the
fault masks and scalars `net.down`, `net.block_matrix`, `net.p_loss`, ...,
`channels.overwrites`, a program's node leaves such as kafka's `log` and
group mode's bool `gactive` [N, G, M]; on the cluster axis every leaf
leads with the cluster, as under JAX's `vmap`). Each leaf takes the dtype
of the port's own fresh state. The tests build such a dict from a JAX
`SimState`; these functions turn it into the port's `SimState` and
back, so that both packages can start from one state and be compared
leaf for leaf."""

from __future__ import annotations

import numpy as np

from .net.tpu import Msgs
from .sim import SimState, make_sim
from .tree import from_numpy, resolve_device, to_numpy


def state_from_numpy(tree: dict, program, cfg, device="cuda") -> SimState:
    """The port's SimState holding the arrays of `tree` (every leaf must
    match the shape of the port's own fresh state; channels carrying a
    `sent` plane give a state that tracks it)."""
    dev = resolve_device(device)
    track = (tree.get("channels") or {}).get("sent") is not None
    template = make_sim(program, cfg, device=dev,
                        track_edge_send_round=track)
    return from_numpy(template, tree, dev)


def cluster_state_from_numpy(tree: dict, program, cfg, device="cuda"
                             ) -> SimState:
    """The port's cluster-batched SimState (`parallel.make_cluster_sims`:
    every leaf led by the cluster axis, JAX's layout under `vmap`)
    holding the arrays of `tree`."""
    from .parallel import make_cluster_sims
    dev = resolve_device(device)
    F = np.asarray(tree["key"]).shape[0]
    template = make_cluster_sims(program, cfg, F, device=dev)
    sims = from_numpy(template.replace(durable=None),
                      {**tree, "durable": None}, dev)
    return sims.replace(durable=program.durable_view(sims.nodes))


def state_to_numpy(sim: SimState) -> dict:
    return to_numpy(sim)


def msgs_from_numpy(tree: dict, device="cuda") -> Msgs:
    """A Msgs batch (an injection plan, an inbox) from a dict of numpy
    arrays with one common shape."""
    dev = resolve_device(device)
    shape = np.asarray(tree["valid"]).shape
    return from_numpy(Msgs.empty(shape, dev), tree, dev)
