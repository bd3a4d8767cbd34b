"""Node programs of the port.

Counterpart of `maelstrom_tpu/nodes/__init__.py`: a node program is a
batched state machine whose per-node state is a dict of tensors with a
leading node axis, plus the host-boundary contract that keeps the JSON
protocol as the compatibility surface (`request_for_op`, `encode_body`,
`decode_body`, `completion`). The port has the broadcast, batched
broadcast, g-set, PN-/g-counter and kafka programs on the edge channels,
Raft serving lin-kv and the transaction programs (txn-list-append,
txn-rw-register), echo and unique-ids on the pool path, the
ordering axis's composed programs (`tpu:ordered`, `ordering/`), the
in-cluster services (`tpu:services`, a role partition), compartmentalized
consensus with a stable leader (`tpu:compartment`, a four-role partition)
and any of them
wrapped as a one-role partition (`tpu:solo:<program>`); `get_program`
names the slice that brings any other.

Type code 0 is reserved (invalid slot), 1 is the shared RPC error reply;
programs define their own codes from 10 up."""

from __future__ import annotations

import json
import math
from typing import Any, Callable

import torch

from ..net.tpu import I32

T_INVALID = 0
T_ERROR = 1     # error reply: a = error code, b = interned text

HOST = "host"   # sentinel: op handled host-side, no message injected


class EncodeCapacityError(ValueError):
    """A static encode capacity (value table, command table) is
    exhausted; the runner completes the op as a definite fail."""


class Intern:
    """Bidirectional value <-> int32 table for opaque payloads crossing the
    host/device boundary."""

    def __init__(self):
        self._fwd: dict[str, int] = {}
        self._rev: list[Any] = []

    def id(self, value) -> int:
        key = json.dumps(value, sort_keys=True, default=str)
        i = self._fwd.get(key)
        if i is None:
            i = len(self._rev)
            self._fwd[key] = i
            self._rev.append(value)
        return i

    def peek(self, value):
        """Existing id for a value, or None, without growing the table."""
        return self._fwd.get(json.dumps(value, sort_keys=True, default=str))

    def __len__(self):
        return len(self._rev)

    def value(self, i: int):
        return self._rev[i]


class NodeProgram:
    """Base class for the port's batched node programs."""

    name = "abstract"
    inbox_cap = 8
    outbox_cap = 8
    needs_state_reads = False
    # True when every inbox lane is decoded by message type, never by
    # position (a prerequisite of the spill write)
    edge_lanes_symmetric = False
    # True when a round's lanes on an edge are one logical message: the
    # loss and latency draws are then shared across the lanes
    edge_atomic_rpc = False
    reply_payload_words = 0
    durable_keys: tuple | None = None
    # quiet_planes(state) -> the bool planes any set byte of which means
    # the program is busy (the runner's quiescence probe); None for a
    # program that is never quiescent, which the runner then never probes
    quiet_planes = None

    def __init__(self, opts: dict, nodes: list[str]):
        self.opts = opts
        self.nodes = nodes
        self.n_nodes = len(nodes)

    def init_state(self):
        """Per-node state dict, leading axis n_nodes."""
        raise NotImplementedError

    def request_for_op(self, op: dict):
        """Generator op -> protocol body dict, or HOST."""
        raise NotImplementedError

    def node_for_op(self, op: dict):
        return None

    def encode_body(self, body: dict, intern: Intern):
        """Protocol body -> (type, a, b, c) words."""
        raise NotImplementedError

    def decode_body(self, t: int, a: int, b: int, c: int, intern: Intern):
        """Words -> protocol body dict."""
        if t == T_ERROR:
            return {"type": "error", "code": int(a),
                    "text": intern.value(b) if 0 <= b < len(intern._rev)
                    else ""}
        raise ValueError(f"{self.name}: unknown reply type code {t}")

    def completion(self, op: dict, body: dict,
                   read_state: Callable[[], Any], intern: Intern) -> dict:
        return {**op, "type": "ok"}

    def reply_payload(self, state, node_idx):
        raise NotImplementedError

    def completion_payload(self, op: dict, body: dict, payload,
                           intern: Intern) -> dict:
        raise NotImplementedError

    def host_op(self, op: dict, read_state: Callable[[], Any],
                intern: Intern) -> dict:
        """Completes a HOST-routed op from device state."""
        raise NotImplementedError

    def invalid_counters(self, state) -> dict:
        """Program-state counters that invalidate the run when nonzero
        ({name: int tensor}, summed), reported by the net-stats checker
        beside `dropped-overflow`."""
        return {}

    def state_row(self, tree, node_idx: int):
        """One node's state rows, copied out of a host copy of the state
        tree (`runner._read_state`): every leaf indexed by the node."""
        import numpy as np
        return {k: np.array(v[node_idx]) for k, v in tree.items()}

    def host_state(self):
        """The host-side bookkeeping this program keeps between ops
        (kafka: consumer-group sessions and polled offsets), or None."""
        return None

    def set_host_state(self, st):
        """Restores what `host_state` returned (nothing for None)."""

    def durable_view(self, state):
        """The persisted subset of `state` (the same tensors, no copy);
        None when all of it is."""
        if self.durable_keys is None:
            return None
        return {k: state[k] for k in self.durable_keys}

    def restore(self, fresh, durable, state, mask):
        """Crash-restart: nodes where the [N] bool `mask` is set come back
        with their volatile state rebuilt from `fresh` (an init_state()
        dict) overlaid with their `durable` entries; the others keep
        `state`. A fully durable program keeps all of it. On the cluster
        axis `mask` is [F, N] over F-led `state` and `durable` (the
        fleet's restart of one cluster's nodes): a False row keeps its
        cluster as it is."""
        if self.durable_keys is None:
            return state
        recovered = {**fresh, **durable}

        def pick(k):
            o, r = state[k], recovered[k]
            m = mask.reshape(mask.shape + (1,) * (o.dim() - mask.dim()))
            return torch.where(m, r, o)
        return {k: pick(k) for k in state}


def edge_timing(opts: dict, n_nodes: int) -> tuple[int, int, int]:
    """Edge-channel sizing: (ring, retry_rounds, lat_rounds), as the JAX
    package computes it."""
    lat = (opts.get("latency") or {}).get("mean", 0)
    ms_per_round = opts.get("ms_per_round", 1.0)
    lat_rounds = int(math.ceil(lat / ms_per_round))
    dist = (opts.get("latency") or {}).get("dist", "constant")
    slack = 1 if dist == "constant" else 8
    scale_headroom = int(opts.get("max_latency_scale",
                                  10 if n_nodes <= 4096 else 1))
    ring = max(2, lat_rounds * slack * scale_headroom + 2)
    nm = opts.get("nemesis")
    if isinstance(nm, (set, frozenset, list, tuple)) and "duplicate" in nm:
        ring += 2
    retry_rounds = max(2 * (lat_rounds + 1) + 4, 10)
    return ring, retry_rounds, lat_rounds


def edge_capacity(opts: dict, program) -> tuple[bool, int, bool]:
    """Spill decision and lane sizing of a program's EdgeConfig:
    (spill, channel_lanes, uniform_arrival)."""
    from ..net.static import LANE_STRIDE
    n = program.n_nodes
    lanes = program.lanes
    if lanes > LANE_STRIDE:
        raise ValueError(
            f"{program.name}: {lanes} edge lanes exceed LANE_STRIDE")
    dist = (opts.get("latency") or {}).get("dist", "constant")
    tolerates = getattr(program, "tolerates_channel_overwrites", False)
    if dist != "constant" and not tolerates \
            and not program.edge_lanes_symmetric:
        raise ValueError(
            f"{program.name}: randomized latency with no retransmission "
            f"requires spill-mode channels, which need type-dispatched "
            f"(symmetric) inbox lanes")
    spill = (program.edge_lanes_symmetric and dist != "constant"
             and (n <= 4096 or not tolerates))
    if spill and n <= 4096:
        lanes = min(2 * lanes, LANE_STRIDE)
    return spill, lanes, dist == "constant"


def wire_name_table(program_module) -> dict[int, str]:
    """Wire-code -> name table for the send-count-by-type netstats
    breakdown (the JAX package's `wire_name_table`): a module's
    ``WIRE_NAMES`` dict pins names outright, otherwise they derive from
    its ``T_*`` int constants; aliased codes resolve to the
    alphabetically-first name, and the program's names shadow the shared
    reply vocabulary (``T_ERROR`` etc.) defined here."""
    import sys
    names: dict[int, str] = {}
    shared = sys.modules[__name__]
    for source in (program_module, shared):
        if source is None:
            continue
        for code, name in (getattr(source, "WIRE_NAMES", None)
                           or {}).items():
            names.setdefault(int(code), str(name))
        for k in sorted(vars(source)):
            v = vars(source)[k]
            if k.startswith("T_") and isinstance(v, int):
                names.setdefault(v, k[2:].lower())
    return names


# --- the pool-path steps (K11, K12) -----------------------------------------

_MSG_FIELDS = ("valid", "src", "dest", "due", "mid", "reply_to", "type",
               "a", "b", "c")


def freeze_step(stall, state, new, *outs):
    """The round's freeze (the JAX package's `sim.py:94-112, 429-434`)
    on a plain step's result: nodes (rows) where the [N] bool `stall` is
    set keep their `state` row and send nothing on any of `outs`, the
    node-led outboxes ([N, K] client rows, [N, D, L] edge lanes).
    Returns (state', *outs'); `stall` None changes nothing."""
    if stall is None:
        return (new, *outs)
    from ..sim import _freeze
    return (_freeze(stall, state, new),
            *(o.replace(valid=o.valid & ~stall.reshape(
                stall.shape + (1,) * (o.valid.dim() - 1))) for o in outs))


def launch_pool_step(kernel, inbox, counter, stall, t_req: int,
                     t_reply: int, mint: bool = False):
    """Launches K11 (echo) or, with `mint`, K12 (unique-ids) of
    `csrc/pool.cu` on an [N, K] inbox and the program's [N] int32
    counter, with the optional [N] bool stall mask. The outbox's
    passed-through fields are the inbox's own tensors, as in the plain
    versions (dest = src, reply_to = mid); the kernel writes valid, type
    (and with `mint` a and b). Returns (counter', outbox)."""
    N, Kc = inbox.valid.shape
    dev = inbox.valid.device
    for f in _MSG_FIELDS:
        t = getattr(inbox, f)
        if tuple(t.shape) != (N, Kc) or t.dtype != (
                torch.bool if f == "valid" else I32):
            raise ValueError(f"{kernel.name} inbox.{f}: "
                             f"{tuple(t.shape)} {t.dtype}")
    if tuple(counter.shape) != (N,) or counter.dtype != I32:
        raise ValueError(f"{kernel.name} counter: {tuple(counter.shape)} "
                         f"{counter.dtype}")
    if stall is not None and (tuple(stall.shape) != (N,)
                              or stall.dtype != torch.bool):
        raise ValueError(f"{kernel.name} stall: {tuple(stall.shape)} "
                         f"{stall.dtype}")

    def new(dtype=I32):
        return torch.empty((N, Kc), dtype=dtype, device=dev)
    out = inbox.replace(valid=new(torch.bool), dest=inbox.src,
                        reply_to=inbox.mid, type=new())
    if mint:
        out = out.replace(a=new(), b=new())
    counter2 = torch.empty_like(counter)
    kernel.launch(
        [inbox.valid.contiguous(), inbox.type.contiguous(),
         counter.contiguous(),
         None if stall is None else stall.contiguous(), out.valid,
         out.type, out.a if mint else None, out.b if mint else None,
         counter2], [N, Kc, t_req, t_reply], dev)
    return counter2, out


PROGRAMS: dict[str, Callable] = {}


def register(cls):
    PROGRAMS[cls.name] = cls
    return cls


def get_program(name: str, opts: dict, nodes: list[str],
                device="cuda") -> NodeProgram:
    from . import (broadcast, broadcast_batched,  # noqa: F401
                   compartment, echo, gset, kafka,  # noqa: F401
                   pn_counter, raft, services,  # noqa: F401
                   txn_list_append, txn_rw_register,  # noqa: F401
                   unique_ids)  # (register the programs)
    if name == "ordered":
        # the ordering axis: the engine named by opts["ordering"] composed
        # with the applier serving opts["workload"]
        from ..ordering import make_ordered
        return make_ordered(opts, nodes, device=device)
    if name.startswith("solo:"):
        # any program wrapped as a one-role partition: pure delegation,
        # the inner program's history bit for bit
        from ..sim import RolePartition
        inner = get_program(name[len("solo:"):], opts, nodes, device=device)
        return RolePartition(opts, nodes, [("r0", inner)])
    if name not in PROGRAMS:
        raise ValueError(f"node program {name!r} is not ported to "
                         f"maelstrom_tpu_torch yet (comes with a later "
                         f"slice); "
                         f"have {sorted(PROGRAMS)}")
    return PROGRAMS[name](opts, nodes, device=device)


def partition_node_count(name: str, opts: dict) -> int | None:
    """The node count a role-partitioned family derives from its role
    spec (`core.parse_nodes`, when neither --node-count nor --nodes is
    given); None for the programs whose count the user picks."""
    if name == "services":
        from .services import roles_node_count
        return roles_node_count(opts.get("service_roles"))
    if name == "compartment":
        from .compartment import roles_node_count
        return roles_node_count(opts.get("roles"))
    if name == "ordered":
        from ..ordering import ordered_node_count
        return ordered_node_count(opts)
    return None
