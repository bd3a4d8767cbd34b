"""Simulation composition: network + node program = one round.

Counterpart of `maelstrom_tpu/sim.py`. Edge programs (`is_edge`) run the
edge-channel round:

    inject client msgs -> deliver due msgs -> read edges -> step all nodes
    -> compact client replies -> write edges

and every other program the pool-path round, the classic Maelstrom
model, in which node replies travel through the flight pool:

    inject client msgs -> deliver due msgs -> step all nodes -> send the
    flattened outboxes

`make_round_fn` gives that round for interactive use; `make_run_fn` loops
it over a pre-scheduled injection plan on the device, with no host sync
inside the loop: the benchmark path. `make_scan_fn` is the runner's
scan-ahead: rounds until an exit condition holds, with every client
reply appended to a device-resident log (kernel K5, `csrc/scan.cu`); its
continuous form injects each scheduled row at its own round of the
window (kernel K18, `csrc/stream.cu`). With `NetConfig.telemetry` every
round ends with the flight recorder's fold (kernel K19, `telemetry.py`).

A round consumes the `SimState` it is given: the edge channels are
updated in place (see `net/static.py`). Keep only the returned state.

`SimState.key` is the threefry key (`prng`), split every round as the JAX
package splits it, whatever the config draws; the fault masks and draws
of the edge sends are kernel K8 (`csrc/faults.cu`)."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import byzantine as BZ
from . import kernels as K
from . import prng
from . import telemetry as TM
from .net import static
from .net import tpu as T
from .net.tpu import I32, INT32_MAX, Msgs, NetConfig, NetState
from .nodes import NodeProgram
from .tree import Struct, leaves, resolve_device, tree_map

FLEET_STREAM_SLICE = ("the continuous fleet slice (--fleet --continuous, "
                      "telemetry rings on the cluster axis)")


@dataclass
class SimState(Struct):
    net: NetState
    nodes: object             # program state dict, leading axis N
    key: torch.Tensor         # uint32[2] threefry key
    channels: object = None   # EdgeChannels
    durable: object = None    # persisted subset of node state, or None
    telemetry: object = None  # telemetry.MetricRing, or None
    byz: object = None        # the adversary slice


def _check_program(program, cfg: NetConfig, device) -> None:
    if program.device != device:
        raise ValueError(f"program built for {program.device}, simulation "
                         f"asked for {device}")
    if program.n_nodes != cfg.n_nodes:
        raise ValueError(f"program has {program.n_nodes} nodes, NetConfig "
                         f"{cfg.n_nodes}")


def make_sim(program, cfg: NetConfig, seed: int = 0, device="cuda",
             track_edge_send_round: bool = False) -> SimState:
    dev = resolve_device(device)
    T.check_scope(cfg)
    _check_program(program, cfg, dev)
    channels = (static.make_channels(
        program.edge_cfg, dev, track_send_round=track_edge_send_round)
        if getattr(program, "is_edge", False) else None)
    nodes = program.init_state()
    key = prng.PRNGKey(seed, dev)
    tel = TM.make_ring(cfg, dev) if cfg.telemetry else None
    # the adversary's carry only where the fault set holds byzantine: a
    # benign carry is shaped as before
    byz = BZ.init_state(dev) if cfg.enable_byz else None
    return SimState(net=T.make_net(cfg, dev), nodes=nodes, key=key,
                    channels=channels, durable=program.durable_view(nodes),
                    telemetry=tel, byz=byz)


def _freeze(stall, old, new):
    """Per-leaf select: stalled (killed or paused) nodes keep their old
    row, live nodes take the stepped one. Leaves lead with the node
    axis."""
    def pick(n, o):
        m = stall.reshape(stall.shape + (1,) * (n.dim() - 1))
        return torch.where(m, o, n)
    return tree_map(pick, new, old)     # in the stepped tree's key order


# --- role-partitioned programs ---------------------------------------------

class _RoleCtx(dict):
    """A role's round ctx: the round's, with the role's key
    `fold_in(key, role)` derived when the step first reads it (a role
    that draws nothing costs no threefry launch, as JAX's compiler drops
    an unused fold_in)."""

    round_key = None
    role = 0

    def __missing__(self, name):
        if name != "key":
            raise KeyError(name)
        self["key"] = prng.fold_in(self.round_key, self.role)
        return self["key"]


class RolePartition(NodeProgram):
    """A multi-program node-state tree (the JAX package's
    `RolePartition`, `sim.py:115-409`): contiguous node-id ranges run
    distinct node programs inside the one round.

    `step` slices the global [N, K] inbox per role, steps each role's
    program on its own state subtree (`{role: subtree}`, leaves leading
    with the role's node count), pads each role's outbox to the
    partition's `outbox_cap` and concatenates them on the node axis.
    Where the JAX package freezes killed and paused nodes after the step
    (`freeze_select`), the port's steps freeze inside (`ctx["stall"]`),
    so each role gets its slice of the stall mask. A single-role
    partition passes the round's ctx through unchanged (the bit-identity
    contract: same key, same shapes, the inner program's history); a
    multi-role one gives role i the key `fold_in(key, i)`.

    Durable views, restore and `state_row` go per role; the host
    boundary (request, encode, decode, completion, routing) delegates to
    the client role, the first; `fault_groups` names each role's node
    range for `--nemesis-targets`. Edge programs (raft, broadcast) are
    legal only as the sole role, where the partition is pure delegation.
    Families: `--node tpu:services` (`nodes/services.py`) and `--node
    tpu:solo:<program>` (any program as a one-role partition)."""

    name = "role-partition"

    def __init__(self, opts: dict, nodes: list, roles: list):
        """`roles` is an ordered list of (name, program), each program
        built over its contiguous slice of `nodes`; ranges are assigned
        in order. Role programs address nodes globally (dest indices are
        global node ids; clients are >= len(nodes))."""
        super().__init__(opts, nodes)
        if not roles:
            raise ValueError("RolePartition needs at least one role")
        if any(isinstance(p, RolePartition) for _n, p in roles):
            raise ValueError(
                "RolePartition roles must be leaf programs (nest roles "
                "by listing them, not by wrapping a partition)")
        self.roles = list(roles)
        self._single = len(self.roles) == 1
        self._bounds = []
        base = 0
        for _rname, prog in self.roles:
            self._bounds.append((base, base + prog.n_nodes))
            base += prog.n_nodes
        if base != self.n_nodes:
            raise ValueError(
                f"role sizes sum to {base} nodes but the cluster has "
                f"{self.n_nodes} ({[(n, p.n_nodes) for n, p in roles]})")
        self.inbox_cap = max(p.inbox_cap for _, p in self.roles)
        self.outbox_cap = max(p.outbox_cap for _, p in self.roles)
        self._client_name, cp = self.roles[0]
        self._client_prog = cp
        self.device = cp.device
        if any(p.device != self.device for _, p in self.roles):
            raise ValueError("RolePartition roles must share one device")
        self.needs_state_reads = bool(getattr(cp, "needs_state_reads",
                                              False))
        if self.needs_state_reads and not self._single:
            raise ValueError(
                "needs_state_reads programs are only supported as a "
                "partition's single role (host state reads index the "
                "global node axis)")
        self.state_reads_final = bool(getattr(cp, "state_reads_final",
                                              False))
        self.reply_payload_words = int(
            getattr(cp, "reply_payload_words", 0) or 0)
        self.unit_words = tuple(getattr(cp, "unit_words", ()) or ())
        for rname, prog in self.roles[1:]:
            if getattr(prog, "unit_words", ()):
                raise ValueError(
                    f"role {rname!r}: unit_words on a non-client role "
                    f"would collide in the shared NetConfig table")
            if getattr(prog, "needs_state_reads", False):
                raise ValueError(
                    f"role {rname!r}: needs_state_reads is only "
                    f"supported on the client role (host state reads "
                    f"index the global node axis)")
        self.is_edge = bool(getattr(cp, "is_edge", False))
        if any(getattr(p, "is_edge", False) for _, p in self.roles[1:]) \
                or (self.is_edge and not self._single):
            raise ValueError(
                "edge programs are only supported as a partition's "
                "single role (pool-path roles have no static topology)")
        if self.is_edge:
            for attr in ("neighbors", "rev", "D", "lanes", "edge_cfg",
                         "edge_atomic_rpc", "edge_lanes_symmetric"):
                setattr(self, attr, getattr(cp, attr))
        self.tolerates_channel_overwrites = any(
            getattr(p, "tolerates_channel_overwrites", False)
            for _, p in self.roles)
        self.tolerates_latency_clipping = any(
            getattr(p, "tolerates_latency_clipping", False)
            for _, p in self.roles)
        # the quiescence probe: a role that is never quiescent (raft,
        # kafka) makes the partition so; the others add their planes
        if any(p.quiet_planes is None for _, p in self.roles):
            self.quiet_planes = None

    # --- device side -----------------------------------------------------

    def _role_ctx(self, ctx, i):
        if self._single:
            return ctx
        lo, hi = self._bounds[i]
        out = _RoleCtx({k: v for k, v in ctx.items() if k != "key"})
        out.round_key, out.role = ctx["key"], i
        if ctx.get("stall") is not None:
            out["stall"] = ctx["stall"][lo:hi]
        return out

    @staticmethod
    def _pad_lanes(out: Msgs, O: int) -> Msgs:
        n, L = out.valid.shape[:2]
        if L == O:
            return out
        pad = Msgs.empty((n, O - L), out.valid.device)
        return tree_map(lambda a, b: torch.cat([a, b], dim=1), out, pad)

    def init_state(self):
        return {name: prog.init_state() for name, prog in self.roles}

    def step(self, state, inbox, ctx):
        new_state = {}
        outs = []
        for i, (name, prog) in enumerate(self.roles):
            lo, hi = self._bounds[i]
            ib = (inbox if self._single
                  else tree_map(lambda f: f[lo:hi], inbox))
            st, out = prog.step(state[name], ib, self._role_ctx(ctx, i))
            new_state[name] = st
            outs.append(self._pad_lanes(out, self.outbox_cap))
        if self._single:
            return new_state, outs[0]
        return new_state, tree_map(lambda *fs: torch.cat(fs, dim=0), *outs)

    def edge_step(self, state, edge_in, client_in, ctx):
        name, prog = self.roles[0]
        st, edge_out, client_out = prog.edge_step(state[name], edge_in,
                                                  client_in, ctx)
        return {name: st}, edge_out, client_out

    def quiet_planes(self, state):
        return [p for name, prog in self.roles
                for p in prog.quiet_planes(state[name])]

    def reply_payload_plane(self, state):
        """The client role's payload plane, one row a node of the whole
        cluster: node i reads the client role's row clip(i, 0, n - 1), as
        the JAX package's `reply_payload` clips the node index."""
        plane = self._client_prog.reply_payload_plane(
            state[self._client_name])
        if self._single:
            return plane
        rows = torch.arange(self.n_nodes, device=plane.device).clamp(
            max=self._client_prog.n_nodes - 1)
        return plane[rows]

    def invalid_counters(self, state) -> dict:
        out = {}
        for name, prog in self.roles:
            for k, v in prog.invalid_counters(state[name]).items():
                out[k if self._single else f"{name}:{k}"] = v
        return out

    # --- durability (kill/restart) ---------------------------------------

    def durable_view(self, state):
        return {name: prog.durable_view(state[name])
                for name, prog in self.roles}

    def restore(self, fresh, durable, state, mask):
        return {name: prog.restore(
                    fresh[name],
                    None if durable is None else durable.get(name),
                    state[name], mask[lo:hi])
                for (name, prog), (lo, hi) in zip(self.roles, self._bounds)}

    # --- host boundary: delegated to the client role ----------------------

    def request_for_op(self, op):
        return self._client_prog.request_for_op(op)

    def node_for_op(self, op):
        local = self._client_prog.node_for_op(op)
        if local is not None:
            return int(local)
        if self._single:
            return None
        # an unrouted op goes to the client tier, never to an internal
        # node
        return 0

    def encode_body(self, body, intern):
        return self._client_prog.encode_body(body, intern)

    def decode_body(self, t, a, b, c, intern):
        return self._client_prog.decode_body(t, a, b, c, intern)

    def state_row(self, tree, node_idx: int):
        """The global node id mapped into its role's subtree (the host
        copy's leaves lead with the role's node count)."""
        for (name, prog), (lo, hi) in zip(self.roles, self._bounds):
            if lo <= node_idx < hi:
                return prog.state_row(tree[name], node_idx - lo)
        raise IndexError(f"node {node_idx} outside the partition "
                         f"({self.n_nodes} nodes)")

    def completion(self, op, body, read_state, intern):
        return self._client_prog.completion(op, body, read_state, intern)

    def completion_payload(self, op, body, payload, intern):
        return self._client_prog.completion_payload(op, body, payload,
                                                    intern)

    def host_op(self, op, read_state, intern):
        return self._client_prog.host_op(op, read_state, intern)

    def host_state(self):
        st = {name: prog.host_state() for name, prog in self.roles}
        return None if all(v is None for v in st.values()) else st

    def set_host_state(self, st):
        if st is None:
            return
        for name, prog in self.roles:
            prog.set_host_state(st.get(name))

    # --- role-targeted faults ---------------------------------------------

    def fault_groups(self) -> dict:
        """{group: [node names]} for `--nemesis-targets`: every role's
        node range, plus the subgroups a role program declares over its
        own range (`fault_subgroups`)."""
        out = {}
        for (name, prog), (lo, hi) in zip(self.roles, self._bounds):
            names = list(self.nodes[lo:hi])
            out[name] = names
            sub = getattr(prog, "fault_subgroups", None)
            if sub is not None:
                out.update(sub(names))
        return out

    def dynamic_fault_groups(self) -> tuple:
        """Target groups resolved against live cluster state when the
        fault fires (the runner's `_resolve_dynamic_target`), as the
        role programs declare them."""
        out: list = []
        for _name, prog in self.roles:
            f = getattr(prog, "dynamic_fault_groups", None)
            if f is not None:
                out += [t for t in f() if t not in out]
        return tuple(out)


# --- reply compaction (K4) -------------------------------------------------

def compact_replies_plain(flat: Msgs, K_: int, CC: int, next_mid):
    """The first CC valid rows of the flat [N * K] replies in index
    order, then the lowest-index invalid rows (the `top_k` order of the
    JAX version). src = row // K, mid = next_mid + cumsum(valid) - 1.
    Returns (replies Msgs [min(CC, N*K)], n_all). Batched over clusters,
    fields [F, N * K] and next_mid [F] give replies [F, min(CC, N*K)]
    and n_all [F], each cluster compacted on its own."""
    NK = flat.valid.shape[-1]
    idx = torch.arange(NK, dtype=torch.int64, device=flat.valid.device)
    order = torch.sort((~flat.valid).to(torch.int64) * NK + idx,
                       dim=-1).indices[..., :min(CC, NK)]
    rows = tree_map(lambda f: torch.gather(f, -1, order), flat)
    rows = rows.replace(
        src=(order // K_).to(I32),
        mid=next_mid[..., None] + torch.cumsum(rows.valid, -1, dtype=I32)
        - 1)
    return rows, flat.valid.sum(dim=-1, dtype=I32)


def compact_replies(flat: Msgs, K_: int, CC: int, next_mid):
    """Client replies compacted into CC slots (see
    `compact_replies_plain`), for one cluster or a batch; the kernel is
    K4 in `csrc/compact.cu`."""
    if not K.use_kernel(flat.valid):
        return compact_replies_plain(flat, K_, CC, next_mid)
    lead = tuple(flat.valid.shape[:-1])
    if len(lead) > 1 or tuple(next_mid.shape) != lead \
            or next_mid.dtype != I32:
        raise ValueError("compact_replies: fields [N * K] or [F, N * K], "
                         "next_mid an i32 scalar or [F]")
    F = lead[0] if lead else 1
    NK = flat.valid.shape[-1]
    CCe = min(CC, NK)
    dev = flat.valid.device
    for name in Msgs.__dataclass_fields__:
        t = getattr(flat, name)
        want = torch.bool if name == "valid" else I32
        if tuple(t.shape) != lead + (NK,) or t.dtype != want:
            raise ValueError(f"compact_replies {name}: {tuple(t.shape)} "
                             f"{t.dtype}")
    out = Msgs(valid=torch.empty(lead + (CCe,), dtype=torch.bool,
                                 device=dev),
               **{f: torch.empty(lead + (CCe,), dtype=I32, device=dev)
                  for f in Msgs.__dataclass_fields__ if f != "valid"})
    n_all = torch.empty(lead, dtype=I32, device=dev)
    # per-segment valid counts (segments of 4096 rows a cluster,
    # csrc/compact.cu)
    seg_count = torch.empty(F * -(-NK // 4096), dtype=I32, device=dev)
    ins = [getattr(flat, f).contiguous() for f in
           ("valid", "dest", "due", "reply_to", "type", "a", "b", "c")]
    outs = [getattr(out, f) for f in
            ("valid", "src", "dest", "due", "mid", "reply_to", "type", "a",
             "b", "c")]
    K.REPLY_COMPACT.launch(
        ins + [next_mid.contiguous()] + outs + [n_all, seg_count],
        [NK, K_, CCe, seg_count.numel(), F], dev)
    return out, n_all


# --- the round -------------------------------------------------------------

def _round(program, cfg: NetConfig, sim: SimState, inject: Msgs):
    """One simulation round. `inject` is a flat Msgs batch of client
    requests (src = client index >= n_nodes). Returns (sim', client_msgs,
    io) as the JAX version does."""
    if getattr(program, "is_edge", False):
        return _round_edge(program, cfg, sim, inject)
    return _round_pool(program, cfg, sim, inject)


def _round_pool(program, cfg: NetConfig, sim: SimState, inject: Msgs):
    """The pool-path round (the JAX package's `_round` for programs
    without `is_edge`, `sim.py:412-460`): the client injections are sent
    with k1, due messages delivered, every node stepped on its [N, K]
    inbox with k2 in its ctx, and the outboxes, flattened to [N * O] with
    src = the sending node, sent with k3. Client replies are the
    delivery's client batch. Killed and paused nodes (`ctx["stall"]`)
    keep their state and send nothing: the step applies the freeze.
    io = (inject_sent, outbox_sent, inbox)."""
    N, O = cfg.n_nodes, program.outbox_cap
    keys = prng.split(sim.key, 4)
    net, inject_sent = T._send(cfg, sim.net, inject, keys[1])
    net, inbox, client_msgs = T._deliver(cfg, net)
    ctx = {"round": net.round, "key": keys[2]}
    if cfg.enable_stall:
        ctx["stall"] = sim.net.down | sim.net.paused
    nodes, outbox = program.step(sim.nodes, inbox, ctx)
    byz = sim.byz
    if cfg.enable_byz:
        # the adversary rewrites the culprit's outbox rows (K30) after the
        # step's freeze and before the send: the lie travels the pool
        # with its loss, partitions and latency
        byz, outbox = BZ.corrupt_pool(program, byz, outbox, net.round)
    flat = tree_map(lambda f: f.reshape((N * O,) + tuple(f.shape[2:])),
                    outbox)
    src = torch.arange(N, dtype=I32, device=flat.valid.device)
    flat = flat.replace(src=src.repeat_interleave(O))
    net, outbox_sent = T._send(cfg, net, flat, keys[3])
    net = T.advance(net)
    tel = sim.telemetry
    if cfg.telemetry and tel is not None:
        # the flight recorder's fold (K19), after every draw: the ring
        # never changes the simulation. A node's sends are its valid
        # outbox rows.
        tel = TM.ring_update(cfg, tel, sim.net.stats, net, None,
                             sim.net.round, (flat.valid.reshape(N, O),),
                             inject_sent, client_msgs)
    return (SimState(net=net, nodes=nodes, key=keys[0].contiguous(),
                     durable=program.durable_view(nodes), telemetry=tel,
                     byz=byz),
            client_msgs, (inject_sent, outbox_sent, inbox))


# --- the edge fault block (K8) ------------------------------------------------

@dataclass
class EdgeFaults(Struct):
    """A round's fault masks and draws over the draw shape [N, D, Ld]
    (Ld = the out lanes, or 1 for `edge_atomic_rpc` programs): the
    deliver mask, the latency rounds (None for constant latency), and
    with duplication the duplicate mask and its latency (None for
    constant latency)."""
    deliver: torch.Tensor
    lat: object = None
    dup: object = None
    dup_lat: object = None


_FAULT_STATS = ("lost", "dropped_partition", "dropped_down", "duplicated")


def _pick(table, idx):
    """table[..., idx]: a cluster's row of a per-cluster table ([C], or
    [F, C] on the cluster axis) at node ids `idx` [N, D]."""
    return table[..., idx]


def _blocked_edges(cfg: NetConfig, nb, net: NetState):
    """(blocked, stalled) [N, D] (or [F, N, D] on the cluster axis, each
    cluster's by its own labels): partitioned edges (component labels
    and the directional block matrix) and, with stall, edges into a
    killed or paused destination, which count as blocked. `nb` is one
    cluster's [N, D] table in local node ids."""
    N = cfg.n_nodes
    safe = nb.clamp(0, N - 1).long()
    comp = net.component
    blocked = comp[..., :N, None] != _pick(comp, safe)
    if cfg.partition_groups > 1:
        G = cfg.partition_groups
        bg = net.block_groups.long()
        cell = bg[..., :N, None] * G + _pick(bg, safe)
        bm = net.block_matrix.reshape(tuple(bg.shape[:-1]) + (G * G,))
        blocked = blocked | torch.gather(
            bm, -1, cell.reshape(tuple(bg.shape[:-1]) + (-1,))
        ).reshape(cell.shape)
    blocked = blocked & (nb >= 0)
    if cfg.enable_stall:
        stalled = _pick(net.down | net.paused, safe) & (nb >= 0) & ~blocked
    else:
        stalled = torch.zeros_like(blocked)
    return blocked | stalled, stalled


def edge_faults_plain(cfg: NetConfig, nb, net: NetState, valid, keys,
                      atomic: bool):
    """The JAX round's edge fault block (`sim.py:545-610`): partitions,
    stalled destinations, the loss roll (keys[3]), latency draws
    (keys[4]) and, with duplication, the duplicate roll (keys[5]) and
    its latency (keys[6]). Returns (EdgeFaults, the four counters
    lost / dropped_partition / dropped_down / duplicated advanced). On
    the cluster axis `valid` is [F, N, D, L], `keys` [F, 5 or 7, 2] and
    the net's leaves F-led: every mask, draw and counter is its
    cluster's own (JAX's `vmap` of the block)."""
    N, D, L = valid.shape[-3:]
    lead = tuple(valid.shape[:-3])
    dshape = lead + (N, D, 1 if atomic else L)
    n = N * D * dshape[-1]
    blocked, stalled = _blocked_edges(cfg, nb, net)
    lat_spec = (None if cfg.latency_dist == "constant" else
                ("latency", cfg.latency_dist, cfg.latency_mean_rounds,
                 net.latency_scale))
    dup_on = cfg.enable_duplication
    lost, lat, dup, dup_lat = (
        None if d is None else d.reshape(dshape) for d in prng.draws(
            keys[..., 3:, :], n, [("mask", net.p_loss), lat_spec]
            + ([("mask", net.p_dup), lat_spec] if dup_on else [None, None])))
    deliver = ~blocked[..., None] & ~lost
    out = EdgeFaults(deliver=deliver, lat=lat)
    st = net.stats
    counts = [valid & ~blocked[..., None] & lost,
              valid & (blocked & ~stalled)[..., None],
              valid & stalled[..., None]]
    if dup_on:
        out.dup = deliver & dup
        out.dup_lat = dup_lat
        counts.append(valid & out.dup)
    new = {f: getattr(st, f) + c.reshape(lead + (-1,)).sum(dim=-1,
                                                           dtype=I32)
           for f, c in zip(_FAULT_STATS, counts)}
    return out, st.replace(**new)


def edge_faults(cfg: NetConfig, nb, net: NetState, valid, keys,
                atomic: bool = False):
    """A round's edge fault masks, draws and counters (see
    `edge_faults_plain`); the kernel is K8 `edge_faults` in
    `csrc/faults.cu`. `keys` is the round's split [5 or 7, 2], or [F, 5
    or 7, 2] with `valid` [F, N, D, L] on the cluster axis (one launch
    for all F clusters)."""
    if not K.use_kernel(valid):
        return edge_faults_plain(cfg, nb, net, valid, keys, atomic)
    N, D, L = valid.shape[-3:]
    lead = tuple(valid.shape[:-3])
    F = lead[0] if lead else 1
    dev = valid.device
    Ld = 1 if atomic else L
    dshape = lead + (N, D, Ld)
    random_lat = cfg.latency_dist != "constant"
    dup_on = cfg.enable_duplication
    grudge = cfg.partition_groups > 1
    stall = cfg.enable_stall
    if valid.dtype != torch.bool or tuple(nb.shape) != (N, D) \
            or len(lead) > 1:
        raise ValueError("edge_faults: valid [N, D, L] or [F, N, D, L] "
                         "bool, neighbors [N, D]")
    if tuple(keys.shape) != lead + (7 if dup_on else 5, 2):
        raise ValueError(f"edge_faults: round keys {tuple(keys.shape)}")

    def new(dtype):
        return torch.empty(dshape, dtype=dtype, device=dev)
    out = EdgeFaults(deliver=new(torch.bool),
                     lat=new(I32) if random_lat else None,
                     dup=new(torch.bool) if dup_on else None,
                     dup_lat=new(I32) if dup_on and random_lat else None)
    st = net.stats
    o_stats = {f: torch.empty(lead, dtype=I32, device=dev)
               for f in _FAULT_STATS}
    acc = torch.empty(4 * F, dtype=I32, device=dev)

    def key(i):
        return keys[..., i, :].contiguous()
    K.EDGE_FAULTS.launch(
        [nb.contiguous(), net.component,
         net.block_groups if grudge else None,
         net.block_matrix if grudge else None,
         net.down if stall else None, net.paused if stall else None,
         valid.contiguous(), key(3), key(4),
         key(5) if dup_on else None, key(6) if dup_on else None,
         net.p_loss, net.p_dup, net.latency_scale]
        + [getattr(st, f) for f in _FAULT_STATS]
        + [acc, out.deliver, out.lat, out.dup, out.dup_lat]
        + [o_stats[f] for f in _FAULT_STATS],
        [N, D, L, Ld, cfg.partition_groups, prng.DISTS[cfg.latency_dist],
         prng.f32_bits(cfg.latency_mean_rounds), F,
         net.component.shape[-1]], dev)
    return out, st.replace(**o_stats)


@dataclass(frozen=True)
class ClusterAxis:
    """The cluster axis of a round (`parallel.make_cluster_round_fn`): F
    clusters whose leaves lead with [F, N], node-local work done over the
    F * N node rows, the exchange with the channel config of F * N rows
    and the global neighbour and reverse-slot tables."""
    F: int
    ecfg: object            # EdgeConfig of F * N node rows
    neighbors: torch.Tensor  # [F * N, D] cluster f's table plus f * N
    rev: torch.Tensor        # [F * N, D]


def _rows(tree, axis):
    """A tree of [F, N, ...] leaves viewed as [F * N, ...] node rows on
    the cluster axis; one cluster's tree as it is."""
    if axis is None:
        return tree
    return tree_map(lambda t: t.reshape((-1,) + tuple(t.shape[2:])), tree)


def _unrows(tree, axis):
    """The inverse of `_rows`."""
    if axis is None:
        return tree
    return tree_map(lambda t: t.reshape((axis.F, -1) + tuple(t.shape[1:])),
                    tree)


def _round_edge(program, cfg: NetConfig, sim: SimState, inject: Msgs,
                axis: ClusterAxis = None, value_free: bool = False):
    """One round of one cluster, or with `axis` of F clusters at once
    (JAX's `vmap` of this round written out: every leaf leads with F,
    each step is one launch for all clusters). `inject` None is a round
    with no client injection (its io's inject view is None). With
    `value_free` (the cluster axis only: `parallel.make_cluster_round_fn`
    finds that no fault draw of the round can change a value) the pool
    send's loss roll and the edge fault pass (K8) are skipped: every
    lane is delivered at latency 0 and the fault counters do not move."""
    N, Kc = cfg.n_nodes, program.inbox_cap
    lead = () if axis is None else (axis.F,)
    if axis is None:
        ecfg, nb, rev = program.edge_cfg, program.neighbors, program.rev
    else:
        ecfg, nb, rev = axis.ecfg, axis.neighbors, axis.rev
    # the round's keys: key', k1 (pool sends), k2 (the program), k4 (loss),
    # k5 (latency)[, k6 (duplication), k7 (its latency)]; on the cluster
    # axis K7 splits all F keys at once, [F, 5 or 7, 2], and every draw
    # of cluster f comes from its own keys[f]
    keys = prng.split(sim.key, 7 if cfg.enable_duplication else 5)
    if inject is None:
        # no injection (the fleet scan's rounds after its first): a send
        # of no valid row changes no value, so it is skipped
        net, inject_sent = sim.net, None
    else:
        net, inject_sent = T._send(
            cfg, sim.net, inject,
            None if value_free else keys[..., 1, :].contiguous())
    net, client_inbox, pool_client_msgs = T._deliver(cfg, net)
    ch0 = sim.channels
    ch = ch0.replace(**{f: _rows(getattr(ch0, f), axis)
                        for f in ("valid", "type", "a", "b", "c")})
    # a scalar round, or on the cluster axis every cluster's own [F]
    # round (each node row reads its cluster's)
    rnd = net.round
    ch, edge_in = static.edge_read(ecfg, ch, nb, rev, rnd)
    stall = (sim.net.down | sim.net.paused) if cfg.enable_stall else None
    if axis is None:
        ctx = {"round": net.round, "key": keys[2]}
        if stall is not None:
            # killed and paused nodes keep their state and send nothing
            ctx["stall"] = stall
        nodes, edge_out, client_out = program.edge_step(
            sim.nodes, edge_in, client_inbox, ctx)
    else:
        nodes, edge_out, client_out = program.step_rows(
            _rows(sim.nodes, axis), edge_in, _rows(client_inbox, axis),
            net.round, keys[:, 2].contiguous(),
            None if stall is None else stall.reshape(-1))
        nodes = _unrows(nodes, axis)
    byz = sim.byz
    if cfg.enable_byz:
        # the forged-proof surface: the culprit's batch acks (K31), after
        # the step's freeze and before the compaction
        byz, client_out = BZ.corrupt_edge(program, byz, client_out,
                                          net.round)

    # client replies bypass the pool (clients have zero latency,
    # net.clj:177-186): valid rows are compacted into the client buffer
    flat = tree_map(lambda f: f.reshape(lead + (N * Kc,)), client_out)
    CC = max(cfg.client_cap, 2 * cfg.n_clients, 1)
    replies, n_all = compact_replies(flat, Kc, CC, net.next_mid)
    st = net.stats
    if cfg.unit_words:
        # reply units (batch acks carry their op count), booked on both
        # sides: the zero-latency client channel sends and delivers in
        # the same round
        ru = T.payload_units(cfg, flat.type, (flat.a, flat.b, flat.c),
                             flat.valid)
        st = st.replace(sent_units=st.sent_units + ru,
                        recv_units=st.recv_units + ru)
    net = net.replace(next_mid=net.next_mid + n_all, stats=st.replace(
        sent_all=st.sent_all + n_all, recv_all=st.recv_all + n_all,
        sent_by_type=T.count_by_type(st.sent_by_type, flat.type,
                                     flat.valid)))
    client_msgs = (replies if pool_client_msgs.valid.shape[-1] == 0
                   else tree_map(lambda a, b: torch.cat([a, b], dim=-1),
                                 pool_client_msgs, replies))

    shape = edge_out.valid.shape
    # edge faults (net.clj:213, 233): partitions, stalled destinations,
    # loss, latency and duplication draws, one kernel (K8); on the cluster
    # axis over [F, N, D, L] with each cluster's own labels, masks, keys
    # and counters (partitions read the local neighbour table)
    if ecfg.uniform_arrival and cfg.latency_dist != "constant":
        raise ValueError(
            "uniform_arrival requires constant latency draws (program "
            "opts and NetConfig disagree about the latency "
            "distribution)")
    if value_free:
        fstats = net.stats
        dev = edge_out.valid.device
        faults = EdgeFaults(
            deliver=torch.ones((), dtype=torch.bool,
                               device=dev).expand(shape),
            lat=torch.zeros((), dtype=I32, device=dev).expand(shape))
    elif axis is None:
        faults, fstats = edge_faults(cfg, nb, net, edge_out.valid, keys,
                                     program.edge_atomic_rpc)
        scale = net.latency_scale
    else:
        faults, fstats = edge_faults(cfg, program.neighbors, net,
                                     _unrows(edge_out.valid, axis), keys,
                                     program.edge_atomic_rpc)
        faults = tree_map(lambda t: _rows(t, axis), faults)
        scale = net.latency_scale.repeat_interleave(N)[:, None, None]
    lat, deliver = faults.lat, faults.deliver
    if lat is None:
        lat = T.draw_latency_rounds(cfg, None, scale, shape)
    ch = static.edge_write(ecfg, ch, edge_out, rnd, lat, deliver)
    if cfg.enable_duplication:
        # a delivered message is written again under its own latency
        # draw; constant draws are equal, so the copy goes one round past
        # the original's floored arrival
        lat_dup = faults.dup_lat
        if lat_dup is None:
            lat_dup = torch.clamp(lat, min=1) + 1
        ch = static.edge_write(ecfg, ch, edge_out, rnd, lat_dup,
                               faults.dup)

    n_sent = edge_out.valid.reshape(lead + (-1,)).sum(dim=-1, dtype=I32)
    n_recv = edge_in.valid.reshape(lead + (-1,)).sum(dim=-1, dtype=I32)
    if cfg.unit_words:
        # a distilled range lane is ONE edge message carrying n client-op
        # units (the JAX round's batch-expansion accounting)
        fstats = fstats.replace(**{
            f: getattr(fstats, f) + T.payload_units(
                cfg, m.type, (m.a, m.b, m.c), m.valid)
            for f, m in (("sent_units", edge_out), ("recv_units", edge_in))})
    net = net.replace(stats=fstats.replace(
        sent_all=fstats.sent_all + n_sent,
        sent_servers=fstats.sent_servers + n_sent,
        recv_all=fstats.recv_all + n_recv,
        recv_servers=fstats.recv_servers + n_recv,
        sent_by_type=T.count_by_type(fstats.sent_by_type, edge_out.type,
                                     edge_out.valid)))
    net = T.advance(net)
    ch = ch.replace(**{f: _unrows(getattr(ch, f), axis)
                       for f in ("valid", "type", "a", "b", "c")})
    edge_out, edge_in = _unrows(edge_out, axis), _unrows(edge_in, axis)
    tel = sim.telemetry
    if cfg.telemetry and tel is not None:
        if axis is not None:
            raise NotImplementedError(
                f"telemetry on the cluster axis comes with "
                f"{FLEET_STREAM_SLICE}")
        # the flight recorder's fold (K19): a node's sends are its edge
        # sends plus its uncompacted reply rows, and the latency buckets
        # read every valid reply row (`flat`), not the CC-capped
        # compaction
        tel = TM.ring_update(cfg, tel, sim.net.stats, net, ch.valid,
                             sim.net.round,
                             (edge_out.valid.reshape(N, -1),
                              flat.valid.reshape(N, Kc)),
                             inject_sent, flat)
    return (SimState(net=net, nodes=nodes, key=keys[..., 0, :].contiguous(),
                     channels=ch, durable=program.durable_view(nodes),
                     telemetry=tel, byz=byz),
            client_msgs,
            (inject_sent, replies, client_inbox, edge_out, edge_in))


def make_round_fn(program, cfg: NetConfig, device="cuda"):
    """round_fn(sim, inject) -> (sim', client_msgs, io): one round."""
    dev = resolve_device(device)
    T.check_scope(cfg)
    _check_program(program, cfg, dev)

    def round_fn(sim: SimState, inject: Msgs):
        return _round(program, cfg, sim, inject)
    return round_fn


def make_run_fn(program, cfg: NetConfig, collect_client_msgs: bool = False,
                device="cuda"):
    """run_fn(sim, plan) -> (sim', per-round client counts i32 [R], or the
    client Msgs stacked [R, CC]) for a plan Msgs [R, M] of pre-scheduled
    client injections. The rounds run back to back on the device; the
    host reads nothing until the caller does."""
    dev = resolve_device(device)
    T.check_scope(cfg)
    _check_program(program, cfg, dev)

    def run_fn(sim: SimState, plan: Msgs):
        outs = []
        for r in range(plan.valid.shape[0]):
            sim, client_msgs, _ = _round(program, cfg, sim,
                                         plan.at_rows(r))
            outs.append(client_msgs if collect_client_msgs
                        else client_msgs.count())
        if collect_client_msgs:
            return sim, tree_map(lambda *fs: torch.stack(fs), *outs)
        return sim, torch.stack(outs)
    return run_fn


# --- the scan-ahead (make_scan_fn) ------------------------------------------

# rounds a chunk of the scan: the host reads the exit flag once a chunk
SCAN_CHUNK = 16

_LOG_FIELDS = tuple(Msgs.__dataclass_fields__)


def empty_reply_log(rcap: int, W: int, device):
    """A fresh reply log: (Msgs [rcap], rounds i32 [rcap], payload i32
    [rcap, W] or None, rn i32 scalar), empty as the JAX package makes
    it."""
    plog = (torch.zeros((rcap, W), dtype=I32, device=device) if W
            else None)
    return (Msgs.empty(rcap, device),
            torch.zeros(rcap, dtype=I32, device=device), plog,
            torch.zeros((), dtype=I32, device=device))


def pack_words(rows, W: int):
    """[..., V] bool rows -> [..., W] i32 words, 32 values a word, low bit
    = lowest value index; bit 31 wraps to the sign, as the int32 sum of
    the JAX package's `_pack_seen_words` does (the broadcast program's
    reply payload)."""
    pad = W * 32 - rows.shape[-1]
    if pad:
        rows = torch.cat([rows, rows.new_zeros(rows.shape[:-1] + (pad,))],
                         dim=-1)
    bits = rows.reshape(*rows.shape[:-1], W, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=rows.device)
    return (bits << shifts).sum(dim=-1).to(I32)


def append_replies_plain(log, cm: Msgs, seen, n_nodes: int, round_i,
                         k: int, k_max: int, stop: bool, exit_k):
    """The JAX package's `append_replies` and the scan's `cond`, in place:
    cm's valid rows go to rows rn, rn+1, ... of the log (rows at rcap or
    beyond are dropped), stamped with `round_i`, with the payload of
    node clip(src): the packed words of seen[clip(src)] for a bool plane
    [N, V], the row itself for int32 rows [N, W] (the program's
    `reply_payload_plane`). Returns rn' = rn + every valid row. When
    go = k < k_max & ~(stop & any valid) & rn' + CW <= rcap fails and
    exit_k > k, exit_k becomes k."""
    rlog, rounds, plog, rn = log
    valid = cm.valid
    CW, rcap = valid.shape[0], rounds.shape[0]
    total = valid.sum(dtype=I32)
    pos = rn.long() + torch.cumsum(valid, 0) - valid.long()
    keep = valid & (pos < rcap)
    at = pos[keep]
    for f in _LOG_FIELDS:
        getattr(rlog, f)[at] = getattr(cm, f)[keep]
    rounds[at] = round_i.to(I32)
    if plog is not None:
        rows = seen[cm.src[keep].clamp(0, n_nodes - 1).long()]
        plog[at] = (rows if rows.dtype == I32
                    else pack_words(rows, plog.shape[1]))
    rn2 = rn + total
    go = (k < k_max) & ~(stop & (total > 0)) & (rn2 + CW <= rcap)
    exit_k.copy_(torch.where(~go & (exit_k > k), k, exit_k))
    return rn2


def append_replies(log, cm: Msgs, seen, n_nodes: int, round_i, k: int,
                   k_max: int, stop: bool, exit_k):
    """Appends a round's client replies to the scan's reply log and sets
    the scan's exit flag (see `append_replies_plain`); the kernel is K5
    `reply_log_append` in `csrc/scan.cu`. `seen` is the program's [N, V]
    bool plane whose packed words are the reply payload, or its [N, W]
    int32 payload rows (K5's int32 form, `reply_log_append_i32`), or
    None without payload."""
    if not K.use_kernel(cm.valid):
        return append_replies_plain(log, cm, seen, n_nodes, round_i, k,
                                    k_max, stop, exit_k)
    dev = cm.valid.device
    CW = cm.valid.shape[0]
    for f in _LOG_FIELDS:
        t = getattr(cm, f)
        if tuple(t.shape) != (CW,) or t.dtype != (
                torch.bool if f == "valid" else I32):
            raise ValueError(f"append_replies cm.{f}: {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, t in (("round", round_i), ("exit_k", exit_k)):
        if t.shape != () or t.dtype != I32:
            raise ValueError(f"append_replies: {name} must be an i32 "
                             f"scalar")
    rlog, rounds, plog, rn = log
    rcap = rounds.shape[0]
    W = 0 if plog is None else plog.shape[1]
    rows_i32 = W and seen is not None and seen.dtype == I32
    if W and (seen is None or seen.dim() != 2 or seen.shape[0] != n_nodes
              or (seen.shape[1] != W if rows_i32 else
                  seen.dtype != torch.bool or seen.shape[1] > W * 32)):
        raise ValueError("append_replies: payload needs the [N, V] bool "
                         "plane, V <= 32 W, or [N, W] int32 rows")
    V = seen.shape[1] if W else 0
    rn_out = torch.empty((), dtype=I32, device=dev)
    seg_count = torch.empty(max(1, -(-CW // 4096)), dtype=I32, device=dev)
    kernel = K.REPLY_LOG_APPEND_I32 if rows_i32 else K.REPLY_LOG_APPEND
    kernel.launch(
        [getattr(cm, f).contiguous() for f in _LOG_FIELDS]
        + [getattr(rlog, f) for f in _LOG_FIELDS]
        + [rounds, plog, seen.contiguous() if V else None, round_i, rn,
           rn_out, exit_k, seg_count],
        [CW, rcap, W, n_nodes, V, k, k_max, int(stop), seg_count.numel()],
        dev)
    return rn_out


def _reset_log_tail(log, rn_from):
    """Empties the log rows at or past the device count `rn_from` (the
    rows a rolled-back stretch appended)."""
    rlog, rounds, plog, _rn = log
    tail = torch.arange(rounds.shape[0], device=rounds.device) >= rn_from
    for f in _LOG_FIELDS:
        getattr(rlog, f).masked_fill_(tail, -1 if f == "reply_to" else 0)
    rounds.masked_fill_(tail, 0)
    if plog is not None:
        plog.masked_fill_(tail[:, None], 0)


# --- the continuous scan's select and fold (K18) ----------------------------

def sched_select_plain(inject_valid, at, im, sent, off):
    """The sched-inject scan's per-round step (`sim.py:847-930` of the
    JAX package): folds the previous round's id-stamped inject view
    `sent` (None: no fold) into `im` (None: all -1, the window's first
    round), and selects the rows scheduled at window offset `off`
    (None: the last fold, no select). Returns (inject valid or None,
    im'), both fresh tensors."""
    m = torch.full_like(at, -1) if im is None else im
    if sent is not None:
        m = torch.where(sent.valid, sent.mid, m)
    return (None if off is None else inject_valid & (at == off)), m


def sched_select(inject_valid, at, im, sent, off):
    """The continuous scan's select and fold (see `sched_select_plain`);
    the kernel is K18 `sched_inject` in `csrc/stream.cu`, one launch a
    round."""
    if not K.use_kernel(at):
        return sched_select_plain(inject_valid, at, im, sent, off)
    dev = at.device
    Q = at.shape[0]
    for name, t, want in (("inject valid", inject_valid, torch.bool),
                          ("at", at, I32), ("im", im, I32)):
        if t is not None and (tuple(t.shape) != (Q,) or t.dtype != want):
            raise ValueError(f"sched_select {name}: {tuple(t.shape)} "
                             f"{t.dtype}")
    valid = (None if off is None else
             torch.empty(Q, dtype=torch.bool, device=dev))
    out_im = torch.empty(Q, dtype=I32, device=dev)
    K.SCHED_INJECT.launch(
        [inject_valid, at, im,
         None if sent is None else sent.valid.contiguous(),
         None if sent is None else sent.mid.contiguous(), valid, out_im],
        [Q, 0 if off is None else off], dev)
    return valid, out_im


def make_scan_fn(program, cfg: NetConfig, reply_cap: int = 256,
                 journal_cap: int | None = None, device="cuda",
                 chunk: int = SCAN_CHUNK, fetch=None,
                 first_chunk: int | None = None,
                 sched_inject: bool = False):
    """scan_fn(sim, inject, k_max, stop_on_reply=True) -> (sim', cm, k,
    (rlog, rounds, plog, rn)[, buf]): the JAX package's `make_scan_fn`
    with a reply log (the form the runner uses). `inject` is applied in
    the first round; then
    injection-free rounds run while k < k_max, no client reply arrived
    when `stop_on_reply`, and the reply log has room for a whole round
    of replies (rcap = max(reply_cap, 2 * CW), CW the width of a round's
    client messages). k (a host int) counts the rounds executed, >= 1.
    `journal_cap` collects every round's io into [cap, ...] buffers
    (rows past k zero) and bounds k_max. Each call makes a fresh log.

    With `sched_inject` (continuous mode) the scan is scan_fn(sim,
    inject, at_rounds, k_max, stop_on_reply=True) -> (sim', cm, k, log,
    im[, buf]): `inject` is a [Q] batch with an i32 [Q] window offset a
    row, round k (0-based) injects exactly the rows with at_rounds == k
    (K18), and im[j] is the mid `_send` stamped on row j, -1 for the
    rows the window did not reach.

    The loop stays on the device. JAX runs it as one while_loop; here
    rounds run in chunks of `chunk`, each ending with one host read of
    the exit flag K5 keeps (`fetch(tensor) -> int`, `int` by default).
    A chunk that ran past the exit round is rolled back: the state
    cloned at its start (the channels, the one part a round updates in
    place) is restored with the rest of that state, the key and the
    fault masks and scalars among it (the nemesis changes those only
    between dispatches), the log rows it appended are emptied, and
    exactly the rounds up to the exit round are replayed: from the same
    key they draw the same numbers.
    With `first_chunk` (the runner's choice for pool-path programs, whose
    dispatches at a high op rate end a round or two in), a dispatch that
    stops on replies starts with a chunk of `first_chunk` rounds and
    doubles it up to `chunk`, so that an early exit runs few rounds past
    it; the host then reads at most ceil(k / chunk) + log2(chunk /
    first_chunk) flags a dispatch, else ceil(k / chunk).
    `scan_fn.host_syncs` counts them; `scan_fn.replayed` the rounds
    replayed and `scan_fn.rolled_back` the rounds run past an exit and
    discarded, so that a dispatch runs k + replayed + rolled_back rounds
    for the k it returns."""
    dev = resolve_device(device)
    T.check_scope(cfg)
    _check_program(program, cfg, dev)
    cap = None if journal_cap is None else max(1, int(journal_cap))
    rcap_req = max(1, int(reply_cap))
    W = int(getattr(program, "reply_payload_words", 0) or 0)
    N = cfg.n_nodes
    CC = max(cfg.n_clients, 1)
    chunk = max(1, int(chunk))
    first = chunk if first_chunk is None else min(max(1, int(first_chunk)),
                                                  chunk)
    read = fetch or (lambda t: int(t))
    sched = bool(sched_inject)

    def _scan(sim: SimState, inject: Msgs, at, k_max, stop_on_reply):
        k_max = int(k_max)
        stop = bool(stop_on_reply)
        if cap is not None:
            k_max = min(k_max, cap)
        last = max(k_max, 1)
        empty = Msgs.empty(CC, dev)
        exit_k = torch.full((), INT32_MAX, dtype=I32, device=dev)
        # im and the last round's stamped inject view (continuous mode)
        st = {"log": None, "buf": None, "im": None, "sent": None}

        def step(cur, k):
            """Round k (1-based) from state `cur`."""
            if sched:
                valid, st["im"] = sched_select(inject.valid, at, st["im"],
                                               st["sent"], k - 1)
                inj = inject.replace(valid=valid)
            else:
                inj = inject if k == 1 else empty
            sim2, cm2, io = _round(program, cfg, cur, inj)
            if sched:
                st["sent"] = io[0]
            if cap is not None:
                if st["buf"] is None:
                    st["buf"] = tree_map(
                        lambda x: torch.zeros((cap,) + tuple(x.shape),
                                              dtype=x.dtype, device=dev),
                        io)
                tree_map(lambda b, x: b[k - 1].copy_(x), st["buf"], io)
            log = st["log"]
            if log is None:
                cw = cm2.valid.shape[0]
                log = empty_reply_log(max(rcap_req, 2 * cw), W, dev)
            seen = program.reply_payload_plane(sim2.nodes) if W else None
            rn2 = append_replies(log, cm2, seen, N, sim2.net.round, k,
                                 k_max, stop, exit_k)
            st["log"] = log[:3] + (rn2,)
            return sim2, cm2

        k, cur, cm = 0, sim, None
        size = first if stop else chunk
        while True:
            n = min(size, last - k)
            size = min(2 * size, chunk)
            # every other leaf is replaced, not updated, by a round: the
            # snapshot holds the chunk's start key and fault state
            snap = cur.replace(channels=tree_map(lambda t: t.clone(),
                                                 cur.channels))
            rn_snap = None if st["log"] is None else st["log"][3]
            fold_snap = (st["im"], st["sent"])
            for j in range(n):
                cur, cm = step(cur, k + j + 1)
            if n == 1 and k + 1 >= last:
                k += 1          # one legit round and nothing after it
                break
            e = read(exit_k)
            scan_fn.host_syncs += 1
            if e >= k + n:
                k += n
                if e == k:
                    break
                continue
            # rounds e+1 .. k+n ran past the exit: roll back and replay
            scan_fn.rolled_back += k + n - e
            cur = snap
            st["im"], st["sent"] = fold_snap
            if rn_snap is None:
                rn_snap = torch.zeros((), dtype=I32, device=dev)
            _reset_log_tail(st["log"], rn_snap)
            st["log"] = st["log"][:3] + (rn_snap,)
            if st["buf"] is not None:
                tree_map(lambda b: b[e:k + n].zero_(), st["buf"])
            for j in range(e - k):
                cur, cm = step(cur, k + j + 1)
            scan_fn.replayed += e - k
            k = e
            break
        out = (cur, cm, k, st["log"])
        if sched:
            # the window's last fold: round k's stamped mids
            out = out + (sched_select(inject.valid, at, st["im"],
                                      st["sent"], None)[1],)
        if cap is not None:
            out = out + (st["buf"],)
        return out

    if sched:
        def scan_fn(sim: SimState, inject: Msgs, at_rounds, k_max,
                    stop_on_reply=True):
            return _scan(sim, inject, at_rounds, k_max, stop_on_reply)
    else:
        def scan_fn(sim: SimState, inject: Msgs, k_max, stop_on_reply=True):
            return _scan(sim, inject, None, k_max, stop_on_reply)

    scan_fn.host_syncs = 0
    scan_fn.replayed = 0
    scan_fn.rolled_back = 0
    return scan_fn


# --- the fleet scan (make_fleet_scan_fn): K32 and K5's fleet form ----------

# K32's leaves a launch (csrc/fleet.cu kMaxLeaves), the most 16-byte
# chunks of a row one block copies, and the chunks of its rows a block
# spans (a block's rows times its slice; the best of 1,024 to 16,384 on
# an H100, scripts/time_kernels.py)
_HOLD_LEAVES = 96
_HOLD_SLICE = 1024
_HOLD_BLOCK = 4096


def hold_chunks(rb: int) -> int:
    """K32's chunks of a leaf of `rb` bytes a cluster row: rb / 16 for a
    multiple of 16, cut from the row's start; else ceil((rb + 15) / 16),
    cut on the 16-byte grid of the row's address (csrc/fleet.cu
    hold_chunk), enough for the row at any offset."""
    return rb // 16 if rb % 16 == 0 else (rb + 30) // 16


@functools.lru_cache(maxsize=64)
def hold_plan(row_bytes: tuple) -> tuple:
    """K32's launch plan for leaves of `row_bytes` bytes a cluster row:
    (off, rows, slice). Leaf k's `hold_chunks` chunks are the chunks
    [off[k], off[k + 1]) of one flat space a row; a block copies the
    chunks [y * slice, (y + 1) * slice) of `rows` cluster rows, the
    slices as even as 1,024 chunks a block allows and the rows as many
    as fill 4,096 chunks (at most 256, one flag a thread). Depends on
    the shapes alone."""
    off = [0]
    for rb in row_bytes:
        off.append(off[-1] + hold_chunks(rb))
    C = off[-1]
    slices = max(1, -(-C // _HOLD_SLICE))
    slice_ = max(1, -(-C // slices))
    rows = max(1, min(256, _HOLD_BLOCK // slice_))
    return tuple(off), rows, slice_


def fleet_hold_plain(live, pairs) -> None:
    """dst[f] = src[f] where live[f] is False, in place, for every (dst,
    src) pair of F-led tensors: `where(live, new, old)` written into
    new."""
    for dst, src in pairs:
        if dst.dtype == torch.uint32:
            # torch's CPU `where` takes no uint32 (the keys): the same bits
            # as int32
            dst, src = dst.view(torch.int32), src.view(torch.int32)
        m = live.reshape((-1,) + (1,) * (dst.dim() - 1))
        dst.copy_(torch.where(m, dst, src))


def fleet_hold(live, pairs) -> int:
    """Holds the lanes where the bool [F] `live` is False (see
    `fleet_hold_plain`); the kernel is K32 `fleet_hold` in
    `csrc/fleet.cu`, one launch over a table of up to 96 leaves. Pairs
    whose dst is its src (a leaf the round passed on unchanged) and
    repeated dsts (the durable view's aliases of node leaves) are
    skipped. Returns the bytes a held lane copies."""
    seen, todo = set(), []
    for dst, src in pairs:
        if dst.data_ptr() == src.data_ptr() or dst.data_ptr() in seen:
            continue
        seen.add(dst.data_ptr())
        todo.append((dst, src))
    row = sum(d.numel() // max(d.shape[0], 1) * d.element_size()
              for d, _s in todo)
    if not todo:
        return 0
    if any(s.data_ptr() in seen for _d, s in todo):
        # the kernel reads every src while it writes the dsts
        raise ValueError("fleet_hold: a source is another pair's "
                         "destination")
    if not K.use_kernel(live):
        fleet_hold_plain(live, todo)
        return row
    F = live.shape[0]
    for dst, src in todo:
        if dst.shape != src.shape or dst.dtype != src.dtype \
                or dst.shape[0] != F or not dst.is_contiguous() \
                or not src.is_contiguous():
            raise ValueError(f"fleet_hold: leaves {tuple(dst.shape)} "
                             f"{dst.dtype} / {tuple(src.shape)} "
                             f"{src.dtype} for {F} lanes")
    live = live.contiguous()
    for lo in range(0, len(todo), _HOLD_LEAVES):
        part = todo[lo:lo + _HOLD_LEAVES]
        rbs = tuple(d.numel() // max(F, 1) * d.element_size()
                    for d, _s in part)
        off, rows, slice_ = hold_plan(rbs)
        K.FLEET_HOLD.launch(
            [live] + [t for pair in part for t in pair],
            [F, *rbs, *off, rows, slice_], live.device)
    return row


def append_replies_fleet_plain(log, cm: Msgs, seen, n_nodes: int, round_i,
                               k: int, k_max, stop, exit_k, live):
    """K5 over F lanes (the vmapped `append_replies` and `cond`): lane
    f's valid rows of cm [F, CW] go to its log row from rn[f] on (rows
    at rcap or beyond dropped), stamped round_i[f], with the payload of
    its own node row f * N + clip(src); rn[f] advances by every valid
    row; where go = k < k_max[f] & ~(stop[f] & any valid) & rn[f] + CW
    <= rcap fails, exit_k[f] takes k. Lanes not `live` append nothing.
    rn and exit_k are updated in place. Returns (live', n_live): the
    lanes live for the next round and their count."""
    rlog, rounds, plog, rn = log
    valid = cm.valid & live[:, None]
    CW, rcap = valid.shape[1], rounds.shape[1]
    total = valid.sum(dim=1, dtype=I32)
    pos = rn[:, None].long() + torch.cumsum(valid, 1) - valid.long()
    keep = valid & (pos < rcap)
    f_i, _j = torch.nonzero(keep, as_tuple=True)
    at = (f_i, pos[keep])
    for f in _LOG_FIELDS:
        getattr(rlog, f)[at] = getattr(cm, f)[keep]
    rounds[at] = round_i[f_i].to(I32)
    if plog is not None:
        node = f_i * n_nodes + cm.src[keep].clamp(0, n_nodes - 1).long()
        rows = seen[node]
        plog[at] = (rows if rows.dtype == I32
                    else pack_words(rows, plog.shape[2]))
    rn2 = rn + total
    go = (k < k_max) & ~(stop & (total > 0)) & (rn2 + CW <= rcap)
    exit_k.copy_(torch.where(live & ~go & (exit_k > k), k, exit_k))
    rn.copy_(rn2)
    live2 = live & go
    return live2, live2.sum(dtype=I32)


def append_replies_fleet(log, cm: Msgs, seen, n_nodes: int, round_i,
                         k: int, k_max, stop, exit_k, live):
    """Appends a round's client replies to every live lane's reply log
    and evaluates each lane's exit test (see
    `append_replies_fleet_plain`); the kernel is K5's fleet form
    `reply_log_fleet` in `csrc/fleet.cu`, one block a lane. `seen` is
    the lanes' [F * N, V] bool payload plane or [F * N, W] int32 rows,
    or None without payload."""
    if not K.use_kernel(cm.valid):
        return append_replies_fleet_plain(log, cm, seen, n_nodes, round_i,
                                          k, k_max, stop, exit_k, live)
    dev = cm.valid.device
    F, CW = cm.valid.shape
    for f in _LOG_FIELDS:
        t = getattr(cm, f)
        if tuple(t.shape) != (F, CW) or t.dtype != (
                torch.bool if f == "valid" else I32):
            raise ValueError(f"append_replies_fleet cm.{f}: "
                             f"{tuple(t.shape)} {t.dtype}")
    rlog, rounds, plog, rn = log
    rcap = rounds.shape[1]
    W = 0 if plog is None else plog.shape[2]
    rows_i32 = bool(W) and seen.dtype == I32
    V = seen.shape[1] if W else 0
    if W and (tuple(seen.shape[:1]) != (F * n_nodes,)
              or (seen.shape[1] != W if rows_i32 else
                  seen.dtype != torch.bool or V > 32 * W)):
        raise ValueError("append_replies_fleet: payload needs the [F * N, "
                         "V] bool plane, V <= 32 W, or [F * N, W] int32")
    live_out = torch.empty(F, dtype=torch.bool, device=dev)
    n_live = torch.empty((), dtype=I32, device=dev)
    K.REPLY_LOG_FLEET.launch(
        [getattr(cm, f).contiguous() for f in _LOG_FIELDS]
        + [getattr(rlog, f) for f in _LOG_FIELDS]
        + [rounds, plog, seen.contiguous() if W else None,
           round_i.contiguous(), rn, exit_k, k_max, stop, live.contiguous(),
           live_out, n_live],
        [F, CW, rcap, W, n_nodes, V, k, int(rows_i32)], dev)
    return live_out, n_live


def empty_fleet_log(F: int, rcap: int, W: int, device):
    """A fresh reply log a lane: (Msgs [F, rcap], rounds i32 [F, rcap],
    payload i32 [F, rcap, W] or None, rn i32 [F])."""
    plog = (torch.zeros((F, rcap, W), dtype=I32, device=device) if W
            else None)
    return (Msgs.empty((F, rcap), device),
            torch.zeros((F, rcap), dtype=I32, device=device), plog,
            torch.zeros(F, dtype=I32, device=device))


def _dense_t(t):
    return t if t.is_contiguous() else t.contiguous()


def _dense(program, sim: SimState) -> SimState:
    """`sim` with every leaf contiguous (the durable view rebuilt over the
    node leaves, so it aliases them as before)."""
    nodes = tree_map(_dense_t, sim.nodes)
    return sim.replace(net=tree_map(_dense_t, sim.net), nodes=nodes,
                       durable=program.durable_view(nodes))


def make_fleet_scan_fn(program, cfg: NetConfig, reply_cap: int = 256,
                       device="cuda", fetch=None):
    """fleet_fn(sim, inject [F, C], k_max [F], stop_on_reply [F], active
    [F]) -> (sim', cm, k [F], (rlog, rounds, plog, rn [F])): the JAX
    package's `make_fleet_scan_fn` (the scan vmapped over F lanes, one
    cluster a lane, `parallel.make_fleet_sims`' tree). Lane f runs exactly
    the rounds its own k_max, stop and reply-log room permit, as its
    standalone scan would: `inject[f]` in its first round, then
    injection-free rounds until the exit test fails (k its rounds, >=
    1). A lane with `active` False returns its input row, k 0 and rn 0.
    k_max, stop_on_reply and active are host values (numpy or lists);
    cm is each lane's last executed round's client messages (empty for
    a held lane).

    The lanes run in lockstep: round j is one cluster-axis round of all
    F lanes (`parallel.make_cluster_round_fn`), and K32 then holds the
    lanes not live in round j: every leaf of the carry (nodes, the net
    with its pool, counters and fault masks, the key, the durable view)
    reverts to its pre-round row, and the edge channels, which the round
    updates in place, to the rows a first K32 launch saved before the
    round. A held lane therefore keeps its state, key and channels bit
    for bit, and its later draws are its standalone run's. K5's fleet
    form appends each live lane's replies to its own log and sets its
    exit round. Per round K32 copies the held lanes' rows only: a held
    lane copies `fleet_fn.row_bytes` bytes a round (its channel rows
    twice, every other leaf's row once); a live row costs a flag read.

    The host reads the count of live lanes after every round when a
    live lane stops on replies, else once a chunk of SCAN_CHUNK rounds, and
    stops when none is live or the largest k_max is reached; rounds past
    every lane's exit are held whole. `fleet_fn.host_syncs` and
    `fleet_fn.rounds` (lockstep rounds run) count them: a dispatch holds
    F * rounds - sum(k) lane-rounds."""
    from .parallel import make_cluster_round_fn
    dev = resolve_device(device)
    T.check_scope(cfg)
    _check_program(program, cfg, dev)
    round_fn = make_cluster_round_fn(program, cfg, device=dev)
    rcap_req = max(1, int(reply_cap))
    W = int(getattr(program, "reply_payload_words", 0) or 0)
    N = cfg.n_nodes
    read = fetch or (lambda t: int(t))

    def carry_pairs(new: SimState, old: SimState):
        """(new, old) leaf pairs of every part of the carry but the
        channels."""
        pairs = []
        for part in ("net", "nodes", "key", "durable"):
            a, b = getattr(new, part), getattr(old, part)
            pairs += [(x, y) for (_p, x), (_q, y) in zip(leaves(a),
                                                         leaves(b))]
        return pairs

    scratch = {}

    def fleet_fn(sim: SimState, inject: Msgs, k_max, stop_on_reply,
                 active):
        F = sim.key.shape[0]
        act = np.asarray(active, bool).reshape(F)
        kmax_h = np.asarray(k_max, np.int64).reshape(F)
        stop_h = np.asarray(stop_on_reply, bool).reshape(F)
        k_max_t = torch.from_numpy(kmax_h.astype(np.int32)).to(dev)
        stop_t = torch.from_numpy(stop_h).to(dev)
        act_t = torch.from_numpy(act.copy()).to(dev)
        live = act_t
        exit_k = torch.full((F,), INT32_MAX, dtype=I32, device=dev)
        last = max(int(kmax_h[act].max()), 1) if act.any() else 0
        # a lane that stops on a reply may exit at any round: the count of
        # live lanes is read after every round (on a host-bound loop the
        # read costs the card's tail of the round, a round past every
        # exit a whole round); otherwise lanes exit at their k_max or a
        # full log, and it is read once a chunk
        cur, cm_prev, log = sim, None, None
        k, size = 0, 1 if (stop_h & act).any() else SCAN_CHUNK
        while k < last:
            n = min(size, last - k)
            for j in range(n):
                kk = k + j + 1
                ch_leaves = [t for _p, t in leaves(cur.channels)]
                shapes = tuple(tuple(t.shape) for t in ch_leaves)
                if shapes not in scratch:
                    scratch.clear()
                    scratch[shapes] = [torch.empty_like(t)
                                       for t in ch_leaves]
                saved = scratch[shapes]
                # the held lanes' channel rows, before the round moves
                # them in place
                row = fleet_hold(live, list(zip(saved, ch_leaves)))
                nxt, cm, _io = round_fn(cur, inject if kk == 1 else None)
                # K32 copies whole rows: the pool's scatters leave views
                nxt, cm = _dense(program, nxt), tree_map(_dense_t, cm)
                if cm_prev is None:
                    cm_prev = Msgs.empty(tuple(cm.valid.shape), dev)
                    log = empty_fleet_log(
                        F, max(rcap_req, 2 * cm.valid.shape[1]), W, dev)
                new_ch = [t for _p, t in leaves(nxt.channels)]
                fleet_fn.row_bytes = row + fleet_hold(
                    live, carry_pairs(nxt, cur) + list(zip(new_ch, saved))
                    + [(x, y) for (_p, x), (_q, y) in zip(leaves(cm),
                                                          leaves(cm_prev))])
                seen = None
                if W:
                    seen = program.reply_payload_plane(nxt.nodes)
                    seen = seen.reshape((F * N,) + tuple(seen.shape[2:]))
                live, n_live = append_replies_fleet(
                    log, cm, seen, N, nxt.net.round, kk, k_max_t, stop_t,
                    exit_k, live)
                cur, cm_prev = nxt, cm
            k += n
            fleet_fn.rounds += n
            if k >= last:
                break
            fleet_fn.host_syncs += 1
            if read(n_live) == 0:
                break
        k_out = torch.where(act_t, exit_k, 0)
        if log is None:             # no lane ran
            log = empty_fleet_log(F, rcap_req, W, dev)
            cm_prev = Msgs.empty((F, max(cfg.client_cap,
                                         2 * cfg.n_clients, 1)), dev)
        return cur, cm_prev, k_out, log

    fleet_fn.host_syncs = 0
    fleet_fn.rounds = 0
    fleet_fn.row_bytes = 0
    return fleet_fn
