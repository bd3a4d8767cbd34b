"""Batched PN-counter node (the workloads of `workloads/pn_counter.py`
and, through the non-negative generator, `workloads/g_counter.py`).

Counterpart of `maelstrom_tpu/nodes/pn_counter.py`, held against it by
`tests/test_torch_crdt.py`. Each node is an origin; the state is a pair
of per-origin contribution vectors `pos` / `neg` [N, M] (M = N origins)
merged by elementwise max, a PN-counter as two G-counters, plus per-edge
bits `pending` / `synced` [N, D, M]. A node's value is sum(pos) -
sum(neg) of its row.

Replication rides the static edge channels: a local add or a merge that
raises an origin queues it `pending` toward every edge (queueing back
toward the teaching edge acknowledges it); an arriving entry >= the
merged one sets `synced`, a change clears it; every `retry_rounds` the
unsynced nonzero origins are requeued, so lost entries are retransmitted
until both ends provably agree. Each edge sends the rotating top
`per_nb` pending origins a round. Reads are answered from the reply
payload, the node's value at the reply's round (one int32 word, K5's
int32 form).

`edge_step` has a hand-written CUDA kernel, K13 `pn_counter_step`
(`csrc/pn_counter.cu`), and the plain PyTorch version
`edge_step_plain`."""

from __future__ import annotations

import torch

from .. import kernels as K
from ..net.static import EdgeConfig, EdgeMsgs, reverse_index
from ..net.tpu import I32, wrap_i32
from ..tree import resolve_device
from ..workloads.broadcast import TOPOLOGIES, topology_indices
from .gset import gossip_topology_opts
from . import (NodeProgram, edge_capacity, edge_timing, freeze_step,
               register)

T_ADD = 10        # client -> node: a = delta
T_ADD_OK = 11
T_READ = 12
T_READ_OK = 13    # bare ack; the value rides the reply payload
T_ENTRY = 14      # edge: a = origin, b = pos count, c = neg count

# the order of the kernel's pointer arguments (struct StepArgs in
# csrc/pn_counter.cu)
_STATE = ("pos", "neg", "pending", "synced")
_EDGE = ("valid", "type", "a", "b", "c")
_CLIENT_IN = ("valid", "src", "due", "mid", "type", "a", "b", "c")
_CLIENT_OUT = ("valid", "src", "dest", "due", "mid", "reply_to", "type",
               "a", "b", "c")


@register
class PnCounterProgram(NodeProgram):
    name = "pn-counter"
    needs_state_reads = True
    is_edge = True
    tolerates_channel_overwrites = True   # entries retransmit until synced
    # lanes are decoded by message type across every slot: spill-safe
    edge_lanes_symmetric = True

    def __init__(self, opts, nodes, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        opts = gossip_topology_opts(opts, nodes)
        topo = (opts.get("topology_map")
                or TOPOLOGIES[opts["topology"]](nodes))
        nb = topology_indices(topo, nodes)
        self.neighbors = torch.tensor(nb, dtype=I32, device=self.device)
        self.rev = torch.tensor(reverse_index(nb), dtype=I32,
                                device=self.device)
        self.D = int(nb.shape[1])
        self.M = self.n_nodes                 # one origin per node
        self.per_nb = min(int(opts.get("gossip_per_neighbor", 4)), self.M)
        self.lanes = self.per_nb
        self.ring, self.retry_rounds, _lat = edge_timing(opts, len(nodes))
        self.inbox_cap = int(opts.get("inbox_cap", 4))
        self.outbox_cap = self.inbox_cap
        spill, chan_lanes, uniform = edge_capacity(opts, self)
        self.edge_cfg = EdgeConfig(n_nodes=self.n_nodes, degree=self.D,
                                   lanes=chan_lanes, ring=self.ring,
                                   spill=spill, uniform_arrival=uniform)
        # read completions take the counter value from the reply-round
        # payload (one word: sum(pos) - sum(neg) at the serving node)
        self.reply_payload_words = 1

    def init_state(self):
        N, D, M, dev = self.n_nodes, self.D, self.M, self.device

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return {"pos": z((N, M), I32), "neg": z((N, M), I32),
                "pending": z((N, D, M), torch.bool),
                "synced": z((N, D, M), torch.bool)}

    # --- plain version ----------------------------------------------------

    def edge_step_plain(self, state, edge_in: EdgeMsgs, client_in, round_):
        N, D, M, P = self.n_nodes, self.D, self.M, self.per_nb
        dev = edge_in.valid.device
        L = edge_in.valid.shape[2]   # channel lanes (>= out lanes)
        pos, neg = state["pos"], state["neg"]
        pending, synced = state["pending"], state["synced"]
        origins = torch.arange(M, dtype=I32, device=dev)
        edge_ok = (self.neighbors >= 0)[:, :, None]

        # client adds: own-origin contributions
        is_add = client_in.valid & (client_in.type == T_ADD)
        is_read = client_in.valid & (client_in.type == T_READ)
        deltas = torch.where(is_add, client_in.a, 0)
        dpos = wrap_i32(deltas.clamp(min=0).sum(dim=1))       # [N]
        dneg = wrap_i32((-deltas).clamp(min=0).sum(dim=1))
        eye = torch.eye(N, M, dtype=torch.bool, device=dev)
        pos = pos + torch.where(eye, dpos[:, None], 0)
        neg = neg + torch.where(eye, dneg[:, None], 0)
        local_changed = eye & ((dpos > 0) | (dneg > 0))[:, None]

        # merge arriving entries (elementwise max per origin)
        e_in = edge_in.valid & (edge_in.type == T_ENTRY)
        p_in = torch.full((N, D, M), -1, dtype=I32, device=dev)  # -1: none
        n_in = torch.full((N, D, M), -1, dtype=I32, device=dev)
        for lane in range(L):
            m = e_in[:, :, lane, None] & (
                edge_in.a[:, :, lane, None].clamp(0, M - 1) == origins)
            p_in = torch.maximum(p_in, torch.where(
                m, edge_in.b[:, :, lane, None], -1))
            n_in = torch.maximum(n_in, torch.where(
                m, edge_in.c[:, :, lane, None], -1))
        pos2 = torch.maximum(pos, p_in.amax(dim=1))
        neg2 = torch.maximum(neg, n_in.amax(dim=1))
        changed = (pos2 > pos) | (neg2 > neg) | local_changed

        # an entry >= our merged value proves this neighbour is current
        entry_arrived = p_in >= 0
        nb_ge = (entry_arrived & (p_in >= pos2[:, None, :])
                 & (n_in >= neg2[:, None, :]))
        synced_prev = synced
        synced = (synced & ~changed[:, None, :]) | nb_ge
        # queueing: teach changed origins, echo arriving entries of an
        # unsynced edge, requeue unsynced nonzero origins every
        # retry_rounds
        pend_teach = changed[:, None, :] & edge_ok & ~nb_ge
        pend_echo = entry_arrived & ~synced_prev & edge_ok
        nonzero = (pos2 > 0) | (neg2 > 0)
        requeue = torch.remainder(round_, self.retry_rounds) == 0
        pend_retry = requeue & (~synced & nonzero[:, None, :] & edge_ok)
        pending = (pending & ~nb_ge) | pend_teach | pend_echo | pend_retry

        # the rotating top_k per edge: scores made unique (lower index
        # first among equal priorities, as `jax.lax.top_k` orders ties),
        # so edges with fewer than per_nb pending origins fill their lanes
        # with the lowest-index others, as there
        rot = torch.remainder(origins - round_ * P, M)
        prio = torch.where(pending, M - rot, 0)
        score = prio.to(torch.int64) * M + (M - 1 - origins)
        topi = torch.topk(score, P, dim=-1).indices          # [N, D, P]
        sel = prio.gather(-1, topi) > 0
        pending = pending & ~torch.zeros_like(pending).scatter_(-1, topi,
                                                                sel)
        edge_out = EdgeMsgs(
            valid=sel & edge_ok,
            type=torch.full((N, D, P), T_ENTRY, dtype=I32, device=dev),
            a=topi.to(I32),
            b=pos2[:, None, :].expand(N, D, M).gather(-1, topi),
            c=neg2[:, None, :].expand(N, D, M).gather(-1, topi))

        client_out = client_in.replace(
            valid=is_add | is_read, dest=client_in.src,
            reply_to=client_in.mid,
            type=torch.where(is_add, T_ADD_OK,
                             torch.where(is_read, T_READ_OK, 0)).to(I32),
            a=torch.zeros_like(client_in.a))
        return ({"pos": pos2, "neg": neg2, "pending": pending,
                 "synced": synced}, edge_out, client_out)

    # --- kernel -----------------------------------------------------------

    def _edge_step_kernel(self, state, edge_in, client_in, round_, stall):
        N, D, M, P = self.n_nodes, self.D, self.M, self.per_nb
        dev = edge_in.valid.device
        L = edge_in.valid.shape[2]
        Kc = client_in.valid.shape[1]
        want = [(k, state[k], (N, M), I32) for k in ("pos", "neg")]
        want += [(k, state[k], (N, D, M), torch.bool)
                 for k in ("pending", "synced")]
        want += [(f"edge_in.{f}", getattr(edge_in, f), (N, D, L),
                  torch.bool if f == "valid" else I32) for f in _EDGE]
        want += [(f"client_in.{f}", getattr(client_in, f), (N, Kc),
                  torch.bool if f == "valid" else I32) for f in _CLIENT_IN]
        want += [("round", round_, (), I32)]
        if stall is not None:
            want.append(("stall", stall, (N,), torch.bool))
        for name, t, shape, dtype in want:
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"pn_counter_step {name}: {tuple(t.shape)}"
                                 f" {t.dtype}, expected {shape} {dtype}")
        new_state = {k: torch.empty_like(
            state[k], memory_format=torch.contiguous_format) for k in _STATE}
        edge_out = EdgeMsgs(**{f: torch.empty(
            (N, D, P), dtype=torch.bool if f == "valid" else I32,
            device=dev) for f in _EDGE})
        client_out = type(client_in)(**{f: torch.empty(
            (N, Kc), dtype=torch.bool if f == "valid" else I32, device=dev)
            for f in _CLIENT_OUT})
        K.PN_COUNTER_STEP.launch(
            [state[k].contiguous() for k in _STATE]
            + [getattr(edge_in, f).contiguous() for f in _EDGE]
            + [getattr(client_in, f).contiguous() for f in _CLIENT_IN]
            + [self.neighbors, round_,
               None if stall is None else stall.contiguous()]
            + [new_state[k] for k in _STATE]
            + [getattr(edge_out, f) for f in _EDGE]
            + [getattr(client_out, f) for f in _CLIENT_OUT],
            [N, D, M, L, Kc, P, self.retry_rounds], dev)
        return new_state, edge_out, client_out

    def edge_step(self, state, edge_in: EdgeMsgs, client_in, ctx):
        """(state, edge_in [N, D, L], client_in Msgs [N, K], ctx) ->
        (state', edge_out [N, D, per_nb], client_out Msgs [N, K]).
        ctx["round"] is an i32 scalar tensor; ctx.get("stall"), when
        given, the [N] bool mask of killed or paused nodes, which keep
        their state and emit no valid row."""
        stall = ctx.get("stall")
        if K.use_kernel(edge_in.valid):
            return self._edge_step_kernel(state, edge_in, client_in,
                                          ctx["round"], stall)
        return freeze_step(stall, state, *self.edge_step_plain(
            state, edge_in, client_in, ctx["round"]))

    def quiet_planes(self, state):
        """The planes of the JAX package's `quiescent` (idle when nothing
        is pending and every nonzero origin is synced on every edge), for
        the runner's fused quiescence probe (K6)."""
        nonzero = (state["pos"] > 0) | (state["neg"] > 0)
        unsynced = (~state["synced"] & nonzero[:, None, :]
                    & (self.neighbors >= 0)[:, :, None])
        return [state["pending"], unsynced]

    def reply_payload_plane(self, state):
        """[N, 1] int32: each node's value sum(pos) - sum(neg), wrapped as
        the JAX package's int32 sums wrap; the reply log copies the
        serving node's row (K5's int32 form)."""
        return wrap_i32(state["pos"].sum(dim=1)
                        - state["neg"].sum(dim=1))[:, None]

    def completion_payload(self, op, body, payload, intern):
        if body["type"] == "read_ok":
            return {**op, "type": "ok", "value": int(payload[0])}
        return {**op, "type": "ok"}

    # --- host boundary (the RPC surface of workload/pn_counter.clj) ---

    def request_for_op(self, op):
        if op["f"] == "add":
            return {"type": "add", "delta": op["value"]}
        return {"type": "read"}

    def encode_body(self, body, intern):
        if body["type"] == "add":
            return (T_ADD, int(body["delta"]), 0, 0)
        return (T_READ, 0, 0, 0)

    def decode_body(self, t, a, b, c, intern):
        if t == T_ADD_OK:
            return {"type": "add_ok"}
        if t == T_READ_OK:
            return {"type": "read_ok"}
        return super().decode_body(t, a, b, c, intern)


@register
class GCounterProgram(PnCounterProgram):
    """g-counter = pn-counter whose generator never emits negative deltas
    (reference `workload/g_counter.clj:13-14` reuses the pn-counter
    machinery the same way)."""
    name = "g-counter"
