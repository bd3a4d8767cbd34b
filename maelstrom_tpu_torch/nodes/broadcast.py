"""Batched broadcast node: partition-tolerant gossip over a topology.

Counterpart of `maelstrom_tpu/nodes/broadcast.py`, held against it by
`tests/test_torch_broadcast.py`. Gossip and acknowledgements move over the
static edge channels; only client RPCs touch the flight pool.

Per round, for all N nodes at once: new values (from clients or arriving
gossip) are marked `seen` and queued `pending` toward every neighbour
except the edge they arrived on; each edge sends up to
`gossip_per_neighbor` pending values, the selection window rotating by
round; a seen-digest (64 bits of the sender's `seen`) is owed on an edge
whenever gossip arrives on it, and receiving one clears pending/inflight
for every covered value the neighbour holds. Unacknowledged values are
requeued by a two-generation retry tick. Eager mode resends pending values
every round until a digest clears them; naive mode forwards each new value
once per edge with no digests.

Killed and paused nodes (`ctx["stall"]`) keep their state and send
nothing: the JAX round's freeze (`sim._freeze`), which the kernel folds
into the step. On the cluster axis `step_rows` steps the F * N node rows
of F clusters at once (one cluster's neighbour table read at row % N,
each cluster's own round at row // N), as Raft's does.

`edge_step` has a hand-written CUDA kernel (`csrc/broadcast.cu`) and the
plain PyTorch version `edge_step_plain`."""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels as K
from ..net.static import EdgeConfig, EdgeMsgs, reverse_index
from ..net.tpu import I32
from ..sim import pack_words
from ..tree import resolve_device
from ..workloads.broadcast import TOPOLOGIES, topology_indices
from . import (EncodeCapacityError, NodeProgram, edge_capacity, edge_timing,
               freeze_step, register)

T_BCAST = 10      # client -> node: a = value index
T_BCAST_OK = 11
T_READ = 12
T_READ_OK = 13    # ack; b|c carry the seen bitmap when V <= 64
T_GOSSIP = 14     # edge: a = value index
T_DIGEST = 15     # edge: a = window, b|c = 64 seen bits of that window

# the order of the kernel's pointer arguments (struct StepArgs in
# csrc/broadcast.cu)
_STATE = ("seen", "pending", "inflight", "inflight_old", "owed")
_EDGE = ("valid", "type", "a", "b", "c")
_CLIENT_IN = ("valid", "src", "due", "mid", "type", "a", "b", "c")
_CLIENT_OUT = ("valid", "src", "dest", "due", "mid", "reply_to", "type",
               "a", "b", "c")


def _cat_zeros(x, width):
    """Pads the last axis of `x` with `width` zeros."""
    if width == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (width,))], dim=-1)


@register
class BroadcastProgram(NodeProgram):
    name = "broadcast"
    needs_state_reads = True
    is_edge = True
    edge_lanes_symmetric = True

    def __init__(self, opts, nodes, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        topo = (opts.get("topology_map")
                or TOPOLOGIES[opts.get("topology", "grid")](nodes))
        nb = topology_indices(topo, nodes)
        self.neighbors = torch.tensor(nb, dtype=I32, device=self.device)
        self.rev = torch.tensor(reverse_index(nb), dtype=I32,
                                device=self.device)
        self.D = int(nb.shape[1])
        self.V = int(opts.get("max_values", 1024))
        self.n_windows = (self.V + 63) // 64
        self.Vp = self.n_windows * 64
        self.per_nb = min(int(opts.get("gossip_per_neighbor", 4)), self.V)
        self.eager_resend = bool(opts.get("eager_resend", False))
        self.naive = bool(opts.get("naive_broadcast", False))
        self.skip_sender = bool(opts.get("skip_sender", True))
        self.tolerates_channel_overwrites = not self.naive
        self.lanes = self.per_nb + (0 if self.naive else 1)  # +digest lane
        self.ring, retry, _lat = edge_timing(opts, len(nodes))
        self.retry_rounds = retry + self.n_windows
        self.inbox_cap = int(opts.get("inbox_cap", 4))   # client RPCs only
        self.outbox_cap = self.inbox_cap
        self.reply_payload_words = self.n_windows * 2
        spill, chan_lanes, uniform = edge_capacity(opts, self)
        self.edge_cfg = EdgeConfig(n_nodes=self.n_nodes, degree=self.D,
                                   lanes=chan_lanes, ring=self.ring,
                                   spill=spill, uniform_arrival=uniform)

    def init_state(self):
        N, D, V, dev = self.n_nodes, self.D, self.V, self.device

        def z(*shape):
            return torch.zeros(shape, dtype=torch.bool, device=dev)
        return {"seen": z(N, V), "pending": z(N, D, V),
                "inflight": z(N, D, V), "inflight_old": z(N, D, V),
                "owed": z(N, D, self.n_windows)}

    # --- plain version ----------------------------------------------------

    def _select_gossip(self, pending, round_):
        """Up to `per_nb` pending values per edge, taken in cyclic order
        from `(round * per_nb) % V`: the rotating `top_k` of the JAX
        version. Scores are made unique (lower index first among equal
        priorities, as `jax.lax.top_k` orders ties), so the slots where
        fewer than `per_nb` values are pending hold the lowest-index
        non-pending values, as there. Returns (sel, topi, sent)."""
        V = self.V
        vee = torch.arange(V, dtype=I32, device=pending.device)
        rot = torch.remainder(vee - round_ * self.per_nb, V)
        prio = torch.where(pending, V - rot, 0)
        score = prio.to(torch.int64) * V + (V - 1 - vee)
        topi = torch.topk(score, self.per_nb, dim=-1).indices
        sel = prio.gather(-1, topi) > 0
        sent = torch.zeros_like(pending).scatter_(-1, topi, sel)
        return sel, topi.to(I32), sent

    def _digest_known(self, edge_in: EdgeMsgs):
        """[N, D, V] values each edge's neighbour has proven it holds; the
        last digest lane of an edge wins."""
        V = self.V
        R, D, L = edge_in.valid.shape
        vee = torch.arange(V, dtype=I32, device=edge_in.valid.device)
        d_in = edge_in.valid & (edge_in.type == T_DIGEST)
        has_digest = d_in.any(dim=2)

        def lane_pick(field):
            out = torch.zeros((R, D), dtype=I32, device=field.device)
            for lane in range(L):
                out = torch.where(d_in[:, :, lane], field[:, :, lane], out)
            return out
        w_in = lane_pick(edge_in.a)
        b_in, c_in = lane_pick(edge_in.b), lane_pick(edge_in.c)
        j = vee - w_in[:, :, None] * 64
        in_window = (j >= 0) & (j < 64)
        bit = torch.where(j < 32,
                          (b_in[:, :, None] >> j.clamp(0, 31)) & 1,
                          (c_in[:, :, None] >> (j - 32).clamp(0, 31)) & 1)
        return has_digest[:, :, None] & in_window & (bit == 1)

    def _digest_out(self, seen, owed, arrived):
        """Owes the windows gossip arrived in and pays the lowest owed
        window per edge. Returns (owed', have_owed, w_send, b_out,
        c_out)."""
        D, W = self.D, self.n_windows
        arrived_pad = _cat_zeros(arrived, self.Vp - self.V)
        owed = owed | arrived_pad.reshape(-1, D, W, 64).any(dim=3)
        have_owed = owed.any(dim=2)
        www = torch.arange(W, dtype=I32, device=owed.device)
        w_send = torch.argmax(owed.to(I32) * (W - www), dim=2)
        owed = owed & ~(have_owed[:, :, None] & (w_send[:, :, None] == www))
        words = self._pack_seen_words(seen)                 # [N, 2W]
        b_out = words[:, 0::2].gather(1, w_send)
        c_out = words[:, 1::2].gather(1, w_send)
        return owed, have_owed, w_send.to(I32), b_out, c_out

    def edge_step_plain(self, state, edge_in: EdgeMsgs, client_in, round_,
                        neighbors=None):
        """The step of N node rows (or on the cluster axis R = F * N rows
        with `neighbors` their [R, D] table and `round_` an [R, 1, 1]
        column of their clusters' rounds)."""
        D, V = self.D, self.V
        N = state["seen"].shape[0]
        dev = edge_in.valid.device
        L = edge_in.valid.shape[2]
        seen, pending = state["seen"], state["pending"]
        inflight = state["inflight"]
        vee = torch.arange(V, dtype=I32, device=dev)
        edge_ok = (self.neighbors if neighbors is None else neighbors) >= 0

        g_in = edge_in.valid & (edge_in.type == T_GOSSIP)
        gv = edge_in.a.clamp(0, V - 1)
        arrived = torch.zeros((N, D, V), dtype=torch.bool, device=dev)
        for lane in range(L):
            arrived |= g_in[:, :, lane, None] & (gv[:, :, lane, None] == vee)

        Kc = client_in.valid.shape[1]
        is_cb = client_in.valid & (client_in.type == T_BCAST)
        is_read = client_in.valid & (client_in.type == T_READ)
        cv = client_in.a.clamp(0, V - 1)
        cb = torch.zeros((N, V), dtype=torch.bool, device=dev)
        for k in range(Kc):
            cb |= is_cb[:, k, None] & (cv[:, k, None] == vee)

        arr_any = arrived.any(dim=1)
        new = (arr_any | cb) & ~seen
        seen = seen | arr_any | cb

        zero = torch.zeros_like(client_in.a)
        client_out = client_in.replace(
            valid=is_cb | is_read, dest=client_in.src,
            reply_to=client_in.mid,
            type=torch.where(is_cb, T_BCAST_OK,
                             torch.where(is_read, T_READ_OK, 0)).to(I32),
            a=zero)
        if self.V <= 64:
            words = self._pack_seen_words(seen)
            client_out = client_out.replace(
                b=torch.where(is_read, words[:, 0][:, None], 0),
                c=torch.where(is_read, words[:, 1][:, None], 0))

        P = self.per_nb
        if self.naive:
            first_arrival = arrived & (
                torch.cumsum(arrived, dim=1, dtype=I32) == 1)
            pending = pending | (new[:, None, :] & edge_ok[:, :, None])
            if self.skip_sender:
                pending = pending & ~first_arrival
            sel, topi, sent = self._select_gossip(pending, round_)
            pending = pending & ~sent
            z = torch.zeros((N, D, P), dtype=I32, device=dev)
            edge_out = EdgeMsgs(valid=sel & edge_ok[:, :, None],
                                type=torch.full_like(z, T_GOSSIP), a=topi,
                                b=z, c=z.clone())
            return ({**state, "seen": seen, "pending": pending},
                    edge_out, client_out)

        known = arrived | self._digest_known(edge_in)
        inflight_old = state["inflight_old"]
        requeue = torch.remainder(round_, self.retry_rounds) == 0
        pending = ((pending | (new[:, None, :] & edge_ok[:, :, None])
                    | (inflight_old & requeue)) & ~known)
        inflight_old = torch.where(requeue, inflight, inflight_old) & ~known
        inflight = inflight & ~known & ~requeue
        sel, topi, sent = self._select_gossip(pending, round_)
        if not self.eager_resend:
            pending = pending & ~sent
            inflight = inflight | sent
        owed, have_owed, w_send, b_out, c_out = self._digest_out(
            seen, state["owed"], arrived)

        z = torch.zeros((N, D, P), dtype=I32, device=dev)
        edge_out = EdgeMsgs(
            valid=torch.cat([(have_owed & edge_ok)[:, :, None],
                             sel & edge_ok[:, :, None]], dim=2),
            type=torch.cat([torch.full((N, D, 1), T_DIGEST, dtype=I32,
                                       device=dev),
                            torch.full_like(z, T_GOSSIP)], dim=2),
            a=torch.cat([w_send[:, :, None], topi], dim=2),
            b=torch.cat([b_out[:, :, None], z], dim=2),
            c=torch.cat([c_out[:, :, None], z], dim=2))
        return ({"seen": seen, "pending": pending, "inflight": inflight,
                 "inflight_old": inflight_old, "owed": owed},
                edge_out, client_out)

    # --- kernel -----------------------------------------------------------

    def _check_inputs(self, state, edge_in, client_in, round_):
        """N node rows with a scalar round, or F * N rows of F clusters
        with an [F] round."""
        D, V, W = self.D, self.V, self.n_windows
        N = state["seen"].shape[0]
        L = edge_in.valid.shape[2]
        Kc = client_in.valid.shape[1]
        F = N // self.n_nodes
        rshape = () if round_.dim() == 0 else (F,)
        if N % self.n_nodes or (rshape == () and N != self.n_nodes):
            raise ValueError(f"edge_step: {N} node rows for "
                             f"{self.n_nodes}-node clusters")
        want = [("seen", state["seen"], (N, V), torch.bool),
                ("owed", state["owed"], (N, D, W), torch.bool),
                ("round", round_, rshape, I32)]
        want += [(k, state[k], (N, D, V), torch.bool)
                 for k in ("pending", "inflight", "inflight_old")]
        want += [(f"edge_in.{f}", getattr(edge_in, f), (N, D, L),
                  torch.bool if f == "valid" else I32) for f in _EDGE]
        want += [(f"client_in.{f}", getattr(client_in, f), (N, Kc),
                  torch.bool if f == "valid" else I32) for f in _CLIENT_IN]
        for name, t, shape, dtype in want:
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"edge_step {name}: {tuple(t.shape)} "
                                 f"{t.dtype}, expected {shape} {dtype}")

    def _edge_step_kernel(self, state, edge_in, client_in, round_,
                          stall=None):
        self._check_inputs(state, edge_in, client_in, round_)
        N, D = state["seen"].shape[0], self.D
        if stall is not None and (tuple(stall.shape) != (N,)
                                  or stall.dtype != torch.bool):
            raise ValueError(f"edge_step stall: {tuple(stall.shape)} "
                             f"{stall.dtype}")
        dev = edge_in.valid.device
        L = edge_in.valid.shape[2]
        Kc = client_in.valid.shape[1]
        Lout = self.lanes

        def like(t):
            return torch.empty_like(t, memory_format=torch.contiguous_format)
        if self.naive:   # inflight, inflight_old and owed pass unchanged
            new_state = {**state, "seen": like(state["seen"]),
                         "pending": like(state["pending"])}
        else:
            new_state = {k: like(state[k]) for k in _STATE}
        edge_out = EdgeMsgs(
            valid=torch.empty((N, D, Lout), dtype=torch.bool, device=dev),
            **{f: torch.empty((N, D, Lout), dtype=I32, device=dev)
               for f in _EDGE[1:]})
        client_out = type(client_in)(**{
            f: torch.empty((N, Kc), dtype=torch.bool if f == "valid"
                           else I32, device=dev) for f in _CLIENT_OUT})
        ptrs = ([state[k].contiguous() for k in _STATE]
                + [getattr(edge_in, f).contiguous() for f in _EDGE]
                + [getattr(client_in, f).contiguous() for f in _CLIENT_IN]
                + [self.neighbors, round_]
                + [new_state[k] for k in _STATE]
                + [getattr(edge_out, f) for f in _EDGE]
                + [getattr(client_out, f) for f in _CLIENT_OUT])
        kernel = K.BROADCAST_STEP
        if stall is not None:
            kernel = K.BROADCAST_STEP_STALL
            ptrs.append(stall.contiguous())
        kernel.launch(
            ptrs, [N, D, self.V, self.n_windows, L, Kc, Lout, self.per_nb,
                   self.retry_rounds, int(self.naive),
                   int(self.skip_sender), int(self.eager_resend),
                   0 if round_.dim() == 0 else self.n_nodes], dev)
        return new_state, edge_out, client_out

    def step_rows(self, state, edge_in, client_in, rnd, keys, stall=None):
        """One gossip step of R = F * N node rows of F clusters (the
        cluster axis, JAX's `vmap` of `edge_step`): `rnd` the clusters'
        [F] rounds, `keys` their [F, 2] program keys (the gossip draws
        nothing), `stall` the [R] bool mask of killed or paused rows,
        which keep their state and send nothing. K3, with and without the
        stall mask, over the rows."""
        if K.use_kernel(edge_in.valid):
            return self._edge_step_kernel(state, edge_in, client_in, rnd,
                                          stall)
        F = rnd.shape[0]
        rows_round = rnd.repeat_interleave(self.n_nodes)[:, None, None]
        return freeze_step(stall, state, *self.edge_step_plain(
            state, edge_in, client_in, rows_round,
            self.neighbors.repeat(F, 1)))

    def edge_step(self, state, edge_in: EdgeMsgs, client_in, ctx):
        """(state, edge_in [N, D, L], client_in Msgs [N, K], ctx) ->
        (state', edge_out [N, D, lanes], client_out Msgs [N, K]).
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
        """The bool planes of the JAX package's `quiescent` (idle when no
        value awaits digest confirmation: no byte set in any), for the
        runner's fused quiescence probe (kernel K6)."""
        return [state["pending"], state["inflight"], state["inflight_old"]]

    def reply_payload_plane(self, state):
        """The [N, V] bool plane whose packed words (`reply_payload`) the
        scan's reply log snapshots (kernel K5)."""
        return state["seen"]

    def _pack_seen_words(self, rows):
        """[..., V] bool rows -> [..., n_windows*2] i32 (`sim.pack_words`,
        the layout K3 and K5 write)."""
        return pack_words(rows, self.n_windows * 2)

    def reply_payload(self, state, node_idx):
        """[M] node indices -> [M, W] i32: the nodes' seen bitmaps."""
        return self._pack_seen_words(state["seen"][node_idx])

    def completion_payload(self, op, body, payload, intern):
        if body["type"] == "read_ok":
            words = np.asarray(payload, dtype=np.uint32)
            vals = []
            for w in range(len(words)):
                bits = int(words[w])
                base = w * 32
                while bits:
                    b = bits & -bits
                    vals.append(base + b.bit_length() - 1)
                    bits ^= b
            return {**op, "type": "ok",
                    "value": [intern.value(v) for v in vals if v < self.V]}
        return {**op, "type": "ok"}

    # --- host boundary ---

    def request_for_op(self, op):
        if op["f"] == "broadcast":
            return {"type": "broadcast", "message": op["value"]}
        return {"type": "read"}

    def encode_body(self, body, intern):
        if body["type"] == "broadcast":
            i = intern.peek(body["message"])
            if i is None:
                if len(intern) >= self.V:
                    raise EncodeCapacityError(
                        f"broadcast value table full ({self.V}); raise "
                        f"--max-values")
                i = intern.id(body["message"])
            return (T_BCAST, i, 0, 0)
        return (T_READ, 0, 0, 0)

    def decode_body(self, t, a, b, c, intern):
        if t == T_BCAST_OK:
            return {"type": "broadcast_ok"}
        if t == T_READ_OK:
            return {"type": "read_ok"}
        return super().decode_body(t, a, b, c, intern)

    def completion(self, op, body, read_state, intern):
        if body["type"] == "read_ok":
            seen_row = np.asarray(read_state()["seen"])
            return {**op, "type": "ok",
                    "value": [intern.value(int(i))
                              for i in np.nonzero(seen_row)[0]]}
        return {**op, "type": "ok"}
