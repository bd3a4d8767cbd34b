"""Batched atomic broadcast: distilled client batches on the wire.

Counterpart of `maelstrom_tpu/nodes/broadcast_batched.py` (the Chop
Chop-shaped sibling of the broadcast node, arxiv 2304.07081), held
against it by `tests/test_torch_broadcast_batched.py`. A client batch is
one contiguous id range `[lo, lo + n)` with an arithmetic checksum, and
ONE message (`T_BATCH`) carries it. The node expands it and acks with an
expansion proof: the count of ids it marked and the checksum it
recomputed from its own expansion (`sum(ids)` as a wrapping int32 sum,
mod 2^31 - 1). Gossip lanes carry maximal runs of pending ids
(`T_GRANGE`), so a contiguous backlog crosses an edge in one message.

Acknowledgement between nodes is the broadcast seen-digest protocol
unchanged (`BroadcastProgram._digest_known` / `_digest_out`), with its
retry ticks and eager resend. The program declares `unit_words`, so the
net books client-op units beside messages (`net/tpu.py`,
`payload_units`). The read reply `T_BREAD_OK` is a bare ack whose seen
set rides the reply payload (kernel K5), as the parent's does.

`edge_step` has a hand-written CUDA kernel (K15, `csrc/broadcast_batched.cu`)
and the plain PyTorch version `edge_step_plain`. Under the byzantine
adversary the culprit's T_BATCH_OK acks are the forged-proof surface
(`byz_wire_edge`, rewritten in the round by K31), and the expansion-proof
audit convicts (`checkers/set_full.py`)."""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels as K
from ..byzantine import EdgeWire, byz_enabled
from ..checkers.set_full import PROOF_MOD, range_checksum
from ..net.static import EdgeMsgs
from ..net.tpu import I32, wrap_i32
from . import EncodeCapacityError, freeze_step, register
from .broadcast import (_CLIENT_IN, _CLIENT_OUT, _EDGE, _STATE,
                        BroadcastProgram, T_DIGEST)

__all__ = ["BroadcastBatchedProgram", "PROOF_MOD", "batched_plan",
           "range_checksum"]

T_BATCH = 20       # client -> node: a = lo, b = n, c = claim checksum
T_BATCH_OK = 21    # node -> client: a = lo, b = expanded count,
#                    c = server-recomputed checksum (the expansion proof)
T_BREAD = 22
T_BREAD_OK = 23    # bare ack; set materialized from the reply payload
T_GRANGE = 24      # edge gossip: a = lo, b = n (a run of value ids)

# K15's launch (csrc/broadcast_batched.cu): warps a block, values a tile
# of a row that takes the whole warp, and the block's shared memory (two
# 512-bit tile masks a warp)
K15_WARPS = 8
K15_TILE = 512
K15_SMEM = K15_WARPS * 2 * (K15_TILE // 8)


def batched_plan(N: int, D: int, V: int) -> dict:
    """K15's launch plan for N nodes of D edges and V values: P lanes a
    row, the fewest 16-byte lanes that cover V + 15 bytes (a row on any
    16-byte offset), up to 32, so 32 / P rows share a warp; past 497
    values a row takes the warp in tiles of 512 values (`tiles` at most,
    by the row's offset). The edge rows' warps come first, then the node
    rows'. The kernel checks P and the warp counts."""
    P = 1
    while P < 32 and 16 * P < V + 15:
        P *= 2
    rows = 32 // P
    edge_warps = -(-N * D // rows)
    node_warps = -(-N // rows)
    return {"P": P, "rows_per_warp": rows,
            "tiles": -(-(V + 15) // K15_TILE) if 16 * P < V + 15 else 1,
            "edge_warps": edge_warps, "node_warps": node_warps,
            "blocks": -(-(edge_warps + node_warps) // K15_WARPS),
            "smem_bytes": K15_SMEM}


@register
class BroadcastBatchedProgram(BroadcastProgram):
    name = "broadcast-batched"

    def __init__(self, opts, nodes, device="cuda"):
        opts = dict(opts)
        # batches always retransmit until digest-acked
        opts["naive_broadcast"] = False
        # `gossip_per_neighbor` counts RANGES per edge per round here
        opts.setdefault("gossip_per_neighbor", 2)
        super().__init__(opts, nodes, device=device)
        # batch rows carry their client-op count in payload word b
        # (0 = a, 1 = b, 2 = c): the net books units beside messages
        self.unit_words = ((T_BATCH, 1), (T_BATCH_OK, 1), (T_GRANGE, 1))
        # the largest run one CLIENT batch record may claim (--batch-max);
        # gossip ranges are not capped by it
        self.max_batch = min(int(opts.get("batch_max") or self.V), self.V)
        # the forged-proof surface, only with the adversary in the fault
        # set
        self.byz = byz_enabled(opts)

    def byz_wire_edge(self):
        """The edge-path corruption surface (`byzantine.corrupt_edge`,
        K31), or None without the adversary: the culprit node lies about
        its expansion, the count inflated on odd rounds and the checksum
        forged on even ones. Both are definite `verify_batch_proofs`
        failures, and the honest `lo` keeps the record paired with its
        invoke."""
        return EdgeWire(T_BATCH_OK) if self.byz else None

    # --- plain version ----------------------------------------------------

    def _select_ranges(self, pending):
        """Per-edge maximal-run extraction: up to `per_nb` runs of
        contiguous pending value ids, first run first. Returns (lanes
        [(has, lo, n)], sent [N, D, V]). An edge with nothing left gives
        has False, lo 0 and n 0 (the argmax of all-false)."""
        V = self.V
        vee = torch.arange(V, dtype=I32, device=pending.device)
        rem = pending
        sent = torch.zeros_like(pending)
        lanes = []
        for _ in range(self.per_nb):
            has = rem.any(dim=2)
            lo = torch.where(has, torch.where(rem, vee, V).amin(dim=2), 0)
            after = vee >= lo[:, :, None]
            first_brk = torch.where(after & ~rem, vee, V).amin(dim=2)
            n = (first_brk - lo).clamp(0, V)
            n = torch.where(has, n.clamp(min=1), 0)
            mask = (after & (vee < (lo + n)[:, :, None])
                    & has[:, :, None])
            lanes.append((has, lo.to(I32), n.to(I32)))
            rem = rem & ~mask
            sent = sent | mask
        return lanes, sent

    def edge_step_plain(self, state, edge_in: EdgeMsgs, client_in, round_):
        N, D, V = self.n_nodes, self.D, self.V
        dev = edge_in.valid.device
        L = edge_in.valid.shape[2]
        seen, pending = state["seen"], state["pending"]
        inflight = state["inflight"]
        vee = torch.arange(V, dtype=I32, device=dev)
        edge_ok = self.neighbors >= 0

        # range-gossip arrivals: [lo, lo + n) per lane
        g_in = edge_in.valid & (edge_in.type == T_GRANGE)
        glo = edge_in.a.clamp(0, V)
        gn = edge_in.b.clamp(0, V)
        arrived = torch.zeros((N, D, V), dtype=torch.bool, device=dev)
        for lane in range(L):
            arrived |= (g_in[:, :, lane, None]
                        & (vee >= glo[:, :, lane, None])
                        & (vee < (glo + gn)[:, :, lane, None]))

        # client batches: expand, and prove the expansion
        Kc = client_in.valid.shape[1]
        is_batch = client_in.valid & (client_in.type == T_BATCH)
        is_read = client_in.valid & (client_in.type == T_BREAD)
        blo = client_in.a.clamp(0, V)
        bn = client_in.b.clamp(0, V)
        cb = torch.zeros((N, V), dtype=torch.bool, device=dev)
        cnts, sums = [], []
        for k in range(Kc):
            m = ((vee[None, :] >= blo[:, k, None])
                 & (vee[None, :] < (blo + bn)[:, k, None]))
            cb |= is_batch[:, k, None] & m
            cnts.append(m.sum(dim=1, dtype=I32))
            # JAX's int32 sum of the ids wraps; then the floor mod
            s = wrap_i32((vee.to(torch.int64)[None, :] * m).sum(dim=1))
            sums.append(torch.remainder(s, PROOF_MOD).to(I32))
        exp_cnt = torch.stack(cnts, dim=1)
        exp_sum = torch.stack(sums, dim=1)

        arr_any = arrived.any(dim=1)
        new = (arr_any | cb) & ~seen
        seen = seen | arr_any | cb

        # client replies: batch acks carry the expansion proof
        reply_type = torch.where(is_batch, T_BATCH_OK,
                                 torch.where(is_read, T_BREAD_OK, 0))
        client_out = client_in.replace(
            valid=is_batch | is_read, dest=client_in.src,
            reply_to=client_in.mid, type=reply_type.to(I32),
            a=torch.where(is_batch, client_in.a, 0),
            b=torch.where(is_batch, exp_cnt, 0),
            c=torch.where(is_batch, exp_sum, 0))

        # digest receive and retry bookkeeping (the parent protocol)
        known = arrived | self._digest_known(edge_in)
        inflight_old = state["inflight_old"]
        requeue = torch.remainder(round_, self.retry_rounds) == 0
        pending = ((pending | (new[:, None, :] & edge_ok[:, :, None])
                    | (inflight_old & requeue)) & ~known)
        inflight_old = torch.where(requeue, inflight, inflight_old) & ~known
        inflight = inflight & ~known & ~requeue

        lanes, sent = self._select_ranges(pending)
        if not self.eager_resend:
            pending = pending & ~sent
            inflight = inflight | sent

        owed, have_owed, w_send, b_out, c_out = self._digest_out(
            seen, state["owed"], arrived)

        # edge output: the digest on lane 0, ranges on lanes 1..per_nb
        P = self.per_nb
        ok = edge_ok[:, :, None]
        edge_out = EdgeMsgs(
            valid=torch.cat([(have_owed & edge_ok)[:, :, None]]
                            + [h[:, :, None] & ok for h, _l, _n in lanes],
                            dim=2),
            type=torch.cat([torch.full((N, D, 1), T_DIGEST, dtype=I32,
                                       device=dev),
                            torch.full((N, D, P), T_GRANGE, dtype=I32,
                                       device=dev)], dim=2),
            a=torch.cat([w_send[:, :, None]]
                        + [lo[:, :, None] for _h, lo, _n in lanes], dim=2),
            b=torch.cat([b_out[:, :, None]]
                        + [n[:, :, None] for _h, _l, n in lanes], dim=2),
            c=torch.cat([c_out[:, :, None],
                         torch.zeros((N, D, P), dtype=I32, device=dev)],
                        dim=2))
        return ({"seen": seen, "pending": pending, "inflight": inflight,
                 "inflight_old": inflight_old, "owed": owed},
                edge_out, client_out)

    # --- kernel -----------------------------------------------------------

    def _edge_step_kernel(self, state, edge_in, client_in, round_,
                          stall=None):
        self._check_inputs(state, edge_in, client_in, round_)
        if stall is not None and (tuple(stall.shape) != (self.n_nodes,)
                                  or stall.dtype != torch.bool):
            raise ValueError(f"edge_step stall: {tuple(stall.shape)} "
                             f"{stall.dtype}")
        N, D = self.n_nodes, self.D
        dev = edge_in.valid.device
        L = edge_in.valid.shape[2]
        Kc = client_in.valid.shape[1]
        Lout = self.lanes

        def like(t):
            return torch.empty_like(t, memory_format=torch.contiguous_format)
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
        kernel = K.BROADCAST_BATCHED_STEP
        if stall is not None:
            kernel = K.BROADCAST_BATCHED_STEP_STALL
            ptrs.append(stall.contiguous())
        plan = batched_plan(N, D, self.V)
        kernel.launch(
            ptrs, [N, D, self.V, self.n_windows, L, Kc, Lout, self.per_nb,
                   self.retry_rounds, int(self.eager_resend), plan["P"],
                   plan["edge_warps"], plan["node_warps"]], dev)
        return new_state, edge_out, client_out

    def edge_step(self, state, edge_in: EdgeMsgs, client_in, ctx):
        """(state, edge_in [N, D, L], client_in Msgs [N, K], ctx) ->
        (state', edge_out [N, D, 1 + per_nb], client_out Msgs [N, K]).
        ctx["round"] is an i32 scalar tensor; ctx.get("stall"), when
        given, the [N] bool mask of killed or paused nodes, which keep
        their state and emit no valid row."""
        stall = ctx.get("stall")
        if K.use_kernel(edge_in.valid):
            return self._edge_step_kernel(state, edge_in, client_in,
                                          ctx["round"], stall)
        return freeze_step(stall, state, *self.edge_step_plain(
            state, edge_in, client_in, ctx["round"]))

    # --- host boundary ---

    def request_for_op(self, op):
        if op["f"] == "broadcast-batch":
            return {"type": "batch", "values": list(op["value"])}
        return {"type": "read"}

    def encode_body(self, body, intern):
        if body["type"] == "batch":
            vals = body["values"]
            if not vals:
                raise EncodeCapacityError("empty distilled batch")
            ids = []
            for v in vals:
                i = intern.peek(v)
                if i is None:
                    if len(intern) >= self.V:
                        raise EncodeCapacityError(
                            f"broadcast value table full ({self.V}); "
                            f"raise --max-values")
                    i = intern.id(v)
                ids.append(i)
            n = len(ids)
            lo = min(ids)
            # the distiller's contract: a batch is deduped and its ids
            # form one contiguous run; a violation fails the op
            if len(set(ids)) != n:
                raise EncodeCapacityError(
                    "duplicate value inside a distilled batch")
            if sorted(ids) != list(range(lo, lo + n)) or n > self.max_batch:
                raise EncodeCapacityError(
                    f"distilled batch ids not one contiguous run of <= "
                    f"{self.max_batch} (got {n} ids from {lo})")
            return (T_BATCH, lo, n, range_checksum(lo, n))
        return (T_BREAD, 0, 0, 0)

    def decode_body(self, t, a, b, c, intern):
        if t == T_BATCH_OK:
            return {"type": "batch_ok", "lo": int(a), "n": int(b),
                    "proof": int(c)}
        if t == T_BREAD_OK:
            return {"type": "read_ok"}
        return super(BroadcastProgram, self).decode_body(t, a, b, c,
                                                         intern)

    def completion_payload(self, op, body, payload, intern):
        if body["type"] == "batch_ok":
            lo, n = body["lo"], body["n"]
            return {**op, "type": "ok",
                    "value": {"lo": lo, "n": n, "proof": body["proof"],
                              "expanded": [intern.value(i)
                                           for i in range(lo, lo + n)
                                           if i < len(intern._rev)]}}
        return super().completion_payload(op, body, payload, intern)

    def completion(self, op, body, read_state, intern):
        if body["type"] == "batch_ok":
            return self.completion_payload(op, body, None, intern)
        if body["type"] == "read_ok":
            seen_row = np.asarray(read_state()["seen"])
            return {**op, "type": "ok",
                    "value": [intern.value(int(i))
                              for i in np.nonzero(seen_row)[0]]}
        return {**op, "type": "ok"}
