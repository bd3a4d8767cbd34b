"""Static edge channels: the sort-free path for topology traffic.

Counterpart of `maelstrom_tpu/net/static.py`. Message lane j from node n
to its d-th neighbour always lands in the same inbox slot of that
neighbour (its reverse-edge index), so delivery is a fixed permutation of
flat (node, edge) rows. Latency is a small ring of per-edge cells indexed
by arrival round.

The channels are a mutable buffer here: `edge_read` clears the consumed
cell and `edge_write` fills cells in place (both also return the
channels), where the JAX version copies the ring every round. A round
therefore consumes the channels it is given.

Under randomized latency two sends of one (edge, lane) can aim at one
cell. By default the later overwrites the earlier (counted); with
`EdgeConfig.spill` (the collision-free write, taken by programs whose
inbox lanes are decoded by type) an incoming message takes the next free
lane of its cell instead, and the channels have more lanes than a round
sends.

On the cluster axis (the node rows of F clusters, F * N rows) the round
may be an [F] tensor, one round a cluster: node row n then reads
round[n // (rows / F)], its own cluster's (the fleet, whose clusters run
at rounds of their own); a scalar round serves every row.

Each function has a hand-written CUDA kernel (`csrc/edge.cu`) and a plain
PyTorch version; `kernels.use_kernel` picks by the tensors' device."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels as K
from ..tree import Struct
from .tpu import I32

__all__ = ["EdgeMsgs", "EdgeChannels", "EdgeConfig", "LANE_STRIDE",
           "make_channels", "reverse_index", "edge_write",
           "edge_write_spill", "edge_read"]

# send-lane field width of the JAX package's packed `sent` plane; lane
# counts stay under it
LANE_STRIDE = 64


@dataclass
class EdgeMsgs(Struct):
    """Per-edge message lanes: fields shaped [N, D, LANES]."""
    valid: torch.Tensor
    type: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    # packed send identity (round * LANE_STRIDE + send lane) of each
    # message on journaled runs (channels made with track_send_round);
    # None otherwise
    sent: object = None

    @classmethod
    def empty(cls, shape, device) -> "EdgeMsgs":
        def z():
            return torch.zeros(shape, dtype=I32, device=device)
        return cls(valid=torch.zeros(shape, dtype=torch.bool, device=device),
                   type=z(), a=z(), b=z(), c=z())


@dataclass
class EdgeChannels(Struct):
    """In-flight edge messages: fields shaped [N, D, ring, LANES],
    indexed by arrival round % ring."""
    valid: torch.Tensor
    type: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    overwrites: torch.Tensor    # i32 scalar: messages lost to collision
    lat_clipped: torch.Tensor   # i32 scalar: latency draws clipped to ring
    sent: object = None         # i32 plane on journaled runs (EdgeMsgs.sent)


@dataclass(frozen=True)
class EdgeConfig:
    """Static shape of the edge exchange (see the JAX package's
    `EdgeConfig`). `uniform_arrival`: every entry of a round's latency
    array is equal, and entry 0's arrival cell is used for all. `spill`:
    the collision-free write; `lanes` then counts the channels' lanes,
    which may exceed the lanes a round sends."""
    n_nodes: int
    degree: int
    lanes: int
    ring: int = 2
    spill: bool = False
    uniform_arrival: bool = False


def make_channels(cfg: EdgeConfig, device,
                  track_send_round: bool = False) -> EdgeChannels:
    """`track_send_round` adds the `sent` plane, so journal recv rows
    pair exactly to their sends; without it the exchange moves no more
    bytes than the bench path needs."""
    shape = (cfg.n_nodes, cfg.degree, cfg.ring, cfg.lanes)

    def z():
        return torch.zeros(shape, dtype=I32, device=device)
    return EdgeChannels(valid=torch.zeros(shape, dtype=torch.bool,
                                          device=device),
                        type=z(), a=z(), b=z(), c=z(),
                        overwrites=torch.zeros((), dtype=I32, device=device),
                        lat_clipped=torch.zeros((), dtype=I32,
                                                device=device),
                        sent=z() if track_send_round else None)


def reverse_index(neighbors: np.ndarray) -> np.ndarray:
    """rev[n, d] = e such that neighbors[neighbors[n, d], e] == n; -1 for
    missing edges. Topologies must be symmetric."""
    neighbors = np.asarray(neighbors)
    n, deg = neighbors.shape
    rev = np.full((n, deg), -1, dtype=np.int32)
    for i in range(n):
        for d in range(deg):
            m = neighbors[i, d]
            if m < 0:
                continue
            back = np.nonzero(neighbors[m] == i)[0]
            if not back.size:
                raise ValueError(f"topology not symmetric: {i}->{m}")
            rev[i, d] = back[0]
    return rev


def _check(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                         f"expected {tuple(shape)} {dtype}")


def _check_channels(cfg: EdgeConfig, ch: EdgeChannels):
    shape = (cfg.n_nodes, cfg.degree, cfg.ring, cfg.lanes)
    _check("channels.valid", ch.valid, shape, torch.bool)
    for f in ("type", "a", "b", "c"):
        _check(f"channels.{f}", getattr(ch, f), shape, I32)
    if ch.sent is not None:
        _check("channels.sent", ch.sent, shape, I32)


# --- edge_write -----------------------------------------------------------

def _count(ch: EdgeChannels, mask):
    """The set entries of an [N, D, L] mask, for the channels' counters:
    one scalar, or on the cluster axis one count a cluster ([F] counters
    over F equal blocks of node rows)."""
    if ch.overwrites.dim() == 0:
        return mask.sum(dtype=I32)
    return mask.reshape(ch.overwrites.shape[0], -1).sum(dim=1, dtype=I32)


def _row_round(cfg: EdgeConfig, round_):
    """The round of every node row: the scalar round as it is, an [F]
    round (one a cluster) as an [N, 1, 1] column of its rows' clusters'
    rounds."""
    if round_.dim() == 0:
        return round_
    return round_.repeat_interleave(cfg.n_nodes // round_.shape[0])[
        :, None, None]


def _rows_per_round(cfg: EdgeConfig, round_) -> int:
    """The kernels' rows_per_round: 0 for a scalar round, else the node
    rows a cluster of an [F] round."""
    if round_.dim() == 0:
        return 0
    F = round_.shape[0]
    if round_.dim() != 1 or round_.dtype != I32 or F < 1 \
            or cfg.n_nodes % F:
        raise ValueError(f"round: {tuple(round_.shape)} {round_.dtype} "
                         f"for {cfg.n_nodes} node rows")
    return cfg.n_nodes // F


def _arrival(cfg: EdgeConfig, latency_rounds, round_):
    """Arrival cell of every lane: (round + max(clip(lat, 0, ring-1), 1))
    % ring; under `uniform_arrival` every lane takes entry 0's (its
    cluster's entry 0 with an [F] round)."""
    lat = torch.clamp(latency_rounds.clamp(0, cfg.ring - 1), min=1)
    rnd = _row_round(cfg, round_)
    if cfg.uniform_arrival:
        if rnd.dim():
            per = cfg.n_nodes // round_.shape[0]
            first = lat.reshape(round_.shape[0], per, -1)[:, :1, :1]
            lat = first.expand(-1, per, 1).reshape(-1, 1, 1)
        else:
            lat = lat.reshape(-1)[0]
    arrival = torch.remainder(rnd + lat, cfg.ring)
    return arrival.expand(torch.broadcast_shapes(
        arrival.shape, tuple(latency_rounds.shape)))


def edge_write_plain(cfg: EdgeConfig, ch: EdgeChannels, out: EdgeMsgs,
                     round_, latency_rounds, deliver_mask) -> EdgeChannels:
    """Writes each lane where `out.valid & deliver_mask` into its arrival
    cell, in place, counting writes onto a valid cell (`overwrites`) and
    clipped latency draws; a tracked `sent` plane takes round *
    LANE_STRIDE + lane. Every lane owns its (n, d, ., l) column, so
    the three forms of the JAX version (uniform arrival, ring <= 4,
    broadcast select) are one gather and one scatter."""
    ok = out.valid & deliver_mask
    # a latency shared by an edge's lanes ([N, D, 1], the atomic-RPC
    # draw) reaches every lane
    lat = latency_rounds.expand(ok.shape)
    arr = _arrival(cfg, lat, round_).long().unsqueeze(2)
    cell_valid = torch.gather(ch.valid, 2, arr).squeeze(2)
    ch.overwrites += _count(ch, ok & cell_valid)
    ch.lat_clipped += _count(ch, ok & (lat > cfg.ring - 1))
    new = {f: getattr(out, f) for f in ("type", "a", "b", "c")}
    if ch.sent is not None:
        lane = torch.arange(cfg.lanes, dtype=I32, device=ok.device)
        new["sent"] = (_row_round(cfg, round_) * LANE_STRIDE
                       + lane).expand(ok.shape)
    for f, val in new.items():
        chf = getattr(ch, f)
        old = torch.gather(chf, 2, arr).squeeze(2)
        chf.scatter_(2, arr, torch.where(ok, val, old).unsqueeze(2))
    ch.valid.scatter_(2, arr, (cell_valid | ok).unsqueeze(2))
    return ch


def edge_write_spill_plain(cfg: EdgeConfig, ch: EdgeChannels,
                           out: EdgeMsgs, round_, latency_rounds,
                           deliver_mask) -> EdgeChannels:
    """The collision-free write (the JAX package's `_edge_write_spill`),
    in place: each lane where `out.valid & deliver_mask` goes to lane
    occ + rank of its arrival cell, occ the cell's valid lanes before
    the write and rank the number of earlier out lanes aimed at the same
    cell; past the channel's lanes it is dropped and counted in
    `overwrites`. Clipped draws are counted; a tracked `sent` plane
    takes round * LANE_STRIDE + out lane."""
    N, D, R, Lc = ch.valid.shape
    Lo = out.valid.shape[2]
    ok = out.valid & deliver_mask
    lat = latency_rounds.expand(ok.shape)
    ch.lat_clipped += _count(ch, ok & (lat > cfg.ring - 1))
    rnd = _row_round(cfg, round_)
    arrival = torch.remainder(rnd + lat.clamp(0, R - 1).clamp(min=1), R)
    cell = torch.where(ok, arrival, R).long()            # R = parked
    jl = torch.arange(Lo, device=ok.device)
    lower = jl[None, :] < jl[:, None]                    # [l, j]
    same = cell[:, :, None, :] == cell[:, :, :, None]    # [N, D, l, j]
    rank = (same & lower & ok[:, :, None, :]).sum(dim=3)
    occ = ch.valid.sum(dim=3)                            # [N, D, R]
    occ_at = torch.gather(occ, 2, cell.clamp(0, R - 1))
    lane = occ_at + rank
    write = ok & (lane < Lc)
    ch.overwrites += _count(ch, ok & (lane >= Lc))
    n_i, d_i, l_i = torch.nonzero(write, as_tuple=True)
    at = (n_i, d_i, cell[write], lane[write])
    ch.valid[at] = True
    for f in ("type", "a", "b", "c"):
        getattr(ch, f)[at] = getattr(out, f)[write]
    if ch.sent is not None:
        r_n = (rnd.reshape(-1)[n_i] if rnd.dim() else rnd)
        ch.sent[at] = (r_n * LANE_STRIDE + l_i).to(I32)
    return ch


def edge_write_spill(cfg: EdgeConfig, ch: EdgeChannels, out: EdgeMsgs,
                     round_, latency_rounds,
                     deliver_mask) -> EdgeChannels:
    """The collision-free write (see `edge_write_spill_plain`); the kernel
    is K9 `edge_write_spill` in `csrc/edge.cu`."""
    Lo = out.valid.shape[2]
    shape = (cfg.n_nodes, cfg.degree, Lo)
    if Lo > cfg.lanes or Lo > LANE_STRIDE:
        raise ValueError(f"edge_write_spill: {Lo} out lanes for "
                         f"{cfg.lanes} channel lanes")
    if not K.use_kernel(ch.valid):
        return edge_write_spill_plain(cfg, ch, out, round_, latency_rounds,
                                      deliver_mask)
    return _launch_write(K.EDGE_WRITE_SPILL, cfg, ch, out, round_,
                         latency_rounds, deliver_mask, shape,
                         [cfg.n_nodes, cfg.degree, cfg.ring, cfg.lanes, Lo],
                         [_rows_per_counter(cfg, ch)])


def _rows_per_counter(cfg: EdgeConfig, ch: EdgeChannels) -> int:
    """The kernels' rows_per_counter: 0 for one scalar pair of channel
    counters, else the node rows a cluster of [F] counters."""
    if ch.overwrites.dim() == 0:
        return 0
    n_c = ch.overwrites.shape[0]
    if n_c < 1 or cfg.n_nodes % n_c or tuple(
            ch.lat_clipped.shape) != (n_c,):
        raise ValueError(f"edge_write: {n_c} counters for {cfg.n_nodes} "
                         f"node rows")
    return cfg.n_nodes // n_c


def _launch_write(kernel, cfg, ch, out, round_, latency_rounds,
                  deliver_mask, shape, dims, extra=()):
    # broadcast views, read through their strides (no expanded copy)
    lat = latency_rounds.to(I32).expand(shape)
    mask = deliver_mask.to(torch.bool).expand(shape)
    for name, t, dt in (("valid", out.valid, torch.bool),
                        ("type", out.type, I32), ("a", out.a, I32),
                        ("b", out.b, I32), ("c", out.c, I32)):
        _check(f"out.{name}", t, shape, dt)
    rpr = _rows_per_round(cfg, round_)
    if not rpr:
        _check("round", round_, (), I32)
    kernel.launch(
        [ch.valid, ch.type, ch.a, ch.b, ch.c,
         out.valid.contiguous(), out.type.contiguous(), out.a.contiguous(),
         out.b.contiguous(), out.c.contiguous(), lat, mask, round_,
         ch.overwrites, ch.lat_clipped, ch.sent],
        dims + [*lat.stride(), *mask.stride(), *extra, rpr],
        ch.valid.device, strided=(lat, mask))
    return ch


def edge_write(cfg: EdgeConfig, ch: EdgeChannels, out: EdgeMsgs,
               round_, latency_rounds, deliver_mask) -> EdgeChannels:
    """Writes this round's outgoing lanes into the rings (in place).

    latency_rounds: i32 [N, D, L] delay in rounds; deliver_mask: bool
    broadcastable to [N, D, L]; round_: i32 scalar tensor, or [F] on the
    cluster axis. Spill channels take the collision-free write
    (`edge_write_spill`)."""
    _check_channels(cfg, ch)
    if cfg.spill:
        return edge_write_spill(cfg, ch, out, round_, latency_rounds,
                                deliver_mask)
    shape = (cfg.n_nodes, cfg.degree, cfg.lanes)
    if tuple(out.valid.shape) != shape:
        raise ValueError(f"edge_write: outbox {tuple(out.valid.shape)} "
                         f"!= channel lanes {shape}")
    if not K.use_kernel(ch.valid):
        return edge_write_plain(cfg, ch, out, round_, latency_rounds,
                                deliver_mask)
    return _launch_write(K.EDGE_WRITE, cfg, ch, out, round_, latency_rounds,
                         deliver_mask, shape,
                         [cfg.n_nodes, cfg.degree, cfg.ring, cfg.lanes,
                          int(cfg.uniform_arrival)],
                         [_rows_per_counter(cfg, ch)])


# --- edge_read ------------------------------------------------------------

def _route_rows(cfg: EdgeConfig, neighbors, rev):
    safe_nb = neighbors.clamp(0, cfg.n_nodes - 1)
    safe_rev = rev.clamp(0, cfg.degree - 1)
    return (safe_nb * cfg.degree + safe_rev).reshape(-1).long()


def edge_read_plain(cfg: EdgeConfig, ch: EdgeChannels, neighbors, rev,
                    round_):
    """Reads cell `round % ring` routed to the receiving end of each edge
    (inbox[m, e] = cell of row (nb[m, e], rev[m, e])), masks missing
    edges, then clears that cell of every row in place. A tracked `sent`
    plane is routed with the other fields."""
    N, D, L = cfg.n_nodes, cfg.degree, cfg.lanes
    flat = _route_rows(cfg, neighbors, rev)
    if round_.dim() == 0:
        s = torch.remainder(round_, cfg.ring).reshape(1).long()

        def cells(f):
            return f.index_select(2, s).reshape(N * D, L)
    else:
        # each row's own cluster's cell
        s = torch.remainder(_row_round(cfg, round_), cfg.ring).long()
        s = s.reshape(N, 1, 1, 1).expand(N, D, 1, L)

        def cells(f):
            return torch.gather(f, 2, s).reshape(N * D, L)

    def route(f):
        return cells(f)[flat].reshape(N, D, L)

    inbox = EdgeMsgs(valid=route(ch.valid) & (neighbors >= 0)[:, :, None],
                     type=route(ch.type), a=route(ch.a), b=route(ch.b),
                     c=route(ch.c),
                     sent=None if ch.sent is None else route(ch.sent))
    if round_.dim() == 0:
        ch.valid.index_fill_(2, s, False)
    else:
        ch.valid.scatter_(2, s, False)
    return ch, inbox


def edge_read(cfg: EdgeConfig, ch: EdgeChannels, neighbors, rev,
              round_) -> tuple[EdgeChannels, EdgeMsgs]:
    """(channels with this round's cell cleared, inbox EdgeMsgs [N, D, L]);
    inbox slot (m, e) holds what m's e-th neighbour sent it. `round_` is
    an i32 scalar, or [F] on the cluster axis."""
    _check_channels(cfg, ch)
    N, D, L = cfg.n_nodes, cfg.degree, cfg.lanes
    _check("neighbors", neighbors, (N, D), I32)
    _check("rev", rev, (N, D), I32)
    rpr = _rows_per_round(cfg, round_)
    if not K.use_kernel(ch.valid):
        return edge_read_plain(cfg, ch, neighbors, rev, round_)
    if not rpr:
        _check("round", round_, (), I32)
    dev = ch.valid.device

    def i32():
        return torch.empty((N, D, L), dtype=I32, device=dev)
    inbox = EdgeMsgs(
        valid=torch.empty((N, D, L), dtype=torch.bool, device=dev),
        type=i32(), a=i32(), b=i32(), c=i32(),
        sent=None if ch.sent is None else i32())
    K.EDGE_READ.launch(
        [ch.valid, ch.type, ch.a, ch.b, ch.c, neighbors.contiguous(),
         rev.contiguous(), round_, inbox.valid, inbox.type, inbox.a,
         inbox.b, inbox.c, ch.sent, inbox.sent],
        [N, D, cfg.ring, L, rpr], dev)
    return ch, inbox
