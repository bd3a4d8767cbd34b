"""The simulated network's message arrays and flight pool, in PyTorch.

Counterpart of `maelstrom_tpu/net/tpu.py`: the same struct-of-arrays
`Msgs`, the same `NetState` and counters, and the same send/deliver
semantics, held against it leaf for leaf by `tests/test_torch_pool.py`.

The flight pool stays plain tensor ops: on the broadcast path it carries
only client RPCs. Where the JAX version skips delivery under `lax.cond`
when nothing is due, this one always runs the delivery pass, which then
yields the same state, and selects the same empty client batch on the
device: branching on device data would cost a host sync every round.

Loss, duplication and randomized latency draw from the key a caller
passes (`prng`, bit for bit with `jax.random`). The fault API at the end
is the host's surgery on a `NetState` between dispatches (the nemesis):
each returns a new state and changes none in place."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..tree import Struct, tree_map

I32 = torch.int32
INT32_MAX = 2**31 - 1
TYPE_BUCKETS = 64     # wire type codes are small ints; 63 = overflow bin


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor as int32, wrapping modulo 2**32 as XLA's int32
    arithmetic does (`torch.sum` of int32 gives int64)."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(I32)


@dataclass
class Msgs(Struct):
    """A struct-of-arrays batch of messages with any common leading shape
    (pool `[P]`, inbox `[N, K]`, plan `[R, M]`)."""
    valid: torch.Tensor      # bool
    src: torch.Tensor        # i32 node index; clients are >= n_nodes
    dest: torch.Tensor
    due: torch.Tensor        # delivery round
    mid: torch.Tensor        # global message id
    reply_to: torch.Tensor   # in_reply_to id, or -1
    type: torch.Tensor       # body type code
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor

    @classmethod
    def empty(cls, shape, device) -> "Msgs":
        if isinstance(shape, int):
            shape = (shape,)

        def z():
            return torch.zeros(shape, dtype=I32, device=device)
        return cls(valid=torch.zeros(shape, dtype=torch.bool, device=device),
                   src=z(), dest=z(), due=z(), mid=z(),
                   reply_to=torch.full(shape, -1, dtype=I32, device=device),
                   type=z(), a=z(), b=z(), c=z())

    def at_rows(self, idx) -> "Msgs":
        return tree_map(lambda f: f[idx], self)

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=I32)


@dataclass
class NetStats(Struct):
    """On-device journal counters (all i32 scalars but `sent_by_type`)."""
    sent_all: torch.Tensor
    sent_servers: torch.Tensor
    recv_all: torch.Tensor
    recv_servers: torch.Tensor
    lost: torch.Tensor
    dropped_partition: torch.Tensor
    dropped_overflow: torch.Tensor   # pool-full drops: 0 in a valid run
    sent_units: torch.Tensor
    recv_units: torch.Tensor
    dropped_down: torch.Tensor
    duplicated: torch.Tensor
    sent_by_type: torch.Tensor       # i32 [TYPE_BUCKETS]

    @classmethod
    def zeros(cls, device) -> "NetStats":
        scalars = {f: torch.zeros((), dtype=I32, device=device)
                   for f in ("sent_all", "sent_servers", "recv_all",
                             "recv_servers", "lost", "dropped_partition",
                             "dropped_overflow", "sent_units", "recv_units",
                             "dropped_down", "duplicated")}
        return cls(**scalars, sent_by_type=torch.zeros(
            TYPE_BUCKETS, dtype=I32, device=device))


def count_by_type(counter, types, valid):
    """Adds valid message counts into per-type-code buckets: one
    [TYPE_BUCKETS] counter, or on the cluster axis [F, TYPE_BUCKETS]
    counters over messages whose leading axis is the cluster's."""
    idx = types.clamp(0, TYPE_BUCKETS - 1).long()
    if counter.dim() == 2:
        F = counter.shape[0]
        idx = idx.reshape(F, -1) + TYPE_BUCKETS * torch.arange(
            F, device=idx.device)[:, None]
        return counter.reshape(-1).index_add(
            0, idx.reshape(-1), valid.reshape(-1).to(I32)).reshape(F, -1)
    return counter.index_add(0, idx.reshape(-1), valid.reshape(-1).to(I32))


@dataclass
class NetState(Struct):
    pool: Msgs                    # [P] flight pool
    next_mid: torch.Tensor        # i32 scalar
    round: torch.Tensor           # i32 scalar
    component: torch.Tensor       # i32 [n_nodes + n_clients]
    p_loss: torch.Tensor          # f32 scalar
    latency_scale: torch.Tensor   # f32 scalar
    block_groups: torch.Tensor    # i32 [n_nodes + n_clients]
    block_matrix: torch.Tensor    # bool [G, G]
    down: torch.Tensor            # bool [n_nodes]
    paused: torch.Tensor          # bool [n_nodes]
    p_dup: torch.Tensor           # f32 scalar
    stats: NetStats


@dataclass(frozen=True)
class NetConfig:
    """Static network configuration; the fields and defaults of the JAX
    package's `NetConfig`."""
    n_nodes: int
    n_clients: int = 0
    pool_cap: int = 4096
    inbox_cap: int = 8
    client_cap: int = 64
    latency_mean_rounds: float = 0.0
    latency_dist: str = "constant"
    ms_per_round: float = 1.0
    partition_groups: int = 1
    enable_stall: bool = False
    enable_duplication: bool = False
    enable_byz: bool = False
    unit_words: tuple = ()
    telemetry: bool = False
    telemetry_roles: tuple = ()

    @property
    def n_total(self) -> int:
        return self.n_nodes + self.n_clients


def check_scope(cfg: NetConfig) -> None:
    """Refuses a latency distribution the port does not know."""
    if cfg.latency_dist not in prng.DISTS:
        raise ValueError(f"unknown latency dist {cfg.latency_dist!r}")


def make_net(cfg: NetConfig, device) -> NetState:
    def z(shape=(), dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return NetState(
        pool=Msgs.empty(cfg.pool_cap, device),
        next_mid=z(), round=z(), component=z(cfg.n_total),
        p_loss=z(dtype=torch.float32),
        latency_scale=torch.ones((), dtype=torch.float32, device=device),
        block_groups=z(cfg.n_total),
        block_matrix=z((cfg.partition_groups, cfg.partition_groups),
                       torch.bool),
        down=z(cfg.n_nodes, torch.bool), paused=z(cfg.n_nodes, torch.bool),
        p_dup=z(dtype=torch.float32), stats=NetStats.zeros(device))


def involves_client(cfg: NetConfig, src, dest):
    """Client on either end (reference `util.clj:12-16`)."""
    return (src >= cfg.n_nodes) | (dest >= cfg.n_nodes)


def cat_lanes(*batches: Msgs) -> Msgs:
    """Concatenates [N, L_i] Msgs batches along the lane axis (the JAX
    package's `cat_lanes`): joins a program's per-purpose lane groups
    into one outbox."""
    return tree_map(lambda *fs: torch.cat(fs, dim=1), *batches)


def payload_units(cfg: NetConfig, types, words, valid):
    """Client-op units over a masked batch: 1 per valid message, except
    registered batch types (`cfg.unit_words`), which count their payload
    word, floored at 1. The total wraps as JAX's int32 sum does (one
    total for the whole batch: the cluster axis books no units,
    `parallel.check_config`)."""
    u = valid.to(I32)
    for code, w in cfg.unit_words:
        u = torch.where(valid & (types == code),
                        torch.clamp(words[w], min=1), u)
    return wrap_i32(u.to(torch.int64).sum())


def draw_latency_rounds(cfg: NetConfig, key, scale, shape):
    """Latency draw in rounds (the JAX package's `draw_latency_rounds`,
    reference `net.clj:64-76`): constant(mean), a broadcast scalar that
    draws nothing; uniform over [0, 2*mean] and exponential of that mean
    from `key` (K7 on the card)."""
    if cfg.latency_dist == "constant":
        # a float32 product, as jnp.float32(mean) * scale; the Python
        # scalar needs no host-to-device copy
        mean = prng.mean_rounds(cfg.latency_mean_rounds, scale)
        return torch.round(mean).to(I32).expand(shape)
    return prng.latency_rounds(key, shape, cfg.latency_dist,
                               cfg.latency_mean_rounds, scale)


def _scatter_drop(dst, idx, src):
    """dst[..., idx[..., i]] = src[..., i] where idx < dst.shape[-1]; rows
    aimed at dst.shape[-1] are dropped (JAX's `mode="drop"`). Kept
    targets are unique."""
    ext = torch.cat([dst, dst[..., :1]], dim=-1)
    ext.scatter_(-1, idx, src)
    return ext[..., :-1]


def _gather(x, idx):
    """x[..., idx] along the last axis (a batch of pools takes one row of
    indices a cluster)."""
    return torch.gather(x, -1, idx.long())


def _scatter_new(cfg: NetConfig, pool: Msgs, incoming: Msgs):
    """Scatters the valid rows of a flat batch into free pool slots,
    ranking free slots and kept messages by prefix sum. Returns
    (pool', ok) with ok marking the rows that found a slot. Over a batch
    of pools [F, P] the incoming batch is [F, M], cluster by cluster."""
    P = cfg.pool_cap
    keep = incoming.valid
    free = ~pool.valid
    n_free = free.sum(dim=-1, dtype=I32)
    free_rank = torch.cumsum(free, -1, dtype=I32) - 1
    ar = torch.arange(P, dtype=I32, device=keep.device).expand(free.shape)
    slot_by_rank = _scatter_drop(
        torch.zeros(free.shape, dtype=I32, device=keep.device),
        torch.where(free, free_rank, P).long(), ar)
    k_rank = torch.cumsum(keep, -1, dtype=I32) - 1
    ok = keep & (k_rank < n_free[..., None])
    slot = _gather(slot_by_rank, k_rank.clamp(0, P - 1))
    tgt = torch.where(ok, slot, P).long()
    pool = tree_map(lambda pf, nf: _scatter_drop(pf, tgt, nf),
                    pool, incoming.replace(valid=ok))
    return pool, ok


def _send(cfg: NetConfig, net: NetState, out: Msgs, key):
    """Enqueues a flat batch `out` [M] into the flight pool: ids by
    prefix sum (before the loss roll, reference `net.clj:205-214`), due
    = round + max(1, latency), the loss roll, free-slot scatter, and
    with duplication a second copy of kept server-to-server rows under
    an independent latency draw. `key` is split as the JAX package
    splits it. Returns (net', sent_view).

    On the cluster axis (a pool [F, P], `out` [F, M], the net's scalars
    [F]) `key` is the [F, 2] batch of the clusters' keys: cluster f
    draws from its own key, with its own loss and duplication
    probabilities and latency scale (JAX's `vmap` of the send). The
    cluster axis passes key=None when its draws change no value
    (`parallel.make_cluster_round_fn`: constant latency, the loss
    probability 0, no duplication); the draws, which leave no key
    behind, are then skipped."""
    M = out.valid.shape[-1]
    dup_on = cfg.enable_duplication
    if key is None:
        if dup_on or cfg.latency_dist != "constant":
            raise ValueError("_send without a key draws nothing: constant "
                             "latency and no duplication only")
        d_lat = d_dup = d_dlat = None
        d_lost = torch.zeros(out.valid.shape, dtype=torch.bool,
                             device=out.valid.device)
    else:
        ks = prng.split(key, 4 if dup_on else 2)
        # the draws: latency (k_lat), loss (k_loss)[, duplication (k_dup)
        # and its latency (k_dlat)]
        lat_spec = (None if cfg.latency_dist == "constant" else
                    ("latency", cfg.latency_dist, cfg.latency_mean_rounds,
                     net.latency_scale))
        d_lat, d_lost, d_dup, d_dlat = prng.draws(
            ks, M, [lat_spec, ("mask", net.p_loss)]
            + ([("mask", net.p_dup), lat_spec] if dup_on
               else [None, None]))
    new = out.valid
    rank = torch.cumsum(new, -1, dtype=I32) - 1
    mid = net.next_mid[..., None] + rank
    client = involves_client(cfg, out.src, out.dest)
    if d_lat is None:
        d_lat = draw_latency_rounds(cfg, None, net.latency_scale[..., None],
                                    out.valid.shape)
    lat = torch.where(client, 0, d_lat)
    due = (net.round[..., None] + torch.clamp(lat, min=1)).to(I32)
    lost = new & d_lost
    keep = new & ~lost
    pool, ok = _scatter_new(cfg, net.pool,
                            out.replace(valid=keep, mid=mid, due=due))
    sent_view = out.replace(valid=new, mid=mid, due=due)
    n_dup = None
    if dup_on:
        # at-least-once amplification of kept server-to-server rows, same
        # id, independent latency; a copy that finds no slot is skipped
        dup = keep & ~client & d_dup
        lat2 = (draw_latency_rounds(cfg, None, net.latency_scale[..., None],
                                    out.valid.shape)
                if d_dlat is None else d_dlat)
        due2 = (net.round[..., None] + torch.clamp(lat2, min=1)).to(I32)
        pool, dup_ok = _scatter_new(cfg, pool, out.replace(
            valid=dup, mid=mid, due=due2))
        n_dup = dup_ok.sum(dim=-1, dtype=I32)
    n_new = new.sum(dim=-1, dtype=I32)
    st = net.stats
    st = st.replace(
        sent_all=st.sent_all + n_new,
        sent_servers=st.sent_servers + (new & ~client).sum(dim=-1,
                                                           dtype=I32),
        lost=st.lost + lost.sum(dim=-1, dtype=I32),
        dropped_overflow=st.dropped_overflow + (keep & ~ok).sum(
            dim=-1, dtype=I32),
        duplicated=(st.duplicated if n_dup is None
                    else st.duplicated + n_dup),
        sent_by_type=count_by_type(st.sent_by_type, out.type, new))
    if cfg.unit_words:
        st = st.replace(sent_units=st.sent_units + payload_units(
            cfg, out.type, (out.a, out.b, out.c), new))
    return net.replace(pool=pool, stats=st,
                       next_mid=net.next_mid + n_new), sent_view


def _sort_by(key, P):
    """Permutation ordering rows by (key, row index) along the last axis:
    the unique int64 composite makes every sort give the one order
    `jnp.lexsort` gives."""
    idx = torch.arange(P, dtype=torch.int64, device=key.device)
    return torch.sort(key.to(torch.int64) * (1 << 32) + idx,
                      dim=-1).indices


def _deliver(cfg: NetConfig, net: NetState):
    """Delivers the due messages of this round (`_deliver_due` of the JAX
    package; see the module docstring for the skipped branch). Returns
    (net', inbox Msgs [N, K], client_msgs Msgs [min(client_cap, P)]).
    On the cluster axis (pool [F, P]) each cluster delivers on its own:
    inbox [F, N, K], client_msgs [F, min(client_cap, P)]."""
    pool, P, N, K = net.pool, cfg.pool_cap, cfg.n_nodes, cfg.inbox_cap
    dev = pool.valid.device
    lead = tuple(pool.valid.shape[:-1])
    rnd = net.round[..., None]
    due = pool.valid & (pool.due <= rnd)
    client_msg = involves_client(cfg, pool.src, pool.dest)
    src_i = pool.src.clamp(0, cfg.n_total - 1).long()
    dest_i = pool.dest.clamp(0, cfg.n_total - 1).long()
    blocked = _gather(net.component, src_i) != _gather(net.component,
                                                       dest_i)
    if cfg.partition_groups > 1:
        # directional grudges: may src's group reach dest's group? (a
        # cluster's own matrix on the cluster axis)
        G = cfg.partition_groups
        bg = net.block_groups.long()
        cell = _gather(bg, src_i) * G + _gather(bg, dest_i)
        blocked = blocked | _gather(
            net.block_matrix.reshape(lead + (G * G,)), cell)
    blocked = blocked & ~client_msg
    if cfg.enable_stall:
        # a paused dest's mail waits in the pool; a down dest's is
        # consumed and dropped
        dest_node = pool.dest < N
        nd = pool.dest.clamp(0, N - 1).long()
        due = due & ~(dest_node & _gather(net.paused, nd))
        to_down = due & ~blocked & dest_node & _gather(net.down, nd)
    else:
        to_down = torch.zeros_like(due)
    to_client = due & ~blocked & (pool.dest >= N)
    to_node = due & ~blocked & (pool.dest < N) & ~to_down
    dropped = due & blocked

    # node delivery: (dest, due-age) composite key, earlier-due first
    age_bits = 14 if N < (1 << 17) else 0
    if age_bits:
        age = (pool.due - rnd + (1 << (age_bits - 1))).clamp(
            0, (1 << age_bits) - 1)
        key = torch.where(to_node, (pool.dest << age_bits) | age, INT32_MAX)
    else:
        key = torch.where(to_node, pool.dest, INT32_MAX)
    order = _sort_by(key, P)
    sdest = _gather(torch.where(to_node, pool.dest, N), order).contiguous()
    first = torch.searchsorted(sdest, sdest, side="left")
    slot = torch.arange(P, device=dev) - first
    take = _gather(to_node, order) & (slot < K)
    flat_tgt = torch.where(take, sdest.long() * K + slot.clamp(0, K - 1),
                           N * K)
    sorted_msgs = tree_map(lambda f: _gather(f, order), pool).replace(
        valid=take)
    inbox = tree_map(
        lambda z, f: _scatter_drop(z.reshape(lead + (N * K,)), flat_tgt, f
                                   ).reshape(lead + (N, K)),
        Msgs.empty(lead + (N, K), dev), sorted_msgs)
    taken = torch.zeros(lead + (P,), dtype=torch.bool, device=dev).scatter(
        -1, order, take)

    CC = min(cfg.client_cap, P)
    if CC > 0:
        corder = _sort_by(torch.where(to_client, pool.due, INT32_MAX),
                          P)[..., :CC]
        client_msgs = tree_map(lambda f: _gather(f, corder), pool).replace(
            valid=_gather(to_client, corder))
        # with nothing due the JAX version skips delivery and returns an
        # empty batch: its invalid rows hold the empty fields, not pool
        # rows
        any_due = due.any(dim=-1, keepdim=True)
        client_msgs = client_msgs.replace(**{
            f: torch.where(any_due, getattr(client_msgs, f),
                           -1 if f == "reply_to" else 0)
            for f in Msgs.__dataclass_fields__ if f != "valid"})
        c_taken = torch.zeros(lead + (P,), dtype=torch.bool,
                              device=dev).scatter(-1, corder,
                                                  client_msgs.valid)
    else:
        # count-only mode: consume client messages without materializing
        client_msgs = Msgs.empty(lead + (0,), dev)
        c_taken = to_client

    consumed = taken | dropped | c_taken | to_down
    pool = pool.replace(valid=pool.valid & ~consumed)
    st = net.stats

    def n(x):
        return x.sum(dim=-1, dtype=I32)
    st = st.replace(
        recv_all=st.recv_all + n(taken) + n(c_taken),
        recv_servers=st.recv_servers + n(taken & ~client_msg),
        dropped_partition=st.dropped_partition + n(dropped),
        dropped_down=st.dropped_down + n(to_down))
    if cfg.unit_words:
        st = st.replace(recv_units=st.recv_units + payload_units(
            cfg, net.pool.type, (net.pool.a, net.pool.b, net.pool.c),
            taken | c_taken))
    return net.replace(pool=pool, stats=st), inbox, client_msgs


def advance(net: NetState) -> NetState:
    return net.replace(round=net.round + 1)


# --- fault API: host-side surgery between dispatches (net.clj:104-121) ---

def _on(like, values, dtype):
    """`values` (numpy, a list or a tensor) as a tensor on `like`'s
    device."""
    return torch.as_tensor(np.asarray(values), dtype=dtype).to(like.device)


def partition_components(net: NetState, labels) -> NetState:
    """Component labels per node (clients keep theirs): nodes in
    different components cannot exchange node-to-node messages."""
    labels = _on(net.component, labels, I32)
    comp = net.component.clone()
    comp[:labels.shape[0]] = labels
    return net.replace(component=comp)


def partition_grudge(net: NetState, groups, matrix) -> NetState:
    """A directional grudge: `groups` labels each node (clients keep
    group 0) and `matrix[g_src, g_dest]` blocks src -> dest. The matrix
    shape is the config's `partition_groups` squared."""
    matrix = _on(net.block_matrix, matrix, torch.bool)
    if tuple(matrix.shape) != tuple(net.block_matrix.shape):
        raise ValueError(
            f"grudge matrix shape {tuple(matrix.shape)} != configured "
            f"{tuple(net.block_matrix.shape)}; set "
            f"NetConfig.partition_groups")
    groups = _on(net.block_groups, groups, I32)
    g2 = net.block_groups.clone()
    g2[:groups.shape[0]] = groups
    return net.replace(block_groups=g2, block_matrix=matrix)


def set_down(net: NetState, mask) -> NetState:
    """Crash-killed nodes: they stop stepping and their mail is dropped
    (enable_stall)."""
    return net.replace(down=_on(net.down, mask, torch.bool))


def set_paused(net: NetState, mask) -> NetState:
    """Paused nodes: they stop stepping, keep their state, and pool mail
    waits for them (enable_stall)."""
    return net.replace(paused=_on(net.paused, mask, torch.bool))


def _full(like, value):
    return torch.full_like(like, float(value))


def set_duplication(net: NetState, p: float) -> NetState:
    """Server-to-server duplication probability (enable_duplication)."""
    return net.replace(p_dup=_full(net.p_dup, p))


def heal(net: NetState) -> NetState:
    """Clears partitions: component labels and directional grudges."""
    return net.replace(component=torch.zeros_like(net.component),
                       block_groups=torch.zeros_like(net.block_groups),
                       block_matrix=torch.zeros_like(net.block_matrix))


def slow(net: NetState, factor: float = 10.0) -> NetState:
    return net.replace(latency_scale=net.latency_scale * factor)


def fast(net: NetState) -> NetState:
    return net.replace(latency_scale=torch.ones_like(net.latency_scale))


def flaky(net: NetState, p: float = 0.5) -> NetState:
    return net.replace(p_loss=_full(net.p_loss, p))


def set_latency_scale(net: NetState, scale: float) -> NetState:
    """Absolute latency-scale install (the weather nemesis and
    --latency-scale; slow/fast are relative)."""
    return net.replace(latency_scale=_full(net.latency_scale, scale))


def set_weather(net: NetState, p_loss: float, scale: float) -> NetState:
    """One weather front: loss probability and latency scale at once."""
    return net.replace(p_loss=_full(net.p_loss, p_loss),
                       latency_scale=_full(net.latency_scale, scale))


def stats_dict(net: NetState, transfer=None) -> dict:
    """The counters on the host, as the JAX package's `stats_dict` gives
    them; `sent_by_type` becomes {type code: count} of nonzero buckets.
    Given a `TransferStats`, the read is booked there as one drain."""
    host = (transfer.fetch(net.stats) if transfer is not None
            else tree_map(lambda t: t.cpu().numpy(), net.stats))
    out = {}
    for name in NetStats.__dataclass_fields__:
        a = getattr(host, name)
        if name == "sent_by_type":
            out[name] = {int(t): int(c) for t, c in
                         enumerate(a.reshape(-1, TYPE_BUCKETS).sum(0)) if c}
        else:
            out[name] = int(a.sum())
    return out
