"""The simulated network's message arrays and flight pool, in PyTorch.

Counterpart of `maelstrom_tpu/net/tpu.py`: the same struct-of-arrays
`Msgs`, the same `NetState` and counters, and the same send/deliver
semantics, held against it leaf for leaf by `tests/test_torch_pool.py`.

The flight pool stays plain tensor ops: on the broadcast path it carries
only client RPCs. Where the JAX version skips delivery under `lax.cond`
when nothing is due, this one always runs the delivery pass, which then
yields the same state, and selects the same empty client batch on the
device: branching on device data would cost a host sync every round.

Random draws (loss, duplication, randomized latency) need the port's PRNG,
which is a later slice; `check_scope` refuses configs that use them."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tree import Struct, tree_map

I32 = torch.int32
INT32_MAX = 2**31 - 1
TYPE_BUCKETS = 64     # wire type codes are small ints; 63 = overflow bin


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
    """Adds valid message counts into per-type-code buckets."""
    idx = types.reshape(-1).clamp(0, TYPE_BUCKETS - 1).long()
    return counter.index_add(0, idx, valid.reshape(-1).to(I32))


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
    """Refuses the parts of the network that later slices port."""
    later = [
        (cfg.latency_dist != "constant",
         f"latency_dist={cfg.latency_dist!r} (PRNG slice)"),
        (cfg.enable_duplication, "enable_duplication (fault slice)"),
        (cfg.enable_stall, "enable_stall (fault slice)"),
        (cfg.enable_byz, "enable_byz (adversary slice)"),
        (cfg.telemetry, "telemetry (observability slice)"),
        (cfg.partition_groups > 1, "partition_groups > 1 (fault slice)"),
        (bool(cfg.unit_words), "unit_words (batched-broadcast slice)"),
    ]
    for hit, what in later:
        if hit:
            raise NotImplementedError(
                f"maelstrom_tpu_torch does not port {what} yet")


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


def payload_units(cfg: NetConfig, types, words, valid):
    """Client-op units over a masked batch: 1 per valid message, except
    registered batch types (`cfg.unit_words`), which count their payload
    word, floored at 1."""
    u = valid.to(I32)
    for code, w in cfg.unit_words:
        u = torch.where(valid & (types == code),
                        torch.clamp(words[w], min=1), u)
    return u.sum(dtype=I32)


def draw_latency_rounds(cfg: NetConfig, scale, shape):
    """Latency in rounds: the constant distribution only (the others
    draw random numbers, which the PRNG slice ports)."""
    if cfg.latency_dist != "constant":
        raise NotImplementedError(
            f"latency_dist={cfg.latency_dist!r} needs the PRNG slice")
    # a float32 product, as jnp.float32(mean) * scale; the Python scalar
    # needs no host-to-device copy
    mean = scale.to(torch.float32) * float(cfg.latency_mean_rounds)
    return torch.round(mean).to(I32).expand(shape)


def _scatter_drop(dst, idx, src):
    """dst[idx[i]] = src[i] where idx[i] < len(dst); rows aimed at
    len(dst) are dropped (JAX's `mode="drop"`). Kept targets are
    unique."""
    ext = torch.cat([dst, dst[:1]])
    ext[idx] = src
    return ext[:-1]


def _scatter_new(cfg: NetConfig, pool: Msgs, incoming: Msgs):
    """Scatters the valid rows of a flat batch into free pool slots,
    ranking free slots and kept messages by prefix sum. Returns
    (pool', ok) with ok marking the rows that found a slot."""
    P = cfg.pool_cap
    keep = incoming.valid
    free = ~pool.valid
    n_free = free.sum(dtype=I32)
    free_rank = torch.cumsum(free, 0, dtype=I32) - 1
    ar = torch.arange(P, dtype=I32, device=keep.device)
    slot_by_rank = _scatter_drop(
        torch.zeros(P, dtype=I32, device=keep.device),
        torch.where(free, free_rank, P).long(), ar)
    k_rank = torch.cumsum(keep, 0, dtype=I32) - 1
    ok = keep & (k_rank < n_free)
    slot = slot_by_rank[k_rank.clamp(0, P - 1).long()]
    tgt = torch.where(ok, slot, P).long()
    pool = tree_map(lambda pf, nf: _scatter_drop(pf, tgt, nf),
                    pool, incoming.replace(valid=ok))
    return pool, ok


def _send(cfg: NetConfig, net: NetState, out: Msgs):
    """Enqueues a flat batch `out` [M] into the flight pool: ids by
    prefix sum, due = round + max(1, latency), free-slot scatter.
    Returns (net', sent_view). Loss is not drawn: callers have checked
    that p_loss is 0 (`sim.make_run_fn`)."""
    M = out.valid.shape[0]
    new = out.valid
    rank = torch.cumsum(new, 0, dtype=I32) - 1
    mid = net.next_mid + rank
    client = involves_client(cfg, out.src, out.dest)
    lat = torch.where(client, 0,
                      draw_latency_rounds(cfg, net.latency_scale, (M,)))
    due = (net.round + torch.clamp(lat, min=1)).to(I32)
    keep = new
    pool, ok = _scatter_new(cfg, net.pool,
                            out.replace(valid=keep, mid=mid, due=due))
    sent_view = out.replace(valid=new, mid=mid, due=due)
    n_new = new.sum(dtype=I32)
    st = net.stats
    st = st.replace(
        sent_all=st.sent_all + n_new,
        sent_servers=st.sent_servers + (new & ~client).sum(dtype=I32),
        dropped_overflow=st.dropped_overflow + (keep & ~ok).sum(dtype=I32),
        sent_by_type=count_by_type(st.sent_by_type, out.type, new))
    return net.replace(pool=pool, stats=st,
                       next_mid=net.next_mid + n_new), sent_view


def _sort_by(key, P):
    """Permutation ordering rows by (key, row index): the unique int64
    composite makes every sort give the one order `jnp.lexsort` gives."""
    idx = torch.arange(P, dtype=torch.int64, device=key.device)
    return torch.sort(key.to(torch.int64) * (1 << 32) + idx).indices


def _deliver(cfg: NetConfig, net: NetState):
    """Delivers the due messages of this round (`_deliver_due` of the JAX
    package; see the module docstring for the skipped branch). Returns
    (net', inbox Msgs [N, K], client_msgs Msgs [min(client_cap, P)])."""
    pool, P, N, K = net.pool, cfg.pool_cap, cfg.n_nodes, cfg.inbox_cap
    dev = pool.valid.device
    due = pool.valid & (pool.due <= net.round)
    client_msg = involves_client(cfg, pool.src, pool.dest)
    src_i = pool.src.clamp(0, cfg.n_total - 1).long()
    dest_i = pool.dest.clamp(0, cfg.n_total - 1).long()
    blocked = (net.component[src_i] != net.component[dest_i]) & ~client_msg
    to_client = due & ~blocked & (pool.dest >= N)
    to_node = due & ~blocked & (pool.dest < N)
    dropped = due & blocked

    # node delivery: (dest, due-age) composite key, earlier-due first
    age_bits = 14 if N < (1 << 17) else 0
    if age_bits:
        age = (pool.due - net.round + (1 << (age_bits - 1))).clamp(
            0, (1 << age_bits) - 1)
        key = torch.where(to_node, (pool.dest << age_bits) | age, INT32_MAX)
    else:
        key = torch.where(to_node, pool.dest, INT32_MAX)
    order = _sort_by(key, P)
    sdest = torch.where(to_node, pool.dest, N)[order].contiguous()
    first = torch.searchsorted(sdest, sdest, side="left")
    slot = torch.arange(P, device=dev) - first
    take = to_node[order] & (slot < K)
    flat_tgt = torch.where(take, sdest.long() * K + slot.clamp(0, K - 1),
                           N * K)
    sorted_msgs = pool.at_rows(order).replace(valid=take)
    inbox = tree_map(
        lambda z, f: _scatter_drop(z.reshape(N * K), flat_tgt, f
                                   ).reshape(N, K),
        Msgs.empty((N, K), dev), sorted_msgs)
    taken = torch.zeros(P, dtype=torch.bool, device=dev)
    taken[order] = take

    CC = min(cfg.client_cap, P)
    if CC > 0:
        corder = _sort_by(torch.where(to_client, pool.due, INT32_MAX),
                          P)[:CC]
        client_msgs = pool.at_rows(corder).replace(valid=to_client[corder])
        # with nothing due the JAX version skips delivery and returns an
        # empty batch: its invalid rows hold the empty fields, not pool
        # rows
        any_due = due.any()
        client_msgs = client_msgs.replace(**{
            f: torch.where(any_due, getattr(client_msgs, f),
                           -1 if f == "reply_to" else 0)
            for f in Msgs.__dataclass_fields__ if f != "valid"})
        c_taken = torch.zeros(P, dtype=torch.bool, device=dev)
        c_taken[corder] = client_msgs.valid
    else:
        # count-only mode: consume client messages without materializing
        client_msgs = Msgs.empty(0, dev)
        c_taken = to_client

    consumed = taken | dropped | c_taken
    pool = pool.replace(valid=pool.valid & ~consumed)
    st = net.stats
    st = st.replace(
        recv_all=st.recv_all + taken.sum(dtype=I32)
        + c_taken.sum(dtype=I32),
        recv_servers=st.recv_servers + (taken & ~client_msg).sum(dtype=I32),
        dropped_partition=st.dropped_partition + dropped.sum(dtype=I32))
    return net.replace(pool=pool, stats=st), inbox, client_msgs


def advance(net: NetState) -> NetState:
    return net.replace(round=net.round + 1)


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
