"""Simulation composition: network + node program = one round.

Counterpart of `maelstrom_tpu/sim.py` for the edge-channel path:

    inject client msgs -> deliver due msgs -> read edges -> step all nodes
    -> compact client replies -> write edges

`make_round_fn` gives that round for interactive use; `make_run_fn` loops
it over a pre-scheduled injection plan on the device, with no host sync
inside the loop: the benchmark path.

A round consumes the `SimState` it is given: the edge channels are
updated in place (see `net/static.py`). Keep only the returned state.

`SimState.key` is a placeholder `uint32[2]` built from the seed: this
slice runs only configs that draw no random numbers, and the key is not
advanced. The PRNG slice makes it live."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import kernels as K
from .net import static
from .net import tpu as T
from .net.tpu import I32, Msgs, NetConfig, NetState
from .tree import Struct, resolve_device, tree_map


@dataclass
class SimState(Struct):
    net: NetState
    nodes: object             # program state dict, leading axis N
    key: torch.Tensor         # uint32[2] placeholder (see module docstring)
    channels: object = None   # EdgeChannels
    durable: object = None    # persisted subset of node state, or None
    telemetry: object = None  # the observability slice
    byz: object = None        # the adversary slice


def _check_program(program, cfg: NetConfig, device) -> None:
    if not getattr(program, "is_edge", False):
        raise NotImplementedError(
            f"{program.name}: only edge programs run in this slice (the "
            f"pool-path round comes with the other node programs)")
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
    channels = static.make_channels(program.edge_cfg, dev,
                                    track_send_round=track_edge_send_round)
    nodes = program.init_state()
    key = torch.tensor([0, seed & 0xFFFFFFFF], dtype=torch.uint32).to(dev)
    return SimState(net=T.make_net(cfg, dev), nodes=nodes, key=key,
                    channels=channels, durable=program.durable_view(nodes))


def _freeze(stall, old, new):
    """Per-leaf select: stalled nodes keep their old row, live nodes take
    the stepped one. Leaves lead with the node axis."""
    def pick(o, n):
        m = stall.reshape(stall.shape + (1,) * (n.dim() - 1))
        return torch.where(m, o, n)
    return tree_map(pick, old, new)


# --- reply compaction (K4) -------------------------------------------------

def compact_replies_plain(flat: Msgs, K_: int, CC: int, next_mid):
    """The first CC valid rows of the flat [N * K] replies in index
    order, then the lowest-index invalid rows (the `top_k` order of the
    JAX version). src = row // K, mid = next_mid + cumsum(valid) - 1.
    Returns (replies Msgs [min(CC, N*K)], n_all)."""
    NK = flat.valid.shape[0]
    idx = torch.arange(NK, dtype=torch.int64, device=flat.valid.device)
    order = torch.sort((~flat.valid).to(torch.int64) * NK + idx
                       ).indices[:min(CC, NK)]
    rows = flat.at_rows(order)
    rows = rows.replace(
        src=(order // K_).to(I32),
        mid=next_mid + torch.cumsum(rows.valid, 0, dtype=I32) - 1)
    return rows, flat.valid.sum(dtype=I32)


def compact_replies(flat: Msgs, K_: int, CC: int, next_mid):
    """Client replies compacted into CC slots (see
    `compact_replies_plain`); the kernel is `csrc/compact.cu`."""
    if not K.use_kernel(flat.valid):
        return compact_replies_plain(flat, K_, CC, next_mid)
    NK = flat.valid.shape[0]
    CCe = min(CC, NK)
    dev = flat.valid.device
    for name in Msgs.__dataclass_fields__:
        t = getattr(flat, name)
        want = torch.bool if name == "valid" else I32
        if tuple(t.shape) != (NK,) or t.dtype != want:
            raise ValueError(f"compact_replies {name}: {tuple(t.shape)} "
                             f"{t.dtype}")
    if next_mid.shape != () or next_mid.dtype != I32:
        raise ValueError("compact_replies: next_mid must be an i32 scalar")
    out = Msgs(valid=torch.empty(CCe, dtype=torch.bool, device=dev),
               **{f: torch.empty(CCe, dtype=I32, device=dev)
                  for f in Msgs.__dataclass_fields__ if f != "valid"})
    n_all = torch.empty((), dtype=I32, device=dev)
    # per-segment valid counts (segments of 4096 rows, csrc/compact.cu)
    seg_count = torch.empty(-(-NK // 4096), dtype=I32, device=dev)
    ins = [getattr(flat, f).contiguous() for f in
           ("valid", "dest", "due", "reply_to", "type", "a", "b", "c")]
    outs = [getattr(out, f) for f in
            ("valid", "src", "dest", "due", "mid", "reply_to", "type", "a",
             "b", "c")]
    K.REPLY_COMPACT.launch(ins + [next_mid] + outs + [n_all, seg_count],
                           [NK, K_, CCe, seg_count.numel()], dev)
    return out, n_all


# --- the round -------------------------------------------------------------

def _round(program, cfg: NetConfig, sim: SimState, inject: Msgs):
    """One simulation round. `inject` is a flat Msgs batch of client
    requests (src = client index >= n_nodes). Returns (sim', client_msgs,
    io) as the JAX version does."""
    if not getattr(program, "is_edge", False):
        raise NotImplementedError(
            f"{program.name}: the pool-path round is not ported yet")
    return _round_edge(program, cfg, sim, inject)


def _round_edge(program, cfg: NetConfig, sim: SimState, inject: Msgs):
    N, Kc = cfg.n_nodes, program.inbox_cap
    ecfg = program.edge_cfg
    net, inject_sent = T._send(cfg, sim.net, inject)
    net, client_inbox, pool_client_msgs = T._deliver(cfg, net)
    ch, edge_in = static.edge_read(ecfg, sim.channels, program.neighbors,
                                   program.rev, net.round)
    nodes, edge_out, client_out = program.edge_step(
        sim.nodes, edge_in, client_inbox, {"round": net.round})

    # client replies bypass the pool (clients have zero latency,
    # net.clj:177-186): valid rows are compacted into the client buffer
    flat = tree_map(lambda f: f.reshape(N * Kc), client_out)
    CC = max(cfg.client_cap, 2 * cfg.n_clients, 1)
    replies, n_all = compact_replies(flat, Kc, CC, net.next_mid)
    st = net.stats
    net = net.replace(next_mid=net.next_mid + n_all, stats=st.replace(
        sent_all=st.sent_all + n_all, recv_all=st.recv_all + n_all,
        sent_by_type=T.count_by_type(st.sent_by_type, flat.type,
                                     flat.valid)))
    client_msgs = (replies if pool_client_msgs.valid.shape[0] == 0
                   else tree_map(lambda a, b: torch.cat([a, b]),
                                 pool_client_msgs, replies))

    # edge faults: component partitions block edges (net.clj:233); loss
    # and the other faults are later slices
    nb = program.neighbors
    comp = net.component
    blocked = ((comp[:N, None] != comp[nb.clamp(0, N - 1).long()])
               & (nb >= 0))
    shape = edge_out.valid.shape
    deliver_mask = (~blocked)[:, :, None].expand(shape)
    lat = T.draw_latency_rounds(cfg, net.latency_scale, shape)
    ch = static.edge_write(ecfg, ch, edge_out, net.round, lat, deliver_mask)

    n_sent = edge_out.valid.sum(dtype=I32)
    n_recv = edge_in.valid.sum(dtype=I32)
    st = net.stats
    net = net.replace(stats=st.replace(
        sent_all=st.sent_all + n_sent,
        sent_servers=st.sent_servers + n_sent,
        recv_all=st.recv_all + n_recv,
        recv_servers=st.recv_servers + n_recv,
        dropped_partition=st.dropped_partition
        + (edge_out.valid & blocked[:, :, None]).sum(dtype=I32),
        sent_by_type=T.count_by_type(st.sent_by_type, edge_out.type,
                                     edge_out.valid)))
    net = T.advance(net)
    return (SimState(net=net, nodes=nodes, key=sim.key, channels=ch,
                     durable=program.durable_view(nodes)),
            client_msgs,
            (inject_sent, replies, client_inbox, edge_out, edge_in))


def _check_no_draws(net: NetState) -> None:
    """Loss and duplication draw random numbers, which the PRNG slice
    ports. One host read per call, not per round."""
    if float(net.p_loss) != 0.0 or float(net.p_dup) != 0.0:
        raise NotImplementedError(
            "p_loss / p_dup > 0 need the PRNG slice")


def make_round_fn(program, cfg: NetConfig, device="cuda"):
    """round_fn(sim, inject) -> (sim', client_msgs, io): one round."""
    dev = resolve_device(device)
    T.check_scope(cfg)
    _check_program(program, cfg, dev)

    def round_fn(sim: SimState, inject: Msgs):
        _check_no_draws(sim.net)
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
        _check_no_draws(sim.net)
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
