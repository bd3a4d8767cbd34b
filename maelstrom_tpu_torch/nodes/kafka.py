"""Batched kafka-style replicated log (the workload of
`workloads/kafka.py`).

Counterpart of `maelstrom_tpu/nodes/kafka.py`, held against it by
`tests/test_torch_kafka.py`. Key k is owned by node k % N: only the owner
appends (a send elsewhere fails definitely with error 11, a full log with
14). Every node replicates every log over one edge lane a key carrying
(its length, the offset offered, the message): a node offers each
neighbour the entry at the offset it last advertised, every round while
the neighbour trails, and appends an incoming entry only where it lands
exactly at its own length, so replicas are hole-free prefixes. Lengths
are advertised when they change and on a `beat_rounds` heartbeat.
Polls are served from any replica: the reply carries the reply-round
lengths and the host slices the append-only log it reads from the node's
state row (`needs_state_reads`, `state_reads_final`). Committed offsets
live on node 0, the coordinator, as a max-merged row.

With `kafka_groups` G > 0 the workload runs consumer groups: the
coordinator row keeps each group's members (`gactive`, `gseen`), its
generation `ggen` and its committed offsets `gcommitted`; members whose
heartbeat is older than the session timeout are evicted, a fenced commit
rejoins, keys are assigned round-robin over the members by rank, and
polls become cursor fetches.

`edge_step` has a hand-written CUDA kernel, K14 `kafka_step`
(`csrc/kafka.cu`), and the plain PyTorch version `edge_step_plain`."""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels as K
from ..net.static import EdgeConfig, EdgeMsgs, reverse_index
from ..net.tpu import I32
from ..tree import resolve_device
from ..workloads.broadcast import TOPOLOGIES, topology_indices
from . import (EncodeCapacityError, NodeProgram, T_ERROR, edge_capacity,
               edge_timing, freeze_step, register)

T_SEND = 10        # a = key, b = interned msg
T_SEND_OK = 11     # a = offset
T_POLL = 12
T_POLL_OK = 13     # a|b|c = packed reply-round log lengths (+1)
T_COMMIT = 14      # a|b|c = packed per-key offsets (+1, 16 bits each)
T_COMMIT_OK = 15
T_LIST = 16
T_LIST_OK = 17     # a|b|c = packed committed offsets (+1)
T_REPL = 20        # edge lane k: a = sender len, b = offset, c = msg

# consumer-group protocol (kafka_groups > 0)
T_SUB = 30         # a = group<<10 | member
T_SUB_OK = 31      # a = generation, b|c = packed key->member assignment
T_FETCH = 32       # a = group<<10 | member, b = key<<16 | (cursor+1),
                   # c = max batch
T_FETCH_OK = 33    # a = key<<16 | (start+1), b = n entries
T_GCOMMIT = 34     # a = bank<<30 | group<<26 | member<<16 | gen16,
                   # b|c = packed offsets of the 4-key bank named
T_GCOMMIT_OK = 35  # a = bank<<30 | gen30, b|c echo the applied offsets
T_REBAL = 36       # fenced commit: a = new generation, b|c = assignment
T_GLIST = 37       # a = bank<<30 | group
T_GLIST_OK = 38    # a = bank<<30 | gen30, b|c = packed committed (+1)

MAX_PACK_KEYS = 6  # 2 x 16-bit fields per wire word, 3 words
BANK_KEYS = 4      # keys per commit bank (2 words x 2 fields)
MAX_GROUP_KEYS = 2 * BANK_KEYS
MAX_GROUPS = 16    # group id rides 4 header bits
MAX_MEMBERS = 254  # 8-bit member+1 fields of the packed assignment
COORDINATOR = 0    # node holding the committed offsets and the groups

# the order of the kernel's pointer arguments (struct StepArgs in
# csrc/kafka.cu)
_STATE = ("log", "log_len", "peer_len", "committed", "log_overflow")
_GROUP = ("gactive", "gseen", "ggen", "gcommitted")
_EDGE = ("valid", "type", "a", "b", "c")
_CLIENT_IN = ("valid", "src", "due", "mid", "type", "a", "b", "c")
_CLIENT_OUT = ("valid", "src", "dest", "due", "mid", "reply_to", "type",
               "a", "b", "c")


def _pack_offsets(offs: dict, keys: int, base: int = 0) \
        -> tuple[int, int, int]:
    """Packs offsets for keys [base, base+keys) into up to three wire
    words (field j = key base+j)."""
    words = [0, 0, 0]
    for j in range(keys):
        k = base + j
        o = offs.get(str(k), offs.get(k))
        if o is None:
            continue
        if o >= 0x7FFF:
            raise EncodeCapacityError(
                f"kafka committed offset {o} exceeds the 15-bit wire "
                f"field")
        words[j // 2] |= (int(o) + 1) << (16 * (j % 2))
    return words[0], words[1], words[2]


def _device_pack(vals_plus1):
    """[N, K] int32 (0 = absent, v+1 otherwise) -> three packed wire
    words (16-bit fields, 2 a word), keys 0..5 only."""
    words = [torch.zeros(vals_plus1.shape[0], dtype=I32,
                         device=vals_plus1.device) for _ in range(3)]
    for k in range(min(vals_plus1.shape[1], MAX_PACK_KEYS)):
        words[k // 2] = words[k // 2] | (vals_plus1[:, k]
                                         << (16 * (k % 2)))
    return words


def _unpack_offsets(a: int, b: int, c: int, keys: int,
                    base: int = 0) -> dict:
    out = {}
    for j in range(keys):
        v = ((a, b, c)[j // 2] >> (16 * (j % 2))) & 0xFFFF
        if v:
            out[str(base + j)] = v - 1
    return out


def _unpack_assign(b: int, c: int, keys: int) -> dict:
    """Two packed assignment words -> {key: member or None} (8-bit
    member+1 fields, keys 0..3 in b, 4..7 in c)."""
    out = {}
    for k in range(keys):
        v = ((b, c)[k // 4] >> (8 * (k % 4))) & 0xFF
        out[k] = (v - 1) if v else None
    return out


def _field(w, shift):
    """The 16-bit field at `shift` of int32 words, minus 1 (arithmetic
    shift, as jnp's `>>` on int32)."""
    return ((w >> shift) & 0xFFFF) - 1


@register
class KafkaProgram(NodeProgram):
    name = "kafka"
    is_edge = True
    needs_state_reads = True            # polls read replica rows
    # logs are append-only and replicas hole-free, and poll replies carry
    # their reply-round lengths: a state read at the end of a stretch,
    # sliced to those lengths, is exact, so the runner may cross
    # reply-bearing stretches
    state_reads_final = True
    # entry offers repeat while a neighbour trails and a lost length
    # advert is covered by the beat: an overwritten lane only delays
    tolerates_channel_overwrites = True
    quiet_planes = None                 # the beat timer ticks forever

    def __init__(self, opts, nodes, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.K = int(opts.get("key_count") or 4)
        key_cap = (MAX_GROUP_KEYS if int(opts.get("kafka_groups") or 0)
                   else MAX_PACK_KEYS)
        if self.K > key_cap:
            raise ValueError(
                f"kafka supports at most {key_cap} keys on the wire for "
                f"this mode (got {self.K}); shard keys across runs")
        rate = float(opts.get("rate") or 0.0)
        tl = float(opts.get("time_limit") or 0.0)
        # cap+1 must fit a 15-bit packed length field
        self.cap = int(opts.get("log_cap",
                                min(max(64, int(rate * tl) + 32), 0x7FFE)))
        if self.cap > 0x7FFE:
            raise ValueError(
                f"kafka log_cap {self.cap} exceeds the 15-bit packed "
                f"length field (max {0x7FFE})")
        topo = TOPOLOGIES["total"](nodes)
        nb = topology_indices(topo, nodes)
        self.neighbors = torch.tensor(nb, dtype=I32, device=self.device)
        self.rev = torch.tensor(reverse_index(nb), dtype=I32,
                                device=self.device)
        self.D = int(nb.shape[1])
        self.lanes = self.K                 # one replication lane a key
        self.ring, _retry, _lat = edge_timing(opts, len(nodes))
        self.inbox_cap = int(opts.get("inbox_cap", 4))
        self.outbox_cap = self.inbox_cap
        spill, chan_lanes, uniform = edge_capacity(opts, self)
        if spill or chan_lanes != self.lanes:
            raise ValueError("kafka lanes are positional (one per key); "
                             "spill must be off")
        self._host_polled: dict = {}   # key -> max offset seen by polls
        self.beat_rounds = int(opts.get("beat_rounds", 64))
        self.G = int(opts.get("kafka_groups") or 0)
        self.M = 0
        self.session_rounds = 0
        if self.G:
            if self.G > MAX_GROUPS:
                raise ValueError(f"kafka_groups {self.G} exceeds the "
                                 f"packed header width ({MAX_GROUPS})")
            self._list_bank = 0     # glist bank rotation (host side)
            self.M = int(opts.get("concurrency") or len(nodes))
            if self.M > MAX_MEMBERS:
                raise ValueError(f"{self.M} workers exceed the member "
                                 f"field width ({MAX_MEMBERS})")
            ms_pr = float(opts.get("ms_per_round", 1.0))
            self.session_rounds = max(2, int(
                float(opts.get("session_timeout_ms", 2500.0)) / ms_pr))
            self.poll_batch = max(1, int(opts.get("poll_batch", 8)))
            # per-worker subscription sessions: generation, assigned
            # keys, fetch cursors, known committed floors, round-robin
            self._subs: dict = {}
        self.edge_cfg = EdgeConfig(n_nodes=self.n_nodes, degree=self.D,
                                   lanes=self.lanes, ring=self.ring,
                                   uniform_arrival=uniform)

    def init_state(self):
        N, K, C, dev = self.n_nodes, self.K, self.cap, self.device

        def z(*s):
            return torch.zeros(s, dtype=I32, device=dev)
        s = {"log": z(N, K, C), "log_len": z(N, K),
             "peer_len": z(N, self.D, K),
             "committed": torch.full((N, K), -1, dtype=I32, device=dev),
             "log_overflow": z(N)}
        if self.G:
            G, M = self.G, self.M
            s["gactive"] = torch.zeros((N, G, M), dtype=torch.bool,
                                       device=dev)
            s["gseen"] = z(N, G, M)
            s["ggen"] = z(N, G)
            s["gcommitted"] = torch.full((N, G, K), -1, dtype=I32,
                                         device=dev)
        return s

    def invalid_counters(self, state):
        return {"log-overflow": state["log_overflow"]}

    # --- plain version ----------------------------------------------------

    def edge_step_plain(self, state, edge_in: EdgeMsgs, client_in, round_):
        N, K, C, D = self.n_nodes, self.K, self.cap, self.D
        dev = edge_in.valid.device
        me = torch.arange(N, dtype=torch.int64, device=dev)
        keys = torch.arange(K, dtype=torch.int64, device=dev)
        # the step updates copies in place: the input state stays as it is
        s = {k: v.clone() for k, v in state.items()}
        log, log_len = s["log"], s["log_len"]

        # inbound replication (lane k = key k)
        rep_valid = edge_in.valid & (edge_in.type == T_REPL)  # [N, D, K]
        s["peer_len"] = torch.where(rep_valid, edge_in.a, s["peer_len"])
        # accept the offered entry iff it lands exactly at my length; the
        # lowest offering edge wins (argmax's first maximum)
        offer = rep_valid & (edge_in.b == log_len[:, None, :]) \
            & (edge_in.b < edge_in.a) & (edge_in.b < C)
        any_offer = offer.any(dim=1)                          # [N, K]
        pick = torch.argmax(offer.to(I32), dim=1)             # [N, K]
        val = torch.gather(edge_in.c, 1, pick[:, None, :])[:, 0]
        n_i, k_i = any_offer.nonzero(as_tuple=True)
        log[n_i, k_i, log_len[n_i, k_i].long()] = val[n_i, k_i]
        log_len += any_offer.to(I32)
        changed = any_offer

        if self.G:
            # evict members whose heartbeat is older than the session
            # timeout (every row, not only the coordinator's)
            expired = s["gactive"] & ((round_ - s["gseen"])
                                      > self.session_rounds)
            s["gactive"] &= ~expired
            s["ggen"] += expired.any(dim=-1).to(I32)

        A = client_in.valid.shape[1]
        outs = []
        is_leader0 = me == COORDINATOR
        for j in range(A):
            v = client_in.valid[:, j]
            t = client_in.type[:, j]
            aw, bw, cw = (client_in.a[:, j], client_in.b[:, j],
                          client_in.c[:, j])
            key = aw.clamp(0, K - 1).long()
            owner = (key % N) == me
            is_send = v & (t == T_SEND)
            off = log_len[me, key]
            full = off >= C
            do_send = is_send & owner & ~full
            sn = do_send.nonzero(as_tuple=True)[0]
            log[sn, key[sn], off[sn].long()] = bw[sn]
            log_len[me, key] += do_send.to(I32)
            changed = changed | (do_send[:, None] & (keys[None, :]
                                                     == key[:, None]))
            send_full = is_send & owner & full
            s["log_overflow"] += send_full.to(I32)
            # commit: the coordinator maxes its committed row with the
            # packed map (keys 0..5; every slot maxes with -1 at least)
            is_cmt = v & (t == T_COMMIT) & is_leader0
            committed = s["committed"]
            for k in range(min(K, MAX_PACK_KEYS)):
                o = _field((aw, bw, cw)[k // 2], 16 * (k % 2))
                committed[:, k] = torch.maximum(
                    committed[:, k], torch.where(is_cmt, o, -1))
            is_list = v & (t == T_LIST) & is_leader0
            la, lb, lc = _device_pack(torch.where(committed >= 0,
                                                  committed + 1, 0))
            is_poll = v & (t == T_POLL)
            misrouted = v & (((t == T_SEND) & ~owner)
                             | (((t == T_COMMIT) | (t == T_LIST))
                                & ~is_leader0))
            pa, pb, pc = _device_pack(log_len + 1)
            rtype = torch.where(
                do_send, T_SEND_OK,
                torch.where(is_cmt, T_COMMIT_OK,
                            torch.where(is_list, T_LIST_OK,
                                        torch.where(is_poll, T_POLL_OK,
                                                    T_ERROR))))
            ra = torch.where(
                do_send, off,
                torch.where(is_cmt, aw,
                            torch.where(is_list, la,
                                        torch.where(is_poll, pa,
                                                    torch.where(send_full,
                                                                14, 11)))))
            rb = torch.where(is_cmt, bw,
                             torch.where(is_list, lb,
                                         torch.where(is_poll, pb, 0)))
            rc = torch.where(is_cmt, cw,
                             torch.where(is_list, lc,
                                         torch.where(is_poll, pc, 0)))
            say = v & (do_send | is_cmt | is_list | is_poll | misrouted
                       | send_full)
            if self.G:
                rtype, ra, rb, rc, say = self._group_slot(
                    s, round_, v, t, aw, bw, cw, is_leader0,
                    (rtype, ra, rb, rc, say))
            outs.append((say, rtype.to(I32), ra.to(I32), rb.to(I32),
                         rc.to(I32)))

        def stack(i):
            return torch.stack([o[i] for o in outs], dim=1)
        client_out = client_in.replace(
            valid=stack(0), dest=client_in.src, type=stack(1), a=stack(2),
            b=stack(3), c=stack(4), reply_to=client_in.mid,
            src=me.to(I32)[:, None].expand(N, A).contiguous())

        # outbound replication: offer each neighbour, per key, the entry
        # at the offset it last advertised as its length
        want = s["peer_len"]                                   # [N, D, K]
        have = s["log_len"][:, None, :].expand(N, D, K)
        pos = want.clamp(0, C - 1).transpose(1, 2).long()      # [N, K, D]
        entry = torch.gather(s["log"], 2, pos).transpose(1, 2)
        beat = torch.remainder(round_, self.beat_rounds) == 0
        edge_out = EdgeMsgs(
            valid=(((want < have) | beat | changed[:, None, :])
                   & (self.neighbors >= 0)[:, :, None]),
            type=torch.full((N, D, K), T_REPL, dtype=I32, device=dev),
            a=have.contiguous(), b=want,
            c=torch.where(want < have, entry, 0))
        return s, edge_out, client_out

    def _group_slot(self, s, round_, v, t, aw, bw, cw, is_leader0, legacy):
        """One inbox slot's consumer-group RPCs, overlaid on the legacy
        reply chain (the wire types are disjoint); updates the group
        leaves of `s`."""
        N, K, G, M = self.n_nodes, self.K, self.G, self.M
        rtype, ra, rb, rc, say = legacy
        dev = v.device
        me = torch.arange(N, dtype=torch.int64, device=dev)
        is_sub = v & (t == T_SUB) & is_leader0
        is_fetch = v & (t == T_FETCH)
        is_gcmt = v & (t == T_GCOMMIT) & is_leader0
        is_glist = v & (t == T_GLIST) & is_leader0
        g_mis = v & ((t == T_SUB) | (t == T_GCOMMIT)
                     | (t == T_GLIST)) & ~is_leader0
        g_any = torch.where(is_gcmt, (aw >> 26) & 0xF,
                            torch.where(is_glist, aw & 0xFFFF, aw >> 10)
                            ).clamp(0, G - 1).long()
        bank = torch.where(is_gcmt | is_glist, (aw >> 30) & 1, 0)
        m_any = torch.where(is_gcmt, (aw >> 16) & 0x3FF,
                            aw & 1023).clamp(0, M - 1).long()
        gen16 = aw & 0xFFFF
        # fencing is judged against the pre-join state
        gactive, gseen, ggen, gcommitted = (
            s["gactive"], s["gseen"], s["ggen"], s["gcommitted"])
        old_act = gactive[me, g_any, m_any]
        old_gen = ggen[me, g_any]
        fenced = is_gcmt & (((old_gen & 0xFFFF) != gen16) | ~old_act)
        ok_cmt = is_gcmt & ~fenced
        join = is_sub | fenced
        newly = join & ~old_act
        gactive[me, g_any, m_any] = old_act | join
        beats = is_sub | is_gcmt
        gseen[me, g_any, m_any] = torch.where(
            beats, round_, gseen[me, g_any, m_any])
        ggen[me, g_any] += newly.to(I32)
        new_gen = ggen[me, g_any]
        asg = self._assign_members(gactive[me, g_any])       # [N, K]
        asg_b, asg_c = self._pack_assign(asg)
        # a non-fenced commit advances the member's own assigned keys in
        # the bank the header names; every slot maxes with -1 at least
        for k in range(K):
            kb, kj = divmod(k, BANK_KEYS)
            o = _field(bw if kj < 2 else cw, 16 * (kj % 2))
            mine = ok_cmt & (asg[:, k] == m_any) & (bank == kb)
            gcommitted[me, g_any, k] = torch.maximum(
                gcommitted[me, g_any, k], torch.where(mine, o, -1))
        gc = gcommitted[me, g_any]
        gplus = torch.where(gc >= 0, gc + 1, 0)

        def bank_words(base):
            wb = torch.zeros(N, dtype=I32, device=dev)
            wc = torch.zeros(N, dtype=I32, device=dev)
            for kj in range(min(BANK_KEYS, K - base)):
                f = gplus[:, base + kj] << (16 * (kj % 2))
                if kj < 2:
                    wb = wb | f
                else:
                    wc = wc | f
            return wb, wc
        glb, glc = bank_words(0)
        if K > BANK_KEYS:
            wb1, wc1 = bank_words(BANK_KEYS)
            glb = torch.where(bank == 1, wb1, glb)
            glc = torch.where(bank == 1, wc1, glc)
        # cursor fetch, served from any replica
        fk = (bw >> 16).clamp(0, K - 1)
        fcur = (bw & 0xFFFF) - 1
        flen = s["log_len"][me, fk.long()]
        fn = torch.where(fcur >= 0, torch.minimum(
            (flen - fcur).clamp(min=0), cw.clamp(0, 0x7FFF)), 0)
        rtype = torch.where(
            is_fetch, T_FETCH_OK,
            torch.where(is_sub, T_SUB_OK,
                        torch.where(fenced, T_REBAL,
                                    torch.where(ok_cmt, T_GCOMMIT_OK,
                                                torch.where(is_glist,
                                                            T_GLIST_OK,
                                                            rtype)))))
        gen_banked = (new_gen & 0x3FFFFFFF) | (bank << 30)
        ra = torch.where(is_fetch, (fk << 16) | (fcur + 1),
                         torch.where(ok_cmt | is_glist, gen_banked,
                                     torch.where(is_sub | fenced, new_gen,
                                                 ra)))
        rb = torch.where(is_fetch, fn,
                         torch.where(is_sub | fenced, asg_b,
                                     torch.where(ok_cmt, bw,
                                                 torch.where(is_glist, glb,
                                                             rb))))
        rc = torch.where(is_sub | fenced, asg_c,
                         torch.where(ok_cmt, cw,
                                     torch.where(is_glist, glc,
                                                 torch.where(is_fetch, 0,
                                                             rc))))
        say = say | is_fetch | is_sub | fenced | ok_cmt | is_glist | g_mis
        return rtype, ra, rb, rc, say

    def _assign_members(self, gactive):
        """[..., M] active-member mask -> [..., K] i32 member a key (-1 =
        unassigned): key k goes to the member of rank (k mod count) in
        member-id order."""
        K = self.K
        cnt = gactive.sum(dim=-1, dtype=I32)
        rank = torch.cumsum(gactive.to(I32), dim=-1) - 1
        ks = torch.arange(K, dtype=I32, device=gactive.device)
        want = torch.remainder(ks, cnt[..., None].clamp(min=1))
        hit = gactive[..., None, :] & (rank[..., None, :]
                                       == want[..., :, None])  # [..., K, M]
        mem = torch.argmax(hit.to(I32), dim=-1).to(I32)
        return torch.where(hit.any(dim=-1), mem, -1)

    def _pack_assign(self, asg):
        """[N, K] member a key -> two packed wire words (8-bit member+1
        fields, four a word; int32 shifts wrap)."""
        b = torch.zeros(asg.shape[0], dtype=I32, device=asg.device)
        c = torch.zeros_like(b)
        for k in range(self.K):
            f = torch.where(asg[:, k] >= 0, asg[:, k] + 1, 0)
            if k < 4:
                b = b | (f << (8 * k))
            else:
                c = c | (f << (8 * (k - 4)))
        return b, c

    # --- kernel -----------------------------------------------------------

    def _edge_step_kernel(self, state, edge_in, client_in, round_, stall):
        N, C, D, G, M = self.n_nodes, self.cap, self.D, self.G, self.M
        nk = self.K
        dev = edge_in.valid.device
        A = client_in.valid.shape[1]
        want = [("log", (N, nk, C), I32), ("log_len", (N, nk), I32),
                ("peer_len", (N, D, nk), I32), ("committed", (N, nk), I32),
                ("log_overflow", (N,), I32)]
        if G:
            want += [("gactive", (N, G, M), torch.bool),
                     ("gseen", (N, G, M), I32), ("ggen", (N, G), I32),
                     ("gcommitted", (N, G, nk), I32)]
        checks = [(k, state[k], shape, dt) for k, shape, dt in want]
        checks += [(f"edge_in.{f}", getattr(edge_in, f), (N, D, nk),
                    torch.bool if f == "valid" else I32) for f in _EDGE]
        checks += [(f"client_in.{f}", getattr(client_in, f), (N, A),
                    torch.bool if f == "valid" else I32)
                   for f in _CLIENT_IN]
        checks += [("round", round_, (), I32)]
        if stall is not None:
            checks.append(("stall", stall, (N,), torch.bool))
        for name, t, shape, dtype in checks:
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"kafka_step {name}: {tuple(t.shape)} "
                                 f"{t.dtype}, expected {shape} {dtype}")
        names = _STATE + (_GROUP if G else ())
        # out of place: the kernel appends into a copy of the log
        new_state = {k: torch.empty_like(
            state[k], memory_format=torch.contiguous_format) for k in names}
        new_state["log"].copy_(state["log"])
        edge_out = EdgeMsgs(**{f: torch.empty(
            (N, D, nk), dtype=torch.bool if f == "valid" else I32,
            device=dev) for f in _EDGE})
        client_out = type(client_in)(**{f: torch.empty(
            (N, A), dtype=torch.bool if f == "valid" else I32, device=dev)
            for f in _CLIENT_OUT})

        def group(src):
            return [src[k].contiguous() if G else None for k in _GROUP]
        K.KAFKA_STEP.launch(
            [state[k].contiguous() for k in _STATE] + group(state)
            + [getattr(edge_in, f).contiguous() for f in _EDGE]
            + [getattr(client_in, f).contiguous() for f in _CLIENT_IN]
            + [self.neighbors, round_,
               None if stall is None else stall.contiguous()]
            + [new_state[k] for k in _STATE] + group(new_state)
            + [getattr(edge_out, f) for f in _EDGE]
            + [getattr(client_out, f) for f in _CLIENT_OUT],
            [N, D, nk, C, A, G, M, self.session_rounds, self.beat_rounds],
            dev)
        return new_state, edge_out, client_out

    def edge_step(self, state, edge_in: EdgeMsgs, client_in, ctx):
        """(state, edge_in [N, D, K], client_in Msgs [N, A], ctx) ->
        (state', edge_out [N, D, K], client_out Msgs [N, A]).
        ctx["round"] is an i32 scalar tensor; ctx.get("stall"), when
        given, the [N] bool mask of killed or paused nodes, which keep
        their state and emit no valid row. The input state is never
        updated."""
        stall = ctx.get("stall")
        if K.use_kernel(edge_in.valid):
            return self._edge_step_kernel(state, edge_in, client_in,
                                          ctx["round"], stall)
        return freeze_step(stall, state, *self.edge_step_plain(
            state, edge_in, client_in, ctx["round"]))

    # --- host boundary ---

    def owner_of(self, key: int) -> int:
        """Key ownership: the device's owner mask and the host routing
        agree (in-range keys only; encode_body rejects the rest)."""
        return int(key) % self.n_nodes

    def node_for_op(self, op):
        # smart-client routing: sends to the key's owner, commit/list to
        # the coordinator; polls to any replica (the worker's own node)
        if op["f"] == "send":
            k = int(op["value"][0])
            return self.owner_of(k) if 0 <= k < self.K else None
        if self.G:
            if op["f"] in ("subscribe", "commit", "list"):
                return COORDINATOR
            if op["f"] == "poll":
                # an unsubscribed (or unassigned) worker's poll becomes a
                # coordinator-routed subscribe
                sub = self._subs.get(int(op["process"]))
                if sub is None or not sub["keys"]:
                    return COORDINATOR
                return None
            return None
        if op["f"] in ("commit", "list"):
            return COORDINATOR
        return None

    def _group_request(self, op):
        """The host half of a consumer session: each worker is one group
        member; polls round-robin cursor fetches over its assigned keys,
        commits claim exactly its cursors, and anything without a live
        subscription becomes a subscribe."""
        member = int(op["process"])
        g = member % self.G
        sub = self._subs.get(member)
        f = op["f"]
        if f == "subscribe" or (f in ("poll", "commit") and sub is None) \
                or (f == "poll" and not sub["keys"]):
            return {"type": "subscribe", "group": g, "member": member}
        if f == "poll":
            keys = sub["keys"]
            k = keys[sub["rr"] % len(keys)]
            sub["rr"] += 1
            return {"type": "fetch", "group": g, "member": member,
                    "key": k, "cursor": int(sub["cursors"].get(k, 0)),
                    "batch": self.poll_batch}
        if f == "commit":
            # claim everything this member consumed on its own keys (an
            # empty claim still round-trips: it is the heartbeat); one
            # 4-key bank a commit, rotating over the banks with claims
            offs_all = {k: sub["cursors"][k] - 1 for k in sub["keys"]
                        if sub["cursors"].get(k, 0) > 0}
            banks = sorted({k // BANK_KEYS for k in offs_all}) or [0]
            cb = int(sub.get("cb", 0))
            sub["cb"] = cb + 1
            bank = banks[cb % len(banks)]
            offs = {k: v for k, v in offs_all.items()
                    if k // BANK_KEYS == bank}
            return {"type": "commit_group", "group": g,
                    "member": member, "gen": int(sub["gen"]),
                    "bank": bank, "offsets": offs}
        bank = 0
        if self.K > BANK_KEYS:
            # lists rotate banks too
            bank = self._list_bank % ((self.K + BANK_KEYS - 1)
                                      // BANK_KEYS)
            self._list_bank += 1
        return {"type": "list_group", "group": g, "bank": bank}

    def request_for_op(self, op):
        f = op["f"]
        if f == "send":
            k, m = op["value"]
            return {"type": "send", "key": int(k), "msg": m}
        if self.G:
            return self._group_request(op)
        if f == "poll":
            return {"type": "poll"}
        if f == "commit":
            # the max offset any completed poll observed a key: a legal
            # commit claim, deterministic given the history
            offs = op.get("value") or dict(self._host_polled)
            return {"type": "commit_offsets", "offsets": offs}
        return {"type": "list_committed_offsets"}

    def encode_body(self, body, intern):
        t = body["type"]
        if t == "send":
            if not 0 <= int(body["key"]) < self.K:
                # the device clips keys into range, which would append to
                # the wrong log: fail the op definitely instead
                raise EncodeCapacityError(
                    f"kafka key {body['key']} outside configured "
                    f"key_count {self.K}")
            return (T_SEND, int(body["key"]), intern.id(body["msg"]), 0)
        if t == "poll":
            return (T_POLL, 0, 0, 0)
        if t == "commit_offsets":
            a, b, c = _pack_offsets(body["offsets"],
                                    min(self.K, MAX_PACK_KEYS))
            return (T_COMMIT, a, b, c)
        if t == "subscribe":
            return (T_SUB,
                    (int(body["group"]) << 10) | int(body["member"]),
                    0, 0)
        if t == "fetch":
            cur = int(body["cursor"])
            if cur > 0x7FFE:
                raise EncodeCapacityError(
                    f"kafka fetch cursor {cur} exceeds the 15-bit wire "
                    f"field")
            return (T_FETCH,
                    (int(body["group"]) << 10) | int(body["member"]),
                    (int(body["key"]) << 16) | (cur + 1),
                    int(body["batch"]))
        if t == "commit_group":
            bank = int(body.get("bank", 0))
            w = _pack_offsets(body["offsets"],
                              min(BANK_KEYS, self.K - BANK_KEYS * bank),
                              base=BANK_KEYS * bank)
            return (T_GCOMMIT,
                    (bank << 30)
                    | (int(body["group"]) << 26)
                    | (int(body["member"]) << 16)
                    | (int(body["gen"]) & 0xFFFF), w[0], w[1])
        if t == "list_group":
            return (T_GLIST,
                    (int(body.get("bank", 0)) << 30)
                    | int(body["group"]), 0, 0)
        return (T_LIST, 0, 0, 0)

    def decode_body(self, t, a, b, c, intern):
        pk = min(self.K, MAX_PACK_KEYS)
        if t == T_SEND_OK:
            return {"type": "send_ok", "offset": int(a)}
        if t == T_COMMIT_OK:
            return {"type": "commit_offsets_ok",
                    "offsets": _unpack_offsets(int(a), int(b), int(c), pk)}
        if t == T_LIST_OK:
            return {"type": "list_committed_offsets_ok",
                    "offsets": _unpack_offsets(int(a), int(b), int(c), pk)}
        if t == T_POLL_OK:
            return {"type": "poll_ok",
                    "lens": _unpack_offsets(int(a), int(b), int(c), pk)}
        if t == T_SUB_OK:
            return {"type": "subscribe_ok", "gen": int(a),
                    "assign": _unpack_assign(int(b), int(c), self.K)}
        if t == T_FETCH_OK:
            return {"type": "fetch_ok", "key": int(a) >> 16,
                    "start": (int(a) & 0xFFFF) - 1, "n": int(b)}
        if t in (T_GCOMMIT_OK, T_GLIST_OK):
            bank = (int(a) >> 30) & 1
            body = {"type": "commit_group_ok" if t == T_GCOMMIT_OK
                    else "list_group_ok",
                    "gen": int(a) & 0x3FFFFFFF,
                    "offsets": _unpack_offsets(
                        int(b), int(c), 0,
                        min(BANK_KEYS, self.K - BANK_KEYS * bank),
                        base=BANK_KEYS * bank)}
            if t == T_GLIST_OK:
                body["bank"] = bank
            return body
        if t == T_REBAL:
            return {"type": "rebalance", "gen": int(a),
                    "assign": _unpack_assign(int(b), int(c), self.K)}
        if t == T_ERROR:
            return {"type": "error", "code": int(a),
                    "text": ("log full" if int(a) == 14 else
                             "misrouted (owner/coordinator elsewhere)")}
        return super().decode_body(t, a, b, c, intern)

    def _apply_assignment(self, op, body):
        """Folds a subscribe_ok/rebalance reply into the worker's
        session: generation, assigned keys, and fetch cursors for newly
        assigned keys, resumed from the group's committed floor as far as
        this member knows it."""
        member = int(op["process"])
        keys = sorted(k for k, m2 in body["assign"].items()
                      if m2 == member)
        sub = self._subs.setdefault(
            member, {"cursors": {}, "known_commit": {}, "rr": 0})
        old = set(sub.get("keys") or ())
        sub["group"] = member % self.G
        sub["gen"] = int(body["gen"])
        sub["keys"] = keys
        for k in keys:
            if k not in old or k not in sub["cursors"]:
                sub["cursors"][k] = sub["known_commit"].get(k, -1) + 1
        return keys

    def host_state(self):
        st = {"polled": dict(self._host_polled)}
        if self.G:
            st["subs"] = {m: {**s, "cursors": dict(s["cursors"]),
                              "known_commit": dict(s["known_commit"]),
                              "keys": list(s.get("keys") or ())}
                          for m, s in self._subs.items()}
            st["lb"] = self._list_bank
        return st

    def set_host_state(self, st):
        if not st:
            return
        self._host_polled = dict(st.get("polled") or {})
        if self.G:
            self._subs = {m: dict(s)
                          for m, s in (st.get("subs") or {}).items()}
            self._list_bank = int(st.get("lb", 0))

    def _learn_commits(self, member: int, offsets: dict):
        sub = self._subs.get(member)
        if sub is not None:
            for k, o in offsets.items():
                ik = int(k)
                sub["known_commit"][ik] = max(
                    sub["known_commit"].get(ik, -1), int(o))

    def completion(self, op, body, read_state, intern):
        kind = body["type"]
        if kind == "subscribe_ok":
            keys = self._apply_assignment(op, body)
            if op["f"] == "subscribe":
                return {**op, "type": "ok",
                        "value": {"gen": body["gen"], "assigned": keys}}
            # a subscribe on behalf of a poll or commit observed nothing
            return {**op, "type": "ok", "value": {}}
        if kind == "rebalance":
            # a fenced commit did not apply; the session rejoins
            self._apply_assignment(op, body)
            return {**op, "type": "fail",
                    "error": ["rebalanced", int(body["gen"])]}
        if kind == "fetch_ok":
            member = int(op["process"])
            k, start, n = body["key"], max(int(body["start"]), 0), \
                int(body["n"])
            pairs = []
            if n:
                # reply-round entry count over the append-only log
                log = np.asarray(read_state()["log"])
                pairs = [[o, intern.value(int(log[k, o]))]
                         for o in range(start, start + n)]
                sub = self._subs.get(member)
                if sub is not None:
                    sub["cursors"][k] = max(
                        int(sub["cursors"].get(k, 0)), start + n)
            return {**op, "type": "ok", "value": {str(k): pairs}}
        if kind in ("commit_group_ok", "list_group_ok"):
            member = int(op["process"])
            offs = {str(k): int(v)
                    for k, v in body.get("offsets", {}).items()}
            self._learn_commits(member, offs)
            value = {"group": member % self.G, "offsets": offs}
            if kind == "list_group_ok" and self.K > BANK_KEYS:
                # banked lists observe one bank: name its keys
                bank = int(body.get("bank", 0))
                value["keys"] = [
                    str(k) for k in range(BANK_KEYS * bank,
                                          min(BANK_KEYS * (bank + 1),
                                              self.K))]
            return {**op, "type": "ok", "value": value}
        if kind == "send_ok":
            k, m = op["value"]
            return {**op, "type": "ok",
                    "value": [str(k), m, body["offset"]]}
        if kind == "poll_ok":
            # slicing the final (append-only) log to the reply-round
            # lengths gives the exact replica prefix of the reply round
            log = np.asarray(read_state()["log"])
            reply_lens = body.get("lens", {})
            msgs = {}
            for k in range(self.K):
                n = int(reply_lens.get(str(k), 0))
                if n:
                    msgs[str(k)] = [[o, intern.value(int(log[k, o]))]
                                    for o in range(n)]
                    self._host_polled[str(k)] = max(
                        self._host_polled.get(str(k), -1), n - 1)
            return {**op, "type": "ok", "value": msgs}
        if kind == "commit_offsets_ok":
            return {**op, "type": "ok", "value": body.get("offsets", {})}
        if kind == "list_committed_offsets_ok":
            return {**op, "type": "ok", "value": body["offsets"]}
        return {**op, "type": "ok"}
