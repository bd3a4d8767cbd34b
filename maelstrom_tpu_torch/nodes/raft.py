"""Batched Raft serving lin-kv: every node of every cluster steps at once.

Counterpart of `maelstrom_tpu/nodes/raft.py` (`RaftProgram`, `LinKVWire`),
held against it by `tests/test_torch_raft.py`: leader election with
randomized timeouts, log replication with conflict truncation, majority
commit, and a KV state machine applied in log order (reads are logged
too, so every operation linearizes at its apply point).

Every rule is a masked update over node rows: `role` is data, not
control flow. The cluster topology is the full mesh over the static edge
channels, with per-edge lanes

  lane 0: request   RequestVote or AppendEntries header
  lane 1: reply     vote or append result
  lane 2: proxy     a non-leader forwards one client request a round to
                    its known leader
  lanes 3..3+E:     log entries riding an AppendEntries header

and log entries packed into three words (term/key/op | client/values |
request mid).

A state leaf leads with the node axis `[N, ...]` for one cluster, or with
`[F, N, ...]` on the cluster axis (`parallel.make_cluster_round_fn`),
where the step (`step_rows`) sees the `F * N` node rows of the contiguous
leaf at once. The step is kernel K10 `raft_step` (`csrc/raft.cu`), with
the stall mask of killed and paused nodes fused in; `edge_step_plain` is
its plain PyTorch version."""

from __future__ import annotations

import torch

from .. import kernels as K
from .. import prng
from ..net.static import EdgeConfig, EdgeMsgs, reverse_index
from ..net.tpu import I32, Msgs
from ..tree import resolve_device
from ..workloads.broadcast import TOPOLOGIES, topology_indices
from . import NodeProgram, T_ERROR as T_ERR, edge_capacity, edge_timing, \
    freeze_step, register

# client RPCs
T_READ = 10       # a = key
T_READ_OK = 11    # a = value+1 (0 = key absent -> error 20)
T_WRITE = 12      # a = key, b = value
T_WRITE_OK = 13
T_CAS = 14        # a = key, b = from, c = to
T_CAS_OK = 15
T_TXN = 16        # a = interned txn id (opaque replicated command)
T_TXN_OK = 17     # a = commit position in the raft log
# raft RPCs (edge lanes)
T_RV = 20         # a = term, b = last_log_idx, c = last_log_term
T_RV_REPLY = 21   # a = term, b = granted
T_AE = 22         # a = term, b = prev_idx<<16 | prev_term, c = commit<<4|cnt
T_AE_REPLY = 23   # a = term, b = success, c = match idx (or len hint)
T_PROXY = 24      # packed like an entry, minus the term
T_ENTRY = 25      # a = term<<16|key<<4|op, b = client<<16|v1<<8|v2, c = mid

OP_NOOP, OP_WRITE, OP_CAS, OP_READ, OP_TXN = 0, 1, 2, 3, 4

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

# the order of the kernel's pointer arguments (struct RaftArgs in
# csrc/raft.cu)
STATE_KEYS = ("role", "term", "voted_for", "votes", "log_a", "log_b",
              "log_c", "log_len", "commit", "applied", "next", "match", "kv",
              "deadline", "leader_hint", "log_overflow")
_EDGE = ("valid", "type", "a", "b", "c")
_CLIENT_IN = ("valid", "src", "due", "mid", "type", "a", "b", "c")
_CLIENT_OUT = tuple(Msgs.__dataclass_fields__)
# the kernel's limits: per-node arrays live in registers and local memory
MAX_N, MAX_D, MAX_E, MAX_K = 32, 32, 15, 64


class LinKVWire:
    """The lin-kv wire vocabulary (RPC surface per `workload/lin_kv.clj`):
    protocol JSON <-> (type, a, b, c) words."""

    def request_for_op(self, op):
        k, v = op["value"]
        if op["f"] == "read":
            return {"type": "read", "key": k}
        if op["f"] == "write":
            return {"type": "write", "key": k, "value": v}
        return {"type": "cas", "key": k, "from": v[0], "to": v[1]}

    def encode_body(self, body, intern):
        if body["type"] == "read":
            return (T_READ, int(body["key"]), 0, 0)
        if body["type"] == "write":
            return (T_WRITE, int(body["key"]), int(body["value"]), 0)
        return (T_CAS, int(body["key"]), int(body["from"]),
                int(body["to"]))

    def decode_body(self, t, a, b, c, intern):
        if t == T_READ_OK:
            return {"type": "read_ok", "value": int(a) - 1}
        if t == T_WRITE_OK:
            return {"type": "write_ok"}
        if t == T_CAS_OK:
            return {"type": "cas_ok"}
        if t == 1:
            return {"type": "error", "code": int(a), "text": "kv error"}
        return super().decode_body(t, a, b, c, intern)

    def completion(self, op, body, read_state, intern):
        if body["type"] == "read_ok":
            k = op["value"][0]
            return {**op, "type": "ok", "value": [k, body["value"]]}
        return {**op, "type": "ok"}


def _first(mask):
    """(any, first) over the last axis of a bool mask: the index of the
    first True, 0 where none (`jnp.argmax` of a bool mask)."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    first = torch.where(mask, idx, n).amin(dim=-1)
    return mask.any(dim=-1), torch.where(first == n, 0, first)


def _take(x, idx):
    """x[r, idx[r, ...]] along axis 1 (`take_along_axis`); idx is
    clipped by the caller."""
    return torch.gather(x, 1, idx.long())


def _put_rows(plane, pos, do, vals):
    """plane[r, pos[r, j]] = vals[r, j] where do[r, j]: JAX's
    `.at[].set(mode="drop")` over distinct positions, a negative position
    counting from the end of the row and one outside [-C, C) dropped."""
    C = plane.shape[1]
    p = torch.where(pos < 0, pos + C, pos)
    ok = do & (p >= 0) & (p < C)
    r, j = torch.nonzero(ok, as_tuple=True)
    plane[r, p[r, j].long()] = vals[r, j]


def _excl_cumsum(x):
    x = x.to(I32)
    return torch.cumsum(x, dim=1, dtype=I32) - x


@register
class RaftProgram(LinKVWire, NodeProgram):
    name = "lin-kv"
    needs_state_reads = False
    is_edge = True
    tolerates_channel_overwrites = True   # AE windows resend every round
    # an AE is one RPC: its entry lanes are positioned by the header's
    # prev_idx, so header and entries share one fault draw per (edge,
    # round)
    edge_atomic_rpc = True
    # crash durability (Raft section 5.1): the log, current term and
    # vote survive a kill; the rest is rebuilt by replay. log_overflow
    # rides along so a capacity invalidation survives a crash.
    durable_keys = ("log_a", "log_b", "log_c", "log_len", "term",
                    "voted_for", "log_overflow")
    # raft is never quiescent: heartbeats and election timers tick (the
    # runner skips the quiescence probe)
    quiet_planes = None

    def __init__(self, opts, nodes, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        topo = TOPOLOGIES["total"](nodes)
        nb = topology_indices(topo, nodes)
        self.neighbors = torch.tensor(nb, dtype=I32, device=self.device)
        self.rev = torch.tensor(reverse_index(nb), dtype=I32,
                                device=self.device)
        self.D = int(nb.shape[1])
        self.E = int(opts.get("ae_entries", 4))
        self.lanes = 3 + self.E
        # the log capacity follows the expected operation count; a run
        # that hits it anyway is invalid through invalid_counters
        rate = float(opts.get("rate") or 0.0)
        tl = float(opts.get("time_limit") or 0.0)
        expected = int(2 * rate * tl) + 256
        self.cap = int(opts.get("log_cap", min(max(256, expected), 0x7FFF)))
        self.keys = int(opts.get("kv_keys", 256))
        # packed wire-field widths: the AE header's 4-bit entry count, an
        # entry's 12-bit key, and (prev_idx + 1) << 16 kept positive
        for bad, what in ((not 1 <= self.E <= 15,
                           "ae_entries must fit the 4-bit cnt field"),
                          (self.keys > 4096,
                           "kv_keys must fit the 12-bit key field"),
                          (self.cap > 0x7FFF,
                           "log_cap must fit 15-bit prev_idx")):
            if bad:
                raise ValueError(f"{self.name}: {what}")
        self.ring, _retry, lat_rounds = edge_timing(opts, len(nodes))
        self.election = max(8 * (lat_rounds + 1), 24)
        self.heartbeat = max(self.election // 8, 2)
        self.inbox_cap = int(opts.get("inbox_cap", 4))
        self.outbox_cap = self.inbox_cap
        spill, chan_lanes, uniform = edge_capacity(opts, self)
        if spill or chan_lanes != self.lanes:
            raise ValueError(
                f"raft requires positional lanes (no spill, lanes="
                f"{self.lanes}); edge_capacity returned spill={spill}, "
                f"lanes={chan_lanes}")
        self.edge_cfg = EdgeConfig(n_nodes=self.n_nodes, degree=self.D,
                                   lanes=self.lanes, ring=self.ring,
                                   uniform_arrival=uniform)

    def init_state(self):
        N, D, C, dev = self.n_nodes, self.D, self.cap, self.device

        def z(*s):
            return torch.zeros(s, dtype=I32, device=dev)

        def full(v, *s):
            return torch.full(s, v, dtype=I32, device=dev)
        return {
            "role": z(N), "term": z(N), "voted_for": full(-1, N),
            "votes": torch.zeros((N, N), dtype=torch.bool, device=dev),
            "log_a": z(N, C), "log_b": z(N, C), "log_c": z(N, C),
            "log_len": z(N), "commit": full(-1, N), "applied": full(-1, N),
            "next": z(N, D), "match": full(-1, N, D),
            "kv": z(N, self.keys),          # value+1; 0 = absent
            "deadline": z(N),               # election deadline (round)
            "leader_hint": full(-1, N),     # believed leader edge
            "log_overflow": z(N),
        }

    def invalid_counters(self, state):
        # a leader whose log hit `log_cap` sheds client requests the
        # client sees only as timeouts: a static-capacity failure of the
        # simulation, which invalidates the run as pool overflow does
        return {"log-overflow": state["log_overflow"]}

    # --- plain version ----------------------------------------------------

    def _jitter(self, keys, F):
        """The election jitter of every node row: randint(fold_in(k2, 17),
        (N,), 0, election) per cluster, [F * N]."""
        kr = prng.split(keys, 1, base=17)[:, 0]
        return prng.randint(kr, (self.n_nodes,), 0,
                            self.election).reshape(F * self.n_nodes)

    def edge_step_plain(self, state, edge_in: EdgeMsgs, client_in: Msgs,
                        rnd, keys):
        """The JAX package's `RaftProgram.edge_step` over R = F * N node
        rows: state leaves [R, ...], edge_in [R, D, L], client_in [R, K],
        `rnd` the i32 round of each cluster [F] and `keys` its uint32
        program key [F, 2]. Returns (state', edge_out, client_out)."""
        N, D, C, E, KEYS = (self.n_nodes, self.D, self.cap, self.E,
                            self.keys)
        R = state["role"].shape[0]
        F = R // N
        dev = state["role"].device
        rows = torch.arange(R, device=dev)
        me = (rows % N).to(I32)
        nb = self.neighbors[me.long()]                       # [R, D]
        rnd_r = rnd.to(I32)[rows // N]                       # [R]
        edge_ok = nb >= 0
        s = dict(state)
        log_a0 = state["log_a"]                              # pre-round
        log = torch.stack([state["log_a"], state["log_b"], state["log_c"]],
                          dim=-1)                            # [R, C, 3]

        def lane(f, j):
            return getattr(edge_in, f)[:, :, j]
        is_rv = lane("valid", 0) & (lane("type", 0) == T_RV)
        is_ae = lane("valid", 0) & (lane("type", 0) == T_AE)
        is_rvr = lane("valid", 1) & (lane("type", 1) == T_RV_REPLY)
        is_aer = lane("valid", 1) & (lane("type", 1) == T_AE_REPLY)
        is_prx = lane("valid", 2) & (lane("type", 2) == T_PROXY)
        req_a, req_b, req_c = lane("a", 0), lane("b", 0), lane("c", 0)
        rep_a, rep_b, rep_c = lane("a", 1), lane("b", 1), lane("c", 1)

        # term catch-up (Raft section 5.1)
        terms_seen = torch.maximum(
            torch.where(is_rv | is_ae, req_a, 0).amax(dim=1),
            torch.where(is_rvr | is_aer, rep_a, 0).amax(dim=1))
        newer = terms_seen > s["term"]
        s["term"] = torch.where(newer, terms_seen, s["term"])
        s["role"] = torch.where(newer, FOLLOWER, s["role"])
        s["voted_for"] = torch.where(newer, -1, s["voted_for"])

        # election timer
        jitter = self._jitter(keys, F)
        timed_out = (s["role"] != LEADER) & (rnd_r >= s["deadline"])
        new_deadline = rnd_r + self.election + jitter
        s["term"] = torch.where(timed_out, s["term"] + 1, s["term"])
        s["role"] = torch.where(timed_out, CANDIDATE, s["role"])
        s["voted_for"] = torch.where(timed_out, me, s["voted_for"])
        s["votes"] = s["votes"] & ~timed_out[:, None]
        s["deadline"] = torch.where(timed_out, new_deadline, s["deadline"])
        s["leader_hint"] = torch.where(timed_out, -1, s["leader_hint"])

        last_idx = s["log_len"] - 1
        last_term = torch.where(
            last_idx >= 0,
            _take(log_a0, last_idx.clamp(0, C - 1)[:, None])[:, 0] >> 16,
            0)

        # votes (5.2): at most one grant a round, the first eligible edge
        rv_ok = is_rv & (req_a == s["term"][:, None])
        log_ok = ((req_c > last_term[:, None])
                  | ((req_c == last_term[:, None])
                     & (req_b >= last_idx[:, None])))
        can_vote = ((s["voted_for"][:, None] < 0)
                    | (s["voted_for"][:, None] == nb))
        elig = rv_ok & can_vote & log_ok
        any_g, first = _first(elig)
        grant = elig & (torch.arange(D, device=dev)[None, :]
                        == first[:, None])
        cand = _take(nb, first[:, None])[:, 0]
        s["voted_for"] = torch.where(any_g, cand, s["voted_for"])
        s["deadline"] = torch.where(any_g, new_deadline, s["deadline"])

        # count granted replies; the self-vote is implicit
        rv_granted = is_rvr & (rep_a == s["term"][:, None]) & (rep_b > 0)
        votes_add = (rv_granted[:, :, None]
                     & (nb[:, :, None] == torch.arange(
                         N, dtype=I32, device=dev)[None, None, :])).any(1)
        cand_now = s["role"] == CANDIDATE
        s["votes"] = (s["votes"] | votes_add) & cand_now[:, None]
        won = cand_now & (s["votes"].sum(dim=1) + 1 > (N // 2))
        s["role"] = torch.where(won, LEADER, s["role"])
        s["next"] = torch.where(won[:, None], s["log_len"][:, None],
                                s["next"])
        s["match"] = torch.where(won[:, None], -1, s["match"])

        # append entries, follower side (5.3)
        cur = is_ae & (req_a == s["term"][:, None])
        cur_any, cur_first = _first(cur)
        s["leader_hint"] = torch.where(cur_any, cur_first.to(I32),
                                       s["leader_hint"])
        s["deadline"] = torch.where(cur_any, new_deadline, s["deadline"])
        s["role"] = torch.where(cur_any & (s["role"] == CANDIDATE),
                                FOLLOWER, s["role"])

        ae_prev_idx = (req_b >> 16) - 1
        ae_prev_term = req_b & 0xFFFF
        ae_commit = (req_c >> 4) - 1
        ae_cnt = req_c & 0xF
        prev_in_log = ae_prev_idx < s["log_len"][:, None]
        prev_term_here = _take(log_a0, ae_prev_idx.clamp(0, C - 1)) >> 16
        prev_match = (ae_prev_idx < 0) | (
            prev_in_log & (prev_term_here == ae_prev_term))
        accept = cur & prev_match
        acc_any, acc_d = _first(accept)
        acc_prev = _take(ae_prev_idx, acc_d[:, None])[:, 0]
        acc_cnt = _take(ae_cnt, acc_d[:, None])[:, 0]

        # only a contiguous prefix of the arrived entries may append
        def at_acc(f):
            x = getattr(edge_in, f)[:, :, 3:3 + E]           # [R, D, E]
            return x[rows, acc_d]                            # [R, E]
        lv, lt = at_acc("valid"), at_acc("type")
        ea, eb, ec = at_acc("a"), at_acc("b"), at_acc("c")
        e_i = torch.arange(E, dtype=I32, device=dev)[None, :]
        present = acc_any[:, None] & lv & (lt == T_ENTRY)
        expected = acc_any[:, None] & (e_i < acc_cnt[:, None])
        bad = expected & ~present
        contig_before = _excl_cumsum(bad) == 0
        eff = present & contig_before & expected
        pos = acc_prev[:, None] + 1 + e_i                    # [R, E]
        in_cap = eff & (pos < C)
        contig_cnt = in_cap.sum(dim=1, dtype=I32)
        had = pos < s["log_len"][:, None]
        old_a = _take(log[:, :, 0], pos.clamp(0, C - 1))     # pre-write
        conflict = (in_cap & had & ((old_a >> 16) != (ea >> 16))).any(1)
        _put_rows(log, pos, in_cap, torch.stack([ea, eb, ec], dim=-1))
        new_len = torch.maximum(
            s["log_len"], torch.where(in_cap, pos + 1, 0).amax(dim=1))
        window_end = acc_prev + 1 + contig_cnt
        s["log_len"] = torch.where(
            acc_any,
            torch.where(conflict, torch.minimum(new_len, window_end),
                        new_len),
            s["log_len"])
        acc_commit = _take(ae_commit, acc_d[:, None])[:, 0]
        # bounded by the verified prefix (prev match + the contiguously
        # appended entries)
        s["commit"] = torch.where(
            acc_any, torch.maximum(s["commit"], torch.minimum(
                acc_commit, acc_prev + contig_cnt)), s["commit"])

        # AE replies, leader side
        aer_ok = (is_aer & (rep_a == s["term"][:, None])
                  & (s["role"] == LEADER)[:, None])
        succ = aer_ok & (rep_b > 0)
        fail = aer_ok & (rep_b == 0)
        s["match"] = torch.where(succ, torch.maximum(s["match"], rep_c),
                                 s["match"])
        s["next"] = torch.where(succ, torch.maximum(s["next"], rep_c + 1),
                                s["next"])
        s["next"] = torch.where(
            fail, torch.clamp(torch.minimum(s["next"] - 1, rep_c + 1), 0, C),
            s["next"])

        # commit advance: the (N//2)-th largest of the matches and the own
        # log end, if that entry is of the current term (5.4.2)
        repl = torch.cat([s["match"], (s["log_len"] - 1)[:, None]], dim=1)
        best = torch.sort(repl, dim=1, descending=True).values[:, N // 2]
        best_term = torch.where(
            best >= 0, _take(log_a0, best.clamp(0, C - 1)[:, None])[:, 0]
            >> 16, -1)
        is_leader = s["role"] == LEADER
        s["commit"] = torch.where(is_leader & (best_term == s["term"]),
                                  torch.maximum(s["commit"], best),
                                  s["commit"])

        # client requests: a leader appends them, a non-leader proxies
        # its first one toward its known leader and sheds the rest
        Kc = client_in.valid.shape[1]
        ct, ca, cb, cc = (client_in.type, client_in.a, client_in.b,
                          client_in.c)
        creq = client_in.valid & ((ct == T_READ) | (ct == T_WRITE)
                                  | (ct == T_CAS) | (ct == T_TXN))
        op_of = torch.where(
            ct == T_WRITE, OP_WRITE, torch.where(
                ct == T_CAS, OP_CAS, torch.where(ct == T_TXN, OP_TXN,
                                                 OP_READ))).to(I32)
        is_txn = ct == T_TXN
        keyk = torch.where(is_txn, 0, ca.clamp(0, KEYS - 1))
        v1 = torch.where(is_txn, (ca >> 8) & 0xFF, torch.where(
            (ct == T_WRITE) | (ct == T_CAS), cb + 1, 0))
        v2 = torch.where(is_txn, ca & 0xFF,
                         torch.where(ct == T_CAS, cc + 1, 0))
        client_idx = (client_in.src - N).clamp(0, 0xFFFF)
        c_ea = (s["term"][:, None] << 16) | (keyk << 4) | op_of
        c_eb = ((client_idx << 16) | (v1.clamp(0, 0xFF) << 8)
                | v2.clamp(0, 0xFF))
        wish = creq & is_leader[:, None]
        cpos = s["log_len"][:, None] + _excl_cumsum(wish)
        do = wish & (cpos < C)
        _put_rows(log, cpos, do,
                  torch.stack([c_ea, c_eb, client_in.mid], dim=-1))
        s["log_len"] = s["log_len"] + do.sum(dim=1, dtype=I32)
        s["log_overflow"] = s["log_overflow"] + (
            wish & (cpos >= C)).sum(dim=1, dtype=I32)
        want = creq & ~is_leader[:, None]
        any_w, k0 = _first(want)

        def pick(f):
            return torch.where(any_w, _take(f, k0[:, None])[:, 0], 0)
        proxy_slot = torch.where(any_w, k0.to(I32), -1)
        proxy_a = pick((keyk << 4) | op_of)
        proxy_b = pick(c_eb)
        proxy_c = pick(client_in.mid)
        have_hint = (s["leader_hint"] >= 0)[:, None]
        slot_i = torch.arange(Kc, device=dev)[None, :]
        shed = want & (~have_hint | (slot_i != k0[:, None]))

        # proxied requests arriving at the leader: one append an edge
        pwish = is_prx & is_leader[:, None]
        ppos = s["log_len"][:, None] + _excl_cumsum(pwish)
        pdo = pwish & (ppos < C)
        prx_a = lane("a", 2)
        p_ea = ((s["term"][:, None] << 16) | (((prx_a >> 4) & 0xFFF) << 4)
                | (prx_a & 0xF))
        _put_rows(log, ppos, pdo,
                  torch.stack([p_ea, lane("b", 2), lane("c", 2)], dim=-1))
        s["log_len"] = s["log_len"] + pdo.sum(dim=1, dtype=I32)
        s["log_overflow"] = s["log_overflow"] + (
            pwish & (ppos >= C)).sum(dim=1, dtype=I32)

        # apply in log order: applied+1+j while committed; a CAS reads
        # the write of the step before it, so the kv chain is sequential
        start = s["applied"] + 1
        kv = s["kv"].clone()
        applied = s["applied"]
        outs = []
        if Kc > 0:
            idxs = start[:, None] + torch.arange(Kc, dtype=I32,
                                                 device=dev)[None, :]
            entries = log[rows[:, None], idxs.clamp(0, C - 1).long()]
            for j in range(Kc):
                idx = start + j
                active = idx <= s["commit"]
                a_, b_, c_ = entries[:, j, 0], entries[:, j, 1], \
                    entries[:, j, 2]
                key, op = (a_ >> 4) & 0xFFF, a_ & 0xF
                client, v1e, v2e = b_ >> 16, (b_ >> 8) & 0xFF, b_ & 0xFF
                safe_key = key.clamp(0, KEYS - 1)
                cur_v = _take(kv, safe_key[:, None])[:, 0]
                cas_ok = (op == OP_CAS) & (cur_v == v1e) & (cur_v > 0)
                do_write = active & ((op == OP_WRITE) | cas_ok)
                new_v = torch.where(op == OP_WRITE, v1e, v2e)
                w = torch.nonzero(do_write, as_tuple=True)[0]
                kv[w, safe_key[w].long()] = new_v[w]
                applied = torch.where(active, idx, applied)
                say = active & is_leader & (op != OP_NOOP)
                rtype = torch.where(
                    op == OP_TXN, T_TXN_OK, torch.where(
                        op == OP_READ, torch.where(cur_v > 0, T_READ_OK, 1),
                        torch.where(op == OP_WRITE, T_WRITE_OK,
                                    torch.where(cas_ok, T_CAS_OK, 1))))
                ra = torch.where(
                    op == OP_TXN, idx, torch.where(
                        op == OP_READ, torch.where(cur_v > 0, cur_v, 20),
                        torch.where((op == OP_CAS) & ~cas_ok,
                                    torch.where(cur_v > 0, 22, 20), 0)))
                outs.append((say, N + client, rtype.to(I32), ra.to(I32),
                             c_))
        s["kv"] = kv
        s["applied"] = applied
        if outs:
            out_valid, out_dest, out_type, out_a, out_reply = (
                torch.stack([o[i] for o in outs], dim=1) for i in range(5))
        else:
            out_valid = torch.zeros((R, 0), dtype=torch.bool, device=dev)
            out_dest = out_type = out_a = torch.zeros((R, 0), dtype=I32,
                                                      device=dev)
            out_reply = torch.full((R, 0), -1, dtype=I32, device=dev)

        s["log_a"] = log[:, :, 0].contiguous()
        s["log_b"] = log[:, :, 1].contiguous()
        s["log_c"] = log[:, :, 2].contiguous()

        # outbound lane 0: candidates ask for votes, leaders send AE
        log_len = s["log_len"][:, None]
        send_rv = timed_out[:, None] & edge_ok
        nxt = torch.minimum(s["next"], log_len)
        cnt = (log_len - nxt).clamp(0, E)
        beat = torch.remainder(rnd_r, self.heartbeat) == 0
        send_ae = is_leader[:, None] & edge_ok & ((cnt > 0) | beat[:, None])
        prev_idx = nxt - 1
        prev_term = torch.where(
            prev_idx >= 0, _take(s["log_a"], prev_idx.clamp(0, C - 1))
            >> 16, 0)
        term_b = s["term"][:, None].expand(R, D)
        l0_valid = send_rv | send_ae
        l0_type = torch.where(send_rv, T_RV, T_AE)
        l0_b = torch.where(send_rv, last_idx[:, None],
                           ((prev_idx + 1) << 16) | prev_term)
        l0_c = torch.where(send_rv, last_term[:, None],
                           ((s["commit"][:, None] + 1) << 4) | cnt)

        # lane 1: vote results and append results; ack only the
        # contiguously appended prefix
        l1_valid = is_rv | cur
        l1_type = torch.where(is_rv, T_RV_REPLY, T_AE_REPLY)
        match_val = torch.where(accept, (acc_prev + contig_cnt)[:, None],
                                torch.minimum(log_len - 1, ae_prev_idx - 1))
        l1_b = torch.where(is_rv, grant.to(I32), accept.to(I32))
        l1_c = torch.where(is_rv, 0, match_val)

        # lane 2: the remembered request, toward the leader edge
        l2_valid = ((proxy_slot >= 0)[:, None]
                    & (s["leader_hint"][:, None]
                       == torch.arange(D, dtype=I32, device=dev)[None, :])
                    & edge_ok)

        # entry lanes: the leader's window toward each neighbour
        e3 = torch.arange(E, dtype=I32, device=dev)[None, None, :]
        wpos = (nxt[:, :, None] + e3).clamp(0, C - 1).long()   # [R, D, E]
        ev = send_ae[:, :, None] & (e3 < cnt[:, :, None])
        window = log[rows[:, None, None], wpos]                 # [R,D,E,3]

        def pack(x0, x1, x2, xe):
            return torch.cat([torch.stack([x0, x1, x2], dim=2), xe], dim=2)

        def bcast(x):
            return x[:, None].expand(R, D)
        edge_out = EdgeMsgs(
            valid=pack(l0_valid, l1_valid, l2_valid, ev),
            type=pack(l0_type.to(I32), l1_type.to(I32),
                      torch.full((R, D), T_PROXY, dtype=I32, device=dev),
                      torch.full((R, D, E), T_ENTRY, dtype=I32,
                                 device=dev)),
            a=pack(term_b, term_b, bcast(proxy_a), window[..., 0]),
            b=pack(l0_b, l1_b, bcast(proxy_b), window[..., 1]),
            c=pack(l0_c, l1_c, bcast(proxy_c), window[..., 2]))

        # shed requests get error 11; apply replies exist only on
        # leaders, sheds only on non-leaders, so the slots are disjoint
        client_out = Msgs(
            valid=out_valid | shed,
            src=me[:, None].expand(R, Kc).contiguous(),
            dest=torch.where(shed, client_in.src, out_dest),
            due=client_in.due, mid=client_in.mid,
            reply_to=torch.where(shed, client_in.mid, out_reply),
            type=torch.where(shed, T_ERR, out_type),
            a=torch.where(shed, 11, out_a),
            b=torch.zeros((R, Kc), dtype=I32, device=dev),
            c=torch.zeros((R, Kc), dtype=I32, device=dev))
        new = {k: s[k].to(state[k].dtype) for k in STATE_KEYS}
        return new, edge_out, client_out

    # --- kernel -----------------------------------------------------------

    def _check_inputs(self, state, edge_in, client_in, rnd, keys, stall):
        N, D, C = self.n_nodes, self.D, self.cap
        R = state["role"].shape[0]
        F = R // N
        Kc = client_in.valid.shape[1]
        if R != F * N or tuple(rnd.shape) != (F,) or rnd.dtype != I32 \
                or tuple(keys.shape) != (F, 2) or keys.dtype != torch.uint32:
            raise ValueError(f"raft_step: {R} rows, round {tuple(rnd.shape)}"
                             f", keys {tuple(keys.shape)}")
        if N > MAX_N or D > MAX_D or self.E > MAX_E or Kc > MAX_K:
            raise ValueError(f"raft_step: N {N}, D {D}, E {self.E}, K {Kc} "
                             f"over the kernel's limits")
        shapes = {"votes": (R, N), "log_a": (R, C), "log_b": (R, C),
                  "log_c": (R, C), "next": (R, D), "match": (R, D),
                  "kv": (R, self.keys)}
        for k in STATE_KEYS:
            t = state[k]
            want = torch.bool if k == "votes" else I32
            if tuple(t.shape) != shapes.get(k, (R,)) or t.dtype != want:
                raise ValueError(f"raft_step {k}: {tuple(t.shape)} "
                                 f"{t.dtype}")
        for f in _EDGE:
            t = getattr(edge_in, f)
            if tuple(t.shape) != (R, D, self.lanes) or t.dtype != (
                    torch.bool if f == "valid" else I32):
                raise ValueError(f"raft_step edge_in.{f}: {tuple(t.shape)}")
        for f in _CLIENT_IN:
            t = getattr(client_in, f)
            if tuple(t.shape) != (R, Kc) or t.dtype != (
                    torch.bool if f == "valid" else I32):
                raise ValueError(f"raft_step client_in.{f}: "
                                 f"{tuple(t.shape)}")
        if stall is not None and (tuple(stall.shape) != (R,)
                                  or stall.dtype != torch.bool):
            raise ValueError(f"raft_step stall: {tuple(stall.shape)}")

    def _step_kernel(self, state, edge_in, client_in, rnd, keys, stall):
        self._check_inputs(state, edge_in, client_in, rnd, keys, stall)
        R = state["role"].shape[0]
        dev = state["role"].device
        D, L = self.D, self.lanes
        Kc = client_in.valid.shape[1]
        new = {k: torch.empty_like(state[k],
                                   memory_format=torch.contiguous_format)
               for k in STATE_KEYS}
        edge_out = EdgeMsgs(
            valid=torch.empty((R, D, L), dtype=torch.bool, device=dev),
            **{f: torch.empty((R, D, L), dtype=I32, device=dev)
               for f in _EDGE[1:]})
        client_out = Msgs(**{
            f: torch.empty((R, Kc), dtype=torch.bool if f == "valid"
                           else I32, device=dev) for f in _CLIENT_OUT})
        K.RAFT_STEP.launch(
            [state[k].contiguous() for k in STATE_KEYS]
            + [getattr(edge_in, f).contiguous() for f in _EDGE]
            + [getattr(client_in, f).contiguous() for f in _CLIENT_IN]
            + [self.neighbors, rnd.contiguous(), keys.contiguous(),
               None if stall is None else stall.contiguous()]
            + [new[k] for k in STATE_KEYS]
            + [getattr(edge_out, f) for f in _EDGE]
            + [getattr(client_out, f) for f in _CLIENT_OUT],
            [R, self.n_nodes, D, L, self.E, self.cap, self.keys, Kc,
             self.election, self.heartbeat], dev)
        return new, edge_out, client_out

    def step_rows(self, state, edge_in, client_in, rnd, keys, stall=None):
        """One Raft step of R = F * N node rows (see `edge_step_plain`);
        `stall`, when given, the [R] bool mask of killed or paused rows,
        which keep their state and emit no valid lane or client row. The
        kernel is K10 `raft_step` in `csrc/raft.cu`."""
        if K.use_kernel(edge_in.valid):
            return self._step_kernel(state, edge_in, client_in, rnd, keys,
                                     stall)
        return freeze_step(stall, state, *self.edge_step_plain(
            state, edge_in, client_in, rnd, keys))

    def edge_step(self, state, edge_in: EdgeMsgs, client_in, ctx):
        """One cluster: (state [N, ...], edge_in [N, D, L], client_in Msgs
        [N, K], ctx) -> (state', edge_out [N, D, L], client_out [N, K]).
        ctx["round"] is the i32 scalar round, ctx["key"] the program's
        uint32[2] key, ctx.get("stall") the [N] bool mask of killed or
        paused nodes."""
        return self.step_rows(state, edge_in, client_in,
                              ctx["round"].reshape(1),
                              ctx["key"].reshape(1, 2), ctx.get("stall"))
