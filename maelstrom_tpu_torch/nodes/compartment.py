"""Compartmentalized consensus: the role-partitioned sequencer / proxy /
acceptor / replica cluster serving lin-kv, `--node tpu:compartment`, with
live leader failover when the sequencer tier has more than one candidate.

Counterpart of `maelstrom_tpu/nodes/compartment.py`, held against it by
`tests/test_torch_compartment.py` (one sequencer) and
`tests/test_torch_election.py` (an elected tier). "Scaling Replicated
State Machines with Compartmentalization" (arxiv 2012.15762) splits
MultiPaxos' leader into tiers that scale on their own, four roles over
contiguous node-id ranges of one `sim.RolePartition`:

    nodes [0, S)            sequencers (candidates; node 0 leads at
                                        ballot 0, durable)
    nodes [S, S+P)          proxies   (VOLATILE: a kill wipes them; the
                                       leader's resends rebuild them)
    nodes [S+P, S+P+A)      acceptors (a rows x cols grid, durable)
    nodes [S+P+A, N)        replicas  (apply the log, durable)

selected with `--roles sequencers=S,proxies=P,acceptors=RxC,replicas=R`:

  1. clients send read / write / cas to the sequencer they believe leads
     (reads take a slot too, so every op linearizes at its apply point);
  2. the leader assigns the next slot, parks the command in its durable
     in-flight table and sends T_ASSIGN to proxy `slot % P`, again on
     every retry tick until T_DONE: the retry root that makes a volatile
     proxy safe. A full table or log sheds the command with error 11, a
     definite fail;
  3. the proxy sends T_P2A to every acceptor and folds the T_P2B acks
     by grid index; any complete grid ROW is a write quorum;
  4. the chosen command goes to every replica (T_LEARN) until each acks
     T_EXEC, and the proxy reports T_DONE to the assigning leader;
  5. replicas store each learned command at its slot, ack it at once,
     apply the log strictly in slot order (AP = K slots a round) over
     their key rows, and the designated replica (`slot % R`) answers
     the client with the value at the apply point.

With S > 1 the leader is elected (ballot-numbered MultiPaxos phase 1):
ballots are `k * S + candidate`; the leader heartbeats the other
candidates (T_HB) and a candidate whose failure detector expires (the
election timeout, a per-candidate stagger and a seeded per-round
jitter) prepares over the acceptor grid (T_PREP), winning on a COLUMN
of promises (T_PROM), which intersects every phase-2 row quorum. The
winner takes `next_slot` past the highest accepted slot and pulls the
slots above the commit watermark (T_CMT) back by query (T_QRY /
T_QVAL), re-proposing each at its ballot, a NO-OP where nothing was
accepted. Acceptors fence stale prepares (T_REJP) and stale proposals
(T_P2R); a fenced proxy row notifies the stale leader (T_NLDR). A
sequencer that does not lead answers error 31 with a hint, which the
runner follows under seeded backoff; the program's client-side lease
rotates the host's leader guess after a silent window.

Each role's `step` has a hand-written CUDA kernel in
`csrc/compartment.cu` (one sequencer: K23 `compartment_sequencer_step`,
K24 `compartment_proxy_step`, K25 `compartment_acceptor_step`; an
elected tier: K27 `compartment_sequencer_elect`, K28
`compartment_proxy_elect`, K29 `compartment_acceptor_elect`; both: K26
`compartment_replica_step`) and its plain PyTorch version. Killed and
paused nodes (`ctx["stall"]`) keep their state and send nothing: the
kernels apply the freeze, the plain versions go through `freeze_step`.

Under the byzantine adversary (`--nemesis byzantine`) the program names
its corruption surface (`byz_wire`: the culprit sequencer's T_ASSIGN
lanes, rewritten in the round by K30) and the proxies convict: a
deduped assign that equivocates (a live row of its slot, at its ballot
with S > 1, holding another command) or whose ballot lies outside its
source's residue class (S > 1) is dropped, counted into the proxy's
evidence leaves (`Z_KEYS`) and NACKed T_ERR / E_BYZANTINE to its source;
`byz_evidence` turns the evidence into conviction triples. K24 and K28
carry these lanes behind a flag; without the adversary the state tree
and the outbox keep their shapes."""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels as K
from .. import prng
from ..byzantine import PoolWire, byz_enabled, conviction
from ..net.tpu import I32, Msgs, cat_lanes
from ..sim import RolePartition
from ..tree import resolve_device
from . import NodeProgram, freeze_step, register
from .raft import (LinKVWire, OP_CAS, OP_NOOP, OP_READ, OP_WRITE, T_CAS,
                   T_READ, T_WRITE)
# the kernel-argument checks the service roles' wrappers use
from .services import _MSG_FIELDS, _check_inbox, _check_stall, _new_msgs

# client wire codes (shared with raft through LinKVWire): 10..15
T_ERR = 1
T_READ_OK = 11
T_WRITE_OK = 13
T_CAS_OK = 15
# phase-2 RPCs
T_ASSIGN = 30    # leader -> proxy:    a = packed(bal, client, slot), b = cmd, c = mid
T_P2A = 31       # proxy -> acceptor:  a = slot, b = cmd, c = ballot
T_P2B = 32       # acceptor -> proxy:  a = slot, b = acceptor grid index, c = ballot
T_LEARN = 33     # proxy -> replica:   a = packed(client, slot), b = cmd, c = mid
T_EXEC = 34      # replica -> proxy:   a = slot, b = replica index
T_DONE = 35      # proxy -> leader:    a = slot
# phase-1 (election and recovery) RPCs, sent only when S > 1
T_PREP = 36      # candidate -> acceptor: a = ballot
T_PROM = 37      # acceptor -> candidate: a = ballot, b = grid index, c = cmt+1<<13 | hi+1
T_REJP = 38      # acceptor -> candidate: a = rejected ballot, c = promised
T_P2R = 39       # acceptor -> proxy:     a = slot, b = grid index, c = promised
T_QRY = 40       # leader -> acceptor:    a = slot, c = ballot
T_QVAL = 41      # acceptor -> leader:    a = slot, b = cmd, c = idx<<16 | bal+1
T_HB = 42        # leader -> candidates:  a = ballot
T_NLDR = 43      # proxy -> stale leader: a = higher ballot seen
T_CMT = 44       # leader -> acceptor:    a = done-frontier watermark

# protocol error codes on the client surface
E_UNAVAILABLE = 11   # leader table full: definite backpressure shed
E_NOT_LEADER = 31    # contacted sequencer does not lead; b = hint or -1
E_BYZANTINE = 32     # receiver convicted the message of lying

NOOP_CMD = 0         # key 0 / OP_NOOP: fills recovered gaps, applies inert

_DEFAULT_ROLES = {"sequencers": 1, "proxies": 2, "rows": 2, "cols": 2,
                  "replicas": 2}
DEFAULT_ROLES = "sequencers=1,proxies=2,acceptors=2x2,replicas=2"

# the inbox fields the kernels read, in their argument order
_IN_FIELDS = ("valid", "src", "mid", "type", "a", "b", "c")
# the kernels' block of threads is at most 1,024, a table row or an inbox
# lane a thread; K26 keeps a replica's key row in shared memory
MAX_ROWS = 1024
MAX_KV_KEYS = 4095
# K27 keeps a candidate's done_bits row in shared memory
MAX_DONE_BITS = 4095


def parse_roles(spec) -> dict:
    """`--roles sequencers=S,proxies=P,acceptors=RxC,replicas=R` ->
    {sequencers, proxies, rows, cols, replicas}; omitted roles keep
    their defaults (one stable sequencer). A plain acceptor count A is
    a 1 x A grid (single row: the write quorum is all acceptors)."""
    spec = spec or DEFAULT_ROLES
    out = {"sequencers": None, "proxies": None, "rows": None,
           "cols": None, "replicas": None}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        k, sep, val = part.partition("=")
        k, val = k.strip(), val.strip()
        if not sep or not val:
            raise ValueError(f"--roles: expected name=count, got {part!r}")
        if k == "sequencers":
            out["sequencers"] = int(val)
        elif k == "proxies":
            out["proxies"] = int(val)
        elif k == "acceptors":
            if "x" in val:
                r, c = val.split("x", 1)
                out["rows"], out["cols"] = int(r), int(c)
            else:
                out["rows"], out["cols"] = 1, int(val)
        elif k == "replicas":
            out["replicas"] = int(val)
        else:
            raise ValueError(
                f"--roles: unknown role {k!r} (expected sequencers, "
                f"proxies, acceptors, replicas)")
    for k, v in out.items():
        if v is None:
            out[k] = _DEFAULT_ROLES[k]
        elif v < 1:
            raise ValueError(f"--roles: {k} must be >= 1, got {v}")
    return out


def roles_node_count(spec) -> int:
    r = parse_roles(spec)
    return (r["sequencers"] + r["proxies"] + r["rows"] * r["cols"]
            + r["replicas"])


class Layout:
    """Static shape of one compartmentalized cluster, shared by every
    role program so bases, capacities, wire packing and retry pacing
    can never disagree. Every validation of the JAX package's layout is
    kept, the elected configuration's too, with its messages."""

    # the elected configuration's wire packing (bal<<24 | client<<12 |
    # slot) narrows the slot and client fields; one sequencer keeps
    # client<<16 | slot
    SLOT_BITS = 12
    CLIENT_BITS = 12
    MAX_BAL_BITS = 6

    def __init__(self, opts: dict, n_nodes: int):
        r = parse_roles(opts.get("roles"))
        self.S = r["sequencers"]
        self.P = r["proxies"]
        self.rows, self.cols = r["rows"], r["cols"]
        self.A = self.rows * self.cols
        self.R = r["replicas"]
        self.n_nodes = n_nodes
        self.leader = 0              # the ballot-0 leader
        self.s_base = 0
        self.p_base = self.S
        self.a_base = self.S + self.P
        self.r_base = self.S + self.P + self.A
        want = self.S + self.P + self.A + self.R
        if want != n_nodes:
            raise ValueError(
                f"--roles {opts.get('roles')!r} needs {want} nodes "
                f"({self.S} sequencers + {self.P} proxies + {self.A} "
                f"acceptors + {self.R} replicas) but the cluster has "
                f"{n_nodes}; drop --node-count/--nodes and let --roles "
                f"size it")
        # slot capacity scales with the expected op count like raft's
        # log (every client op, reads included, takes a slot)
        rate = float(opts.get("rate") or 0.0)
        tl = float(opts.get("time_limit") or 0.0)
        expected = int(2 * rate * tl) + 256
        slot_max = (1 << self.SLOT_BITS) - 1 if self.S > 1 else 0x7FFF
        self.cap = int(opts.get("log_cap",
                                min(max(256, expected), slot_max)))
        self.keys = int(opts.get("kv_keys", 256))
        conc = int(opts.get("concurrency") or n_nodes)
        # the sequencer's in-flight table: its fixed capacity (the bench
        # sweep holds it constant while P varies)
        self.QL = int(opts.get("leader_slots", max(32, 2 * conc)))
        # a proxy's in-flight table: the proxy tier's unit of capacity
        self.QP = int(opts.get("proxy_slots", 8))
        self.K = int(opts.get("compartment_inbox", 8))
        self.AP = self.K              # replica apply chunk a round
        self.retry = int(opts.get("compartment_retry", 10))
        self.etimeout = int(opts.get("election_timeout_rounds") or 60)
        self.bal_width = int(opts.get("ballot_width") or self.MAX_BAL_BITS)
        if self.cap > slot_max:
            raise ValueError(
                f"log_cap must fit {12 if self.S > 1 else 15}-bit slots "
                f"(<= {slot_max}{' with sequencers > 1' if self.S > 1 else ''})")
        if self.keys > 4095:
            raise ValueError("kv_keys must fit the 12-bit key field")
        if conc > ((1 << self.CLIENT_BITS) - 1 if self.S > 1 else 0x7FFF):
            raise ValueError(
                "concurrency must fit the "
                f"{self.CLIENT_BITS if self.S > 1 else 15}-bit client id "
                f"field{' with sequencers > 1' if self.S > 1 else ''}")
        if self.S > 1:
            if not 1 <= self.bal_width <= self.MAX_BAL_BITS:
                raise ValueError(
                    f"ballot_width must be in [1, {self.MAX_BAL_BITS}], "
                    f"got {self.bal_width}")
            if self.A > 30:
                raise ValueError(
                    "sequencers > 1 needs the acceptor grid to fit a "
                    f"31-bit promise mask (A <= 30, got {self.A})")
            if self.S >= (1 << self.bal_width):
                raise ValueError(
                    f"{self.S} sequencers need ballot_width > "
                    f"{self.bal_width} (each candidate owns a residue "
                    f"class)")
            if self.etimeout < 2 * self.retry:
                raise ValueError(
                    "election_timeout_rounds must cover at least two "
                    f"heartbeat ticks (>= {2 * self.retry})")
        self.AR = max(self.A, self.R)

    # --- ballot/client/slot wire packing -------------------------------

    def pack_assign_a(self, bal, client, slot):
        if self.S == 1:
            return (client << 16) | slot
        return (bal << 24) | (client << 12) | slot

    def unpack_assign_a(self, a):
        """-> (bal, client, slot)."""
        if self.S == 1:
            return torch.zeros_like(a), a >> 16, a & 0x7FFF
        return (a >> 24) & 0x3F, (a >> 12) & 0xFFF, a & 0xFFF

    def pack_learn_a(self, client, slot):
        if self.S == 1:
            return (client << 16) | slot
        return (client << 12) | slot

    def unpack_learn_a(self, a):
        """-> (client, slot)."""
        if self.S == 1:
            return a >> 16, a & 0x7FFF
        return (a >> 12) & 0xFFF, a & 0xFFF


def _pack_cmd(key, op, v1, v2):
    return (key << 18) | (op << 16) | (v1 << 8) | v2


def _unpack_cmd(cmd):
    return ((cmd >> 18) & 0xFFF, (cmd >> 16) & 0x3,
            (cmd >> 8) & 0xFF, cmd & 0xFF)


# --- the table helpers (the plain versions' building blocks) --------------

def _rank(mask):
    """Inclusive prefix count minus one over the last axis, int32 (the
    JAX package's `jnp.cumsum(..., dtype=I32) - 1`)."""
    return torch.cumsum(mask.to(I32), dim=1, dtype=I32) - 1


def _alloc_rows(occupied, want):
    """Free-row allocation without a sort: free rows and wanted entries
    are ranked by prefix count and paired rank for rank. Returns (ok,
    row): `ok` marks the entries that found a row, `row` its index (only
    meaningful where ok)."""
    n, Q = occupied.shape
    free = ~occupied
    n_free = free.sum(dim=1, dtype=I32)
    rows = torch.arange(Q, dtype=I32, device=occupied.device).expand(n, Q)
    # row_by_rank[rank of a free row] = that row; the other entries 0
    row_by_rank = _put_rows(torch.zeros((n, Q), dtype=I32,
                                        device=occupied.device),
                            free, _rank(free), rows)
    want_rank = _rank(want)
    ok = want & (want_rank < n_free[:, None])
    row = torch.gather(row_by_rank, 1, want_rank.clamp(0, Q - 1).long())
    return ok, row


def _put_rows(dst, ok, row, val):
    """dst[r, row[r, k]] = val[r, k] where ok[r, k] ([n, K] -> [n, Q]):
    JAX's `.at[].set(mode="drop")` over targets distinct where ok. The
    parked entries go to one extra column, dropped after."""
    n, Q = dst.shape
    val = torch.as_tensor(val, dtype=dst.dtype, device=dst.device)
    val = val.expand(ok.shape)
    wide = torch.cat([dst, dst.new_zeros((n, 1))], dim=1)
    tgt = torch.where(ok, row.long(), Q)
    return wide.scatter(1, tgt, val)[:, :Q]


def _first_per_key(valid, key):
    """In-round dedup: only the first valid entry per key among the K
    inbox lanes (resends and the duplicate nemesis must not double-apply
    within one round, and the scatters' targets stay distinct)."""
    Kl = valid.shape[1]
    ar = torch.arange(Kl, device=valid.device)
    earlier = ar[None, :] < ar[:, None]                 # [k, j]: j < k
    same = valid[:, None, :] & (key[:, :, None] == key[:, None, :])
    dup = (same & earlier[None]).any(dim=2)
    return valid & ~dup


def _match_rows(row_valid, row_slot, msg_valid, msg_slot):
    """[n, Q, K] mask: table row q matches inbox entry k on slot."""
    return (row_valid[:, :, None] & msg_valid[:, None, :]
            & (row_slot[:, :, None] == msg_slot[:, None, :]))


def _col_quorum(lay: Layout, bits):
    """True where the acceptor bitmask `bits` (grid index r*cols+c)
    covers at least one COMPLETE grid column: the phase-1 quorum that
    intersects every phase-2 row quorum. Works on any leading shape."""
    dev = bits.device
    pos = (torch.arange(lay.rows, dtype=I32, device=dev)[:, None] * lay.cols
           + torch.arange(lay.cols, dtype=I32, device=dev)[None, :])
    have = ((bits[..., None, None] >> pos) & 1).bool()
    return have.all(dim=-2).any(dim=-1)


def _max_lanes(x):
    """max over the inbox lanes with JAX's `initial=-1`."""
    return x.amax(dim=1).clamp(min=-1)


def _bit(x):
    """1 << clip(x, 0, 30), int32."""
    x = x.clamp(0, 30)
    return torch.ones_like(x) << x


def _out(shape, device, **fields) -> Msgs:
    out = Msgs.empty(shape, device)
    n, L = shape
    return out.replace(**{k: torch.as_tensor(v, dtype=getattr(out, k).dtype,
                                             device=device).expand(n, L)
                          for k, v in fields.items()})


def _plus1_byte(x):
    """clip(x + 1, 0, 0xFF) after an int32 add that wraps."""
    return (x + 1).clamp(0, 0xFF)


# --- kernel plumbing -------------------------------------------------------

def _check_state(kernel, state, spec):
    for name, (dt, shape) in spec.items():
        t = state[name]
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{kernel.name} {name}: {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dt}")


def _check_round(kernel, rnd):
    if not torch.is_tensor(rnd) or rnd.numel() != 1 or rnd.dtype != I32:
        raise ValueError(f"{kernel.name}: the round must be an i32 scalar "
                         f"tensor")
    return rnd.reshape(1).contiguous()


def _in_ptrs(inbox):
    return [getattr(inbox, f).contiguous() for f in _IN_FIELDS]


def _out_ptrs(out):
    return [getattr(out, f) for f in _MSG_FIELDS]


def _aligned16(*planes) -> bool:
    return all(p.data_ptr() % 16 == 0 for p in planes)


def _client_cmd(lay, inbox):
    """The packed command of each client request lane (read, write or
    cas): key, op and the two value bytes + 1."""
    t = inbox.type
    op_of = torch.where(t == T_WRITE, OP_WRITE,
                        torch.where(t == T_CAS, OP_CAS, OP_READ)).to(I32)
    keyk = inbox.a.clamp(0, lay.keys - 1)
    wc = (t == T_WRITE) | (t == T_CAS)
    v1 = torch.where(wc, inbox.b + 1, 0).clamp(0, 0xFF).to(I32)
    v2 = torch.where(t == T_CAS, inbox.c + 1, 0).clamp(0, 0xFF).to(I32)
    return _pack_cmd(keyk, op_of, v1, v2)


# the sequencer's and the proxy's table leaves, in the kernels' order
SEQ_KEYS = ("t_valid", "t_slot", "t_cmd", "t_client", "t_mid", "t_last")
# an elected sequencer's leaves, in its state's (and K27's) order
SEQ_ELECT_ALL = ("next_slot",) + SEQ_KEYS + (
    "bal", "seen", "leading", "electing", "prom", "cand_round", "rec_hi",
    "rec_next", "heard", "deadline", "boff", "hb_last", "elect_last",
    "t_bal", "t_q", "t_qmask", "t_qbal", "done_bits", "dfront",
    "won_count", "won_sum", "won_max", "bal_overflow")
SEQ_BOOL = ("t_valid", "leading", "electing", "t_q", "done_bits")
PROXY_KEYS = ("p_valid", "p_learn", "p_slot", "p_cmd", "p_client", "p_mid",
              "p_last", "p_acks")
# a proxy's conviction evidence leaves (with the adversary), in K24's and
# K28's order
Z_KEYS = ("z_eq", "z_sb", "z_eq_src", "z_eq_slot", "z_eq_rnd", "z_sb_src",
          "z_sb_bal", "z_sb_rnd")
ACC_ELECT_KEYS = ("acc_cmd", "acc_has", "promised", "acc_bal", "acc_hi",
                  "acc_cmt")
REPLICA_KEYS = ("r_cmd", "r_client", "r_mid", "r_has")


class SequencerRole(NodeProgram):
    """The sequencer candidates: slot assignment plus the durable
    in-flight table (the retry root that makes the volatile proxies
    safe) and, with S > 1, ballot-numbered MultiPaxos phase 1: failure
    detection, column-quorum prepare / promise, in-flight slot recovery
    and client redirects. All state is durable, an open candidacy too,
    so a killed candidate restarts where it stopped."""

    name = "compartment-sequencer"
    durable_keys = None          # sequencer state fsyncs before acting

    def __init__(self, opts, nodes, lay: Layout, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.lay = lay
        self.inbox_cap = lay.K
        if lay.S == 1:
            self.outbox_cap = lay.QL + lay.K
        else:
            # per-row fan lanes (T_ASSIGN on lane 0, T_QRY per acceptor),
            # prepare lanes, commit-watermark lanes, heartbeat lanes and
            # the client shed / redirect lanes
            self.outbox_cap = (lay.QL * lay.AR + 2 * lay.A + lay.S
                               + lay.K)
            # an elected tier is never quiescent: heartbeats and failure
            # detectors tick in virtual time, so skipping rounds would
            # fire spurious elections
            self.quiet_planes = None

    def init_state(self):
        n, Q, dev = self.n_nodes, self.lay.QL, self.device

        def z(*s):
            return torch.zeros(s, dtype=I32, device=dev)

        def full(v, *s):
            return torch.full(s, v, dtype=I32, device=dev)

        def no(*s):
            return torch.zeros(s, dtype=torch.bool, device=dev)
        st = {"next_slot": z(n), "t_valid": no(n, Q),
              "t_slot": z(n, Q), "t_cmd": z(n, Q),
              "t_client": z(n, Q), "t_mid": z(n, Q),
              "t_last": full(-(1 << 20), n, Q)}
        lay = self.lay
        if lay.S > 1:
            me = torch.arange(n, dtype=I32, device=dev)
            st.update({
                # ballots: own floor (durable, monotone), highest seen
                "bal": z(n), "seen": z(n),
                "leading": me == 0,            # node 0 leads at ballot 0
                "electing": no(n),
                "prom": z(n),                  # promise bitmask (grid idx)
                "cand_round": z(n),
                "rec_hi": full(-1, n), "rec_next": z(n),
                # failure detector and pacing
                "heard": z(n),
                "deadline": lay.etimeout + me * 2 * lay.retry,
                "boff": z(n),
                "hb_last": full(-(1 << 20), n),
                "elect_last": full(-(1 << 20), n),
                # per-row ballot and recovery-query bookkeeping
                "t_bal": z(n, Q), "t_q": no(n, Q), "t_qmask": z(n, Q),
                "t_qbal": full(-1, n, Q),
                # the commit watermark: done_bits marks slots retired by
                # T_DONE, dfront their contiguous frontier
                "done_bits": no(n, lay.cap), "dfront": full(-1, n),
                # election accounting (checkers/availability.py)
                "won_count": z(n), "won_sum": z(n), "won_max": z(n),
                "bal_overflow": z(n)})
        return st

    def quiet_planes(self, state):
        return [state["t_valid"]]

    def invalid_counters(self, state) -> dict:
        if self.lay.S == 1:
            return {}
        # a candidacy out of fenced ballot space stalls failover
        return {"ballot-overflow": state["bal_overflow"]}

    def step_plain(self, state, inbox, rnd):
        lay = self.lay
        n, K_ = inbox.valid.shape
        Q, C, dev = lay.QL, lay.cap, inbox.valid.device
        s = dict(state)
        v, t = inbox.valid, inbox.type

        # T_DONE: the command executed everywhere — retire its row
        done = v & (t == T_DONE)
        hit = _match_rows(s["t_valid"], s["t_slot"], done, inbox.a)
        s["t_valid"] = s["t_valid"] & ~hit.any(dim=2)

        # new client commands -> slots + table rows
        creq = v & ((t == T_READ) | (t == T_WRITE) | (t == T_CAS))
        cmd = _client_cmd(lay, inbox)
        client = (inbox.src - lay.n_nodes).clamp(0, 0x7FFF)
        ok, row = _alloc_rows(s["t_valid"], creq)
        slot = s["next_slot"][:, None] + _rank(ok)
        do = ok & (slot < C)
        s["t_valid"] = _put_rows(s["t_valid"], do, row, True)
        s["t_slot"] = _put_rows(s["t_slot"], do, row, slot)
        s["t_cmd"] = _put_rows(s["t_cmd"], do, row, cmd)
        s["t_client"] = _put_rows(s["t_client"], do, row, client)
        s["t_mid"] = _put_rows(s["t_mid"], do, row, inbox.mid)
        # fresh rows are due at once (t_last = rnd - retry)
        s["t_last"] = _put_rows(s["t_last"], do, row,
                                (rnd - lay.retry).to(I32))
        s["next_slot"] = s["next_slot"] + do.sum(dim=1, dtype=I32)

        # table/slot exhaustion sheds DEFINITELY (error 11)
        shed_out = _out((n, K_), dev, valid=creq & ~do, dest=inbox.src,
                        type=T_ERR, a=E_UNAVAILABLE, reply_to=inbox.mid)

        # T_ASSIGN resends: every live row on the retry tick
        due = s["t_valid"] & (rnd - s["t_last"] >= lay.retry)
        s["t_last"] = torch.where(due, rnd, s["t_last"]).to(I32)
        assign_out = _out(
            (n, Q), dev, valid=due, dest=lay.p_base + s["t_slot"] % lay.P,
            type=T_ASSIGN, a=(s["t_client"] << 16) | s["t_slot"],
            b=s["t_cmd"], c=s["t_mid"])
        return s, cat_lanes(assign_out, shed_out)

    def jitter(self, ctx) -> torch.Tensor:
        """The round's election jitter, [n] int32: randint(fold_in(role
        key, 23), (n,), 0, 2 * retry + 1), drawn every round (K7)."""
        key_r = prng.fold_in(ctx["key"], 23)
        return prng.randint(key_r, (self.n_nodes,), 0, 2 * self.lay.retry + 1)

    def step_plain_elect(self, state, inbox, rnd, jit1):
        """The JAX package's `SequencerRole._step_elect`
        (compartment.py:524-801) with the round's jitter `jit1` [n]."""
        lay = self.lay
        n, K_ = inbox.valid.shape
        Q, C, A, S, AR = lay.QL, lay.cap, lay.A, lay.S, lay.AR
        dev = inbox.valid.device
        retry = lay.retry
        rnd = rnd.to(I32)
        s = dict(state)
        v, t = inbox.valid, inbox.type
        me = torch.arange(n, dtype=I32, device=dev)
        jit1 = jit1.to(I32)

        # ---- observe ballots: heartbeats, depose notices, rejections
        is_hb = v & (t == T_HB)
        is_nl = v & (t == T_NLDR)
        is_rj = v & (t == T_REJP)
        obs = _max_lanes(torch.where(is_hb | is_nl, inbox.a,
                                     torch.where(is_rj, inbox.c, -1)))
        seen = torch.maximum(s["seen"], obs)
        # only a CURRENT leader's heartbeat refreshes the detector
        hb_cur = (is_hb & (inbox.a >= seen[:, None])).any(dim=1)
        heard = torch.where(hb_cur, rnd, s["heard"])

        # deposed or overtaken: step down, abort, drop the table
        higher = seen > s["bal"]
        dep = s["leading"] & higher
        abort = s["electing"] & (
            higher | (is_rj & (inbox.a == s["bal"][:, None])).any(dim=1))
        leading = s["leading"] & ~dep
        electing = s["electing"] & ~abort
        t_valid = s["t_valid"] & ~dep[:, None]

        # the seeded per-round jitter
        boff = torch.where(abort | dep, rnd + retry + jit1, s["boff"])
        deadline = torch.where(hb_cur | abort | dep,
                               rnd + lay.etimeout + me * 2 * retry + jit1,
                               s["deadline"])

        # ---- T_DONE retires rows and feeds the commit watermark
        done = v & (t == T_DONE)
        hit = _match_rows(t_valid, s["t_slot"], done, inbox.a)
        t_valid = t_valid & ~hit.any(dim=2)
        d_ok = (_first_per_key(done, inbox.a) & (inbox.a >= 0)
                & (inbox.a < C))
        done_bits = _put_rows(s["done_bits"], d_ok, inbox.a.clamp(0, C - 1),
                              True)
        dfront = s["dfront"]
        for _ in range(8):            # bounded advance; backlog drains
            nxt = (dfront + 1).clamp(0, C - 1)
            bit = torch.gather(done_bits, 1, nxt[:, None].long())[:, 0]
            dfront = torch.where(bit & (dfront + 1 < C), dfront + 1, dfront)

        # ---- T_PROM folds onto an open candidacy
        pr = (v & (t == T_PROM) & electing[:, None]
              & (inbox.a == s["bal"][:, None]))
        prom, rec_hi = s["prom"], s["rec_hi"]
        for k in range(K_):
            c = inbox.c[:, k]
            prom = torch.where(pr[:, k], prom | _bit(inbox.b[:, k]), prom)
            rec_hi = torch.where(pr[:, k],
                                 torch.maximum(rec_hi, (c & 0x1FFF) - 1),
                                 rec_hi)
            dfront = torch.where(pr[:, k],
                                 torch.maximum(dfront, (c >> 13) - 1), dfront)
        won = electing & _col_quorum(lay, prom)
        leading = leading | won
        electing = electing & ~won
        next_slot = torch.where(won, rec_hi + 1, s["next_slot"])
        # recovery starts above the commit watermark
        rec_next = torch.where(won, dfront + 1, s["rec_next"])
        heard = torch.where(won, rnd, heard)
        dur = torch.where(won, rnd - s["cand_round"], 0)
        won_count = s["won_count"] + won.to(I32)
        won_sum = s["won_sum"] + dur
        won_max = torch.maximum(s["won_max"], dur)
        hb_last = torch.where(won, rnd - retry, s["hb_last"])

        # ---- T_QVAL folds onto query-phase rows, lane by lane
        qv = v & (t == T_QVAL)
        q_idx = (inbox.c >> 16) & 0x7FFF
        q_bal = (inbox.c & 0xFFFF) - 1          # -1 = nothing accepted
        qmask, qbal, t_cmd = s["t_qmask"], s["t_qbal"], s["t_cmd"]
        for k in range(K_):
            m = (t_valid & s["t_q"] & qv[:, k, None]
                 & (s["t_slot"] == inbox.a[:, k, None]))
            qmask = torch.where(m, qmask | _bit(q_idx[:, k])[:, None], qmask)
            better = m & (q_bal[:, k, None] > qbal)
            qbal = torch.where(better, q_bal[:, k, None], qbal)
            t_cmd = torch.where(better, inbox.b[:, k, None], t_cmd)
        # a COLUMN of answers resolves the slot (a NO-OP fills a gap)
        res = t_valid & s["t_q"] & _col_quorum(lay, qmask)
        t_q = s["t_q"] & ~res
        t_cmd = torch.where(res & (qbal < 0), NOOP_CMD, t_cmd)
        t_last = torch.where(res, rnd - retry, s["t_last"])

        # ---- client commands: serve when leading, redirect otherwise
        creq = v & ((t == T_READ) | (t == T_WRITE) | (t == T_CAS))
        cmd_in = _client_cmd(lay, inbox)
        client = (inbox.src - lay.n_nodes).clamp(0, (1 << lay.CLIENT_BITS)
                                                 - 1)
        serve = creq & leading[:, None]
        redir = creq & ~leading[:, None]

        # recovery rows first, then the clients' on what is left
        kk = torch.arange(K_, dtype=I32, device=dev)[None, :]
        want_rec = leading[:, None] & (rec_next[:, None] + kk
                                       <= rec_hi[:, None])
        okr, rowr = _alloc_rows(t_valid, want_rec)
        fresh = rnd - retry
        t_valid = _put_rows(t_valid, okr, rowr, True)
        t_slot = _put_rows(s["t_slot"], okr, rowr, rec_next[:, None] + kk)
        t_cmd = _put_rows(t_cmd, okr, rowr, NOOP_CMD)
        t_client = _put_rows(s["t_client"], okr, rowr, 0)
        t_mid = _put_rows(s["t_mid"], okr, rowr, -1)    # recovered: no reply
        t_bal = _put_rows(s["t_bal"], okr, rowr, s["bal"][:, None])
        t_q = _put_rows(t_q, okr, rowr, True)
        qmask = _put_rows(qmask, okr, rowr, 0)
        qbal = _put_rows(qbal, okr, rowr, -1)
        t_last = _put_rows(t_last, okr, rowr, fresh)
        rec_next = rec_next + okr.sum(dim=1, dtype=I32)

        ok, row = _alloc_rows(t_valid, serve)
        slot = next_slot[:, None] + _rank(ok)
        do = ok & (slot < C)
        t_valid = _put_rows(t_valid, do, row, True)
        t_slot = _put_rows(t_slot, do, row, slot)
        t_cmd = _put_rows(t_cmd, do, row, cmd_in)
        t_client = _put_rows(t_client, do, row, client)
        t_mid = _put_rows(t_mid, do, row, inbox.mid)
        t_bal = _put_rows(t_bal, do, row, s["bal"][:, None])
        t_q = _put_rows(t_q, do, row, False)
        t_last = _put_rows(t_last, do, row, fresh)
        next_slot = next_slot + do.sum(dim=1, dtype=I32)

        # shed (backpressure, code 11) and redirect (code 31 + hint)
        shed = serve & ~do
        know = (rnd - heard <= lay.etimeout) & ((seen % S) != me)
        hint = torch.where(know, seen % S, -1)
        err_out = _out((n, K_), dev, valid=shed | redir, dest=inbox.src,
                       type=T_ERR,
                       a=torch.where(redir, E_NOT_LEADER, E_UNAVAILABLE),
                       b=torch.where(redir, hint[:, None], 0),
                       reply_to=inbox.mid)

        # ---- candidacy start: detector fired, backoff spent
        start = ~leading & ~electing & (rnd > deadline) & (rnd >= boff)
        newbal = (torch.maximum(s["bal"], seen) // S + 1) * S + me
        over = start & (newbal >= (1 << lay.bal_width))
        start = start & ~over
        bal = torch.where(start, newbal, s["bal"])
        bal_overflow = s["bal_overflow"] + over.to(I32)
        # out of ballots until a live leader re-arms the detector: park it
        deadline = torch.where(over, 0x7FFFFFFF, deadline)
        electing = electing | start
        prom = torch.where(start, 0, prom)
        rec_hi = torch.where(start, -1, rec_hi)
        cand_round = torch.where(start, rnd, s["cand_round"])
        t_valid = t_valid & ~start[:, None]     # stale rows are fenced
        elect_last = torch.where(start, rnd - retry, s["elect_last"])

        # ---- outbox lanes
        ptick = electing & (rnd - elect_last >= retry)
        elect_last = torch.where(ptick, rnd, elect_last)
        jjA = torch.arange(A, dtype=I32, device=dev)[None, :]
        prep_out = _out((n, A), dev,
                        valid=ptick[:, None] & (((prom[:, None] >> jjA) & 1)
                                                == 0),
                        dest=lay.a_base + jjA, type=T_PREP, a=bal[:, None])
        htick = leading & (rnd - hb_last >= retry)
        hb_last = torch.where(htick, rnd, hb_last)
        jjS = torch.arange(S, dtype=I32, device=dev)[None, :]
        hb_out = _out((n, S), dev, valid=htick[:, None] & (jjS != me[:, None]),
                      dest=lay.s_base + jjS, type=T_HB, a=bal[:, None])
        cmt_out = _out((n, A), dev,
                       valid=(htick & (dfront >= 0))[:, None].expand(n, A),
                       dest=lay.a_base + jjA, type=T_CMT, a=dfront[:, None])
        # per-row fan: query rows ask the acceptors that have not
        # answered, assign rows send T_ASSIGN (lane 0) to the slot's proxy
        due = t_valid & (rnd - t_last >= retry)
        t_last = torch.where(due, rnd, t_last)
        jj = torch.arange(AR, dtype=I32, device=dev)[None, None, :]
        isq = t_q[:, :, None]
        unanswered = ((qmask[:, :, None] >> jj.clamp(max=30)) & 1) == 0
        lane_valid = due[:, :, None] & torch.where(
            isq, (jj < A) & unanswered, jj == 0)
        lane_dest = torch.where(isq, lay.a_base + jj,
                                (lay.p_base + t_slot % lay.P)[:, :, None])
        lane_type = torch.where(isq, T_QRY, T_ASSIGN)
        pack_a = lay.pack_assign_a(t_bal, t_client, t_slot)
        lane_a = torch.where(t_q, t_slot, pack_a)[:, :, None]
        lane_b = torch.where(t_q, 0, t_cmd)[:, :, None]
        lane_c = torch.where(t_q, t_bal, t_mid)[:, :, None]

        def flat(x):
            return x.expand(n, Q, AR).reshape(n, Q * AR)
        fan_out = _out((n, Q * AR), dev, valid=flat(lane_valid),
                       dest=flat(lane_dest), type=flat(lane_type),
                       a=flat(lane_a), b=flat(lane_b), c=flat(lane_c))

        s.update(next_slot=next_slot, t_valid=t_valid, t_slot=t_slot,
                 t_cmd=t_cmd, t_client=t_client, t_mid=t_mid,
                 t_last=t_last, bal=bal, seen=seen, leading=leading,
                 electing=electing, prom=prom, cand_round=cand_round,
                 rec_hi=rec_hi, rec_next=rec_next, heard=heard,
                 deadline=deadline, boff=boff, hb_last=hb_last,
                 elect_last=elect_last, t_bal=t_bal, t_q=t_q,
                 t_qmask=qmask, t_qbal=qbal, done_bits=done_bits,
                 dfront=dfront, won_count=won_count, won_sum=won_sum,
                 won_max=won_max, bal_overflow=bal_overflow)
        return s, cat_lanes(fan_out, prep_out, cmt_out, hb_out, err_out)

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [n, K], ctx) -> (state', outbox Msgs [n,
        outbox_cap]); ctx["round"] the i32 round, ctx.get("stall") the
        [n] bool mask of stalled nodes, ctx["key"] the role's key (read
        only with S > 1, for the election jitter)."""
        stall, rnd = ctx.get("stall"), ctx["round"]
        if self.lay.S > 1:
            jit1 = self.jitter(ctx)
            if not K.use_kernel(inbox.valid):
                return freeze_step(stall, state, *self.step_plain_elect(
                    state, inbox, rnd, jit1))
            return self._launch_elect(state, inbox, rnd, stall, jit1)
        if not K.use_kernel(inbox.valid):
            return freeze_step(stall, state,
                               *self.step_plain(state, inbox, rnd))
        lay, n, kern = self.lay, self.n_nodes, K.COMPARTMENT_SEQUENCER_STEP
        K_ = _check_inbox(kern, inbox, n)
        Q = lay.QL
        _check_state(kern, state, {
            "next_slot": (I32, (n,)), "t_valid": (torch.bool, (n, Q)),
            **{k: (I32, (n, Q)) for k in SEQ_KEYS[1:]}})
        if max(Q, K_) > MAX_ROWS:
            raise ValueError(f"{kern.name}: leader_slots {Q} and inbox "
                             f"{K_} must be <= {MAX_ROWS}")
        dev = inbox.valid.device
        out = _new_msgs((n, Q + K_), dev)
        new = {k: torch.empty_like(state[k])
               for k in ("next_slot",) + SEQ_KEYS}
        kern.launch(
            _in_ptrs(inbox)
            + [state[k].contiguous() for k in ("next_slot",) + SEQ_KEYS]
            + [_check_round(kern, rnd), _check_stall(kern, stall, n)]
            + _out_ptrs(out) + [new[k] for k in ("next_slot",) + SEQ_KEYS],
            [n, K_, Q, lay.cap, lay.keys, lay.n_nodes, lay.p_base, lay.P,
             lay.retry], dev)
        return new, out

    def _launch_elect(self, state, inbox, rnd, stall, jit1):
        """K27 `compartment_sequencer_elect` on the card."""
        lay, n, kern = self.lay, self.n_nodes, K.COMPARTMENT_SEQUENCER_ELECT
        K_ = _check_inbox(kern, inbox, n)
        Q, C = lay.QL, lay.cap
        _check_state(kern, state, {
            k: (torch.bool if k in SEQ_BOOL else I32,
                (n, C) if k == "done_bits" else
                (n, Q) if k.startswith("t_") else (n,))
            for k in SEQ_ELECT_ALL})
        # a block's shared memory: the lanes, the table's ranks and fan
        # words, the done_bits row (48 KB at most)
        smem = (7 * K_ + 5 * Q) * 4 + K_ + C + Q
        if max(Q, K_, lay.S, lay.A) > MAX_ROWS or C > MAX_DONE_BITS \
                or smem > 48 * 1024:
            raise ValueError(f"{kern.name}: leader_slots {Q}, inbox {K_}, "
                             f"{lay.S} candidates and log_cap {C}")
        if jit1.shape != (n,) or jit1.dtype != I32:
            raise ValueError(f"{kern.name}: jitter {tuple(jit1.shape)} "
                             f"{jit1.dtype}")
        dev = inbox.valid.device
        out = _new_msgs((n, self.outbox_cap), dev)
        new = {k: torch.empty_like(state[k]) for k in state}
        kern.launch(
            _in_ptrs(inbox) + [state[k].contiguous() for k in SEQ_ELECT_ALL]
            + [jit1.contiguous(), _check_round(kern, rnd),
               _check_stall(kern, stall, n)]
            + _out_ptrs(out) + [new[k] for k in SEQ_ELECT_ALL],
            [n, K_, Q, C, lay.keys, lay.n_nodes, lay.p_base, lay.P,
             lay.retry, lay.S, lay.A, lay.AR, lay.a_base, lay.s_base,
             lay.rows, lay.cols, lay.etimeout, lay.bal_width], dev)
        return new, out


class ProxyRole(NodeProgram):
    """The stateless fan-out tier: phase-2a to the acceptor grid,
    row-quorum collection, then learn until every replica acks.
    VOLATILE (`durable_keys = ()`): a kill wipes the table and the
    leader's resends rebuild it. With S > 1 rows carry their assigning
    BALLOT: a higher-ballot assign replaces a stale row, acks must echo
    the row's ballot, and a T_P2R fence drops the row and notifies the
    stale leader (T_NLDR)."""

    name = "compartment-proxy"
    durable_keys = ()            # stateless tier: nothing survives

    def __init__(self, opts, nodes, lay: Layout, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.lay = lay
        # the conviction duty: with the adversary in the fault set the
        # proxy carries evidence leaves and NACKs convicted assigns (K
        # more outbox lanes); static, so benign trees stay as they are
        self.byz = byz_enabled(opts)
        self.inbox_cap = lay.K
        self.outbox_cap = (lay.QP * lay.AR + lay.QP
                           + (lay.K if lay.S > 1 else 0)
                           + (lay.K if self.byz else 0))

    def init_state(self):
        n, Q, AR, dev = self.n_nodes, self.lay.QP, self.lay.AR, self.device

        def z(*s):
            return torch.zeros(s, dtype=I32, device=dev)
        st = {"p_valid": torch.zeros((n, Q), dtype=torch.bool, device=dev),
              "p_learn": torch.zeros((n, Q), dtype=torch.bool, device=dev),
              "p_slot": z(n, Q), "p_cmd": z(n, Q),
              "p_client": z(n, Q), "p_mid": z(n, Q),
              "p_last": torch.full((n, Q), -(1 << 20), dtype=I32,
                                   device=dev),
              "p_acks": torch.zeros((n, Q, AR), dtype=torch.bool,
                                    device=dev)}
        if self.lay.S > 1:
            st["p_bal"] = z(n, Q)
        if self.byz:
            # conviction evidence, volatile like the rest of the tier:
            # counts of equivocating and residue-violating assigns, the
            # round of each first conviction, and the witness maxima
            st.update({k: z(n) for k in ("z_eq", "z_sb")})
            st.update({k: torch.full((n,), -1, dtype=I32, device=dev)
                       for k in Z_KEYS[2:]})
        return st

    def quiet_planes(self, state):
        return [state["p_valid"]]

    def step_plain(self, state, inbox, rnd):
        lay = self.lay
        n, K_ = inbox.valid.shape
        Q, AR, S, dev = lay.QP, lay.AR, lay.S, inbox.valid.device
        s = dict(state)
        v, t = inbox.valid, inbox.type
        idx_ar = torch.arange(AR, dtype=I32, device=dev)
        onehot = inbox.b[:, :, None] == idx_ar[None, None, :]   # [n, K, AR]

        # acceptor acks onto phase-2 rows, replica acks onto learn rows;
        # with ballots a P2B must echo the row's ballot
        p2b = _match_rows(s["p_valid"] & ~s["p_learn"], s["p_slot"],
                          v & (t == T_P2B), inbox.a)
        if S > 1:
            p2b = p2b & (s["p_bal"][:, :, None] == inbox.c[:, None, :])
        ex = _match_rows(s["p_valid"] & s["p_learn"], s["p_slot"],
                         v & (t == T_EXEC), inbox.a)
        s["p_acks"] = s["p_acks"] | (
            (p2b | ex)[:, :, :, None] & onehot[:, None]).any(dim=2)

        # every replica acked: retire the row, T_DONE to the assigning
        # leader (ballot % S)
        done = (s["p_valid"] & s["p_learn"]
                & s["p_acks"][:, :, :lay.R].all(dim=2))
        done_dest = (lay.leader if S == 1
                     else lay.s_base + s["p_bal"] % S)
        done_out = _out((n, Q), dev, valid=done, dest=done_dest,
                        type=T_DONE, a=s["p_slot"])
        s["p_valid"] = s["p_valid"] & ~done

        # flexible grid quorum: any complete acceptor ROW chooses
        grid = s["p_acks"][:, :, :lay.A].reshape(n, Q, lay.rows, lay.cols)
        chosen = (s["p_valid"] & ~s["p_learn"]
                  & grid.all(dim=3).any(dim=2))
        s["p_learn"] = s["p_learn"] | chosen
        s["p_acks"] = s["p_acks"] & ~chosen[:, :, None]
        s["p_last"] = torch.where(chosen, rnd - lay.retry,
                                  s["p_last"]).to(I32)

        outs = []
        if S > 1:
            # T_P2R: the grid fenced this row's ballot — drop the row and
            # tell the stale leader (routed by the row's ballot residue)
            rej = v & (t == T_P2R)
            rejhit = (_match_rows(s["p_valid"], s["p_slot"], rej, inbox.a)
                      & (s["p_bal"][:, :, None] < inbox.c[:, None, :]))
            s["p_valid"] = s["p_valid"] & ~rejhit.any(dim=2)
            stale_bal = torch.where(rejhit, s["p_bal"][:, :, None],
                                    0).amax(dim=1)
            outs.append(_out((n, K_), dev, valid=rejhit.any(dim=1),
                             dest=lay.s_base + stale_bal % S, type=T_NLDR,
                             a=inbox.c))

        # new assignments (slot-keyed dedup; with ballots a higher-ballot
        # assign replaces a stale row and a stale assign drops; a full
        # table drops and the leader's retry tick re-delivers)
        bal_in, client_in, slot_in = lay.unpack_assign_a(inbox.a)
        asg = _first_per_key(v & (t == T_ASSIGN), slot_in)
        if self.byz:
            asg, nack = self._convict(s, inbox, asg, bal_in, slot_in, rnd)
            outs.append(nack)
        hit = _match_rows(s["p_valid"], s["p_slot"], asg, slot_in)
        if S > 1:
            row_bal = s["p_bal"][:, :, None]
            stale_msg = (hit & (row_bal >= bal_in[:, None, :])).any(dim=1)
            upgrade = (hit & (row_bal < bal_in[:, None, :])).any(dim=2)
            s["p_valid"] = s["p_valid"] & ~upgrade
            asg = asg & ~stale_msg
        else:
            asg = asg & ~hit.any(dim=1)
        ok, row = _alloc_rows(s["p_valid"], asg)
        s["p_valid"] = _put_rows(s["p_valid"], ok, row, True)
        s["p_learn"] = _put_rows(s["p_learn"], ok, row, False)
        s["p_slot"] = _put_rows(s["p_slot"], ok, row, slot_in)
        s["p_cmd"] = _put_rows(s["p_cmd"], ok, row, inbox.b)
        s["p_client"] = _put_rows(s["p_client"], ok, row, client_in)
        s["p_mid"] = _put_rows(s["p_mid"], ok, row, inbox.c)
        s["p_last"] = _put_rows(s["p_last"], ok, row,
                                (rnd - lay.retry).to(I32))
        if S > 1:
            s["p_bal"] = _put_rows(s["p_bal"], ok, row, bal_in)
        fresh = _put_rows(torch.zeros((n, Q), dtype=torch.bool, device=dev),
                          ok, row, True)
        s["p_acks"] = s["p_acks"] & ~fresh[:, :, None]

        # fan-out lanes: row q, lane j -> acceptor j (phase 2a) or
        # replica j (learn), on the retry tick
        due = s["p_valid"] & (rnd - s["p_last"] >= lay.retry)
        s["p_last"] = torch.where(due, rnd, s["p_last"]).to(I32)
        jj = idx_ar[None, None, :].expand(n, Q, AR)
        learn = s["p_learn"][:, :, None]
        lane_valid = due[:, :, None] & torch.where(learn, jj < lay.R,
                                                   jj < lay.A)
        lane_dest = torch.where(learn, lay.r_base + jj, lay.a_base + jj)
        lane_type = torch.where(learn, T_LEARN, T_P2A)
        learn_a = lay.pack_learn_a(s["p_client"], s["p_slot"])
        lane_a = torch.where(learn, learn_a[:, :, None],
                             s["p_slot"][:, :, None])
        lane_b = s["p_cmd"][:, :, None].expand(n, Q, AR)
        p2a_c = 0 if S == 1 else s["p_bal"][:, :, None]
        lane_c = torch.where(learn, s["p_mid"][:, :, None], p2a_c)

        def flat(x):
            return x.expand(n, Q, AR).reshape(n, Q * AR)
        fan_out = _out((n, Q * AR), dev, valid=flat(lane_valid),
                       dest=flat(lane_dest), type=flat(lane_type),
                       a=flat(lane_a), b=flat(lane_b), c=flat(lane_c))
        return s, cat_lanes(fan_out, done_out, *outs)

    def _convict(self, s, inbox, asg, bal_in, slot_in, rnd):
        """The conviction lanes (JAX `compartment.py:948-1000`), on the
        rows left after retirement and the T_P2R drop: an equivocation is
        a first-per-slot T_ASSIGN that hits a live row of its slot with a
        different command (at the same ballot with S > 1: an honest
        leader resends one payload and two leaders never share a
        ballot); a stale ballot (S > 1) lies outside the sender's residue
        class. Convicted lanes leave `asg`, are counted into `s` (first-
        conviction round stamps set while the count is 0, witness maxima
        over the lanes) and NACKed T_ERR / E_BYZANTINE to their source.
        Returns (asg, the NACK lanes)."""
        S, rnd = self.lay.S, torch.as_tensor(rnd, dtype=I32)
        n, K_ = asg.shape
        hit0 = _match_rows(s["p_valid"], s["p_slot"], asg, slot_in)
        cmd_neq = s["p_cmd"][:, :, None] != inbox.b[:, None, :]
        if S > 1:
            eq_lane = (hit0 & cmd_neq & (s["p_bal"][:, :, None]
                                         == bal_in[:, None, :])).any(dim=1)
            sb_lane = asg & (bal_in % S != inbox.src)
        else:
            eq_lane = (hit0 & cmd_neq).any(dim=1)
            sb_lane = torch.zeros_like(asg)
        asg = asg & ~eq_lane & ~sb_lane
        any_eq, any_sb = eq_lane.any(dim=1), sb_lane.any(dim=1)
        s["z_eq_rnd"] = torch.where((s["z_eq"] == 0) & any_eq, rnd,
                                    s["z_eq_rnd"])
        s["z_sb_rnd"] = torch.where((s["z_sb"] == 0) & any_sb, rnd,
                                    s["z_sb_rnd"])
        s["z_eq"] = s["z_eq"] + eq_lane.sum(dim=1, dtype=I32)
        s["z_sb"] = s["z_sb"] + sb_lane.sum(dim=1, dtype=I32)

        def wit(lane, f):
            return torch.where(lane, f, -1).amax(dim=1)
        for key, lane, any_, f in (("z_eq_src", eq_lane, any_eq, inbox.src),
                                   ("z_eq_slot", eq_lane, any_eq, slot_in),
                                   ("z_sb_src", sb_lane, any_sb, inbox.src),
                                   ("z_sb_bal", sb_lane, any_sb, bal_in)):
            s[key] = torch.where(any_, wit(lane, f), s[key])
        nack = _out((n, K_), asg.device, valid=eq_lane | sb_lane,
                    dest=inbox.src, type=T_ERR, a=E_BYZANTINE, b=slot_in,
                    c=bal_in)
        return asg, nack

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [n, K], ctx) -> (state', outbox Msgs [n,
        QP * AR + QP], + K lanes of T_NLDR with S > 1, + K lanes of
        E_BYZANTINE NACKs with the adversary)."""
        stall, rnd = ctx.get("stall"), ctx["round"]
        if not K.use_kernel(inbox.valid):
            return freeze_step(stall, state,
                               *self.step_plain(state, inbox, rnd))
        lay, n = self.lay, self.n_nodes
        elect = lay.S > 1
        kern = (K.COMPARTMENT_PROXY_ELECT if elect
                else K.COMPARTMENT_PROXY_STEP)
        keys = PROXY_KEYS + (("p_bal",) if elect else ())
        K_ = _check_inbox(kern, inbox, n)
        Q, AR = lay.QP, lay.AR
        _check_state(kern, state, {
            "p_valid": (torch.bool, (n, Q)), "p_learn": (torch.bool, (n, Q)),
            **{k: (I32, (n, Q)) for k in PROXY_KEYS[2:7]},
            "p_acks": (torch.bool, (n, Q, AR)),
            **({"p_bal": (I32, (n, Q))} if elect else {}),
            **({k: (I32, (n,)) for k in Z_KEYS} if self.byz else {})})
        if max(Q, K_) > MAX_ROWS or Q * AR > 32768:
            raise ValueError(f"{kern.name}: proxy_slots {Q}, inbox {K_}, "
                             f"{AR} acks a row")
        dev = inbox.valid.device
        out = _new_msgs((n, self.outbox_cap), dev)
        # the conviction lanes ride behind a flag: with it off the
        # evidence planes are null pointers
        zkeys = Z_KEYS if self.byz else ()
        new = {k: torch.empty_like(state[k]) for k in keys + zkeys}
        z_ptrs = ([state[k].contiguous() for k in zkeys]
                  + [new[k] for k in zkeys]) or [None] * (2 * len(Z_KEYS))
        ints = [n, K_, Q, AR, lay.A, lay.R, lay.rows, lay.cols]
        ints += ([lay.S, lay.s_base] if elect else [lay.leader])
        kern.launch(
            _in_ptrs(inbox) + [state[k].contiguous() for k in keys]
            + [_check_round(kern, rnd), _check_stall(kern, stall, n)]
            + _out_ptrs(out) + [new[k] for k in keys] + z_ptrs,
            ints + [lay.a_base, lay.r_base, lay.retry, int(self.byz)], dev)
        return new, out


class AcceptorRole(NodeProgram):
    """One grid cell: stores the command proposed for each slot and acks
    with its grid index so proxies can assemble row quorums. Durable:
    accepted state fsyncs before the ack leaves. With S > 1 it is a full
    Paxos acceptor: `promised` fences stale T_PREP (T_REJP) and
    stale-ballot T_P2A (T_P2R), promises carry the highest accepted slot
    and the commit watermark, and T_QRY reads back a slot's (cmd,
    accepted ballot)."""

    name = "compartment-acceptor"
    durable_keys = None

    def __init__(self, opts, nodes, lay: Layout, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.lay = lay
        self.inbox_cap = lay.K
        self.outbox_cap = lay.K

    def init_state(self):
        n, C, dev = self.n_nodes, self.lay.cap, self.device
        st = {"acc_cmd": torch.zeros((n, C), dtype=I32, device=dev),
              "acc_has": torch.zeros((n, C), dtype=torch.bool, device=dev)}
        if self.lay.S > 1:
            st.update({
                "promised": torch.zeros((n,), dtype=I32, device=dev),
                "acc_bal": torch.zeros((n, C), dtype=I32, device=dev),
                "acc_hi": torch.full((n,), -1, dtype=I32, device=dev),
                "acc_cmt": torch.full((n,), -1, dtype=I32, device=dev)})
        return st

    def quiet_planes(self, state):
        return []

    def step_plain(self, state, inbox, rnd=None):
        C = self.lay.cap
        n, K_ = inbox.valid.shape
        dev = inbox.valid.device
        s = dict(state)
        p2a = _first_per_key(inbox.valid & (inbox.type == T_P2A), inbox.a)
        in_cap = p2a & (inbox.a >= 0) & (inbox.a < C)
        tgt = inbox.a.clamp(0, C - 1)
        s["acc_cmd"] = _put_rows(s["acc_cmd"], in_cap, tgt, inbox.b)
        s["acc_has"] = _put_rows(s["acc_has"], in_cap, tgt, True)
        me = torch.arange(n, dtype=I32, device=dev)[:, None]
        acks = _out((n, K_), dev, valid=in_cap, dest=inbox.src, type=T_P2B,
                    a=inbox.a, b=me)
        return s, acks

    def step_plain_elect(self, state, inbox, rnd=None):
        """The JAX package's `AcceptorRole._step_elect`
        (compartment.py:1115-1200)."""
        C = self.lay.cap
        n, K_ = inbox.valid.shape
        dev = inbox.valid.device
        s = dict(state)
        v, t = inbox.valid, inbox.type
        me = torch.arange(n, dtype=I32, device=dev)[:, None]

        # the commit watermark (monotone, durable)
        cmt = v & (t == T_CMT)
        s["acc_cmt"] = torch.maximum(
            s["acc_cmt"], _max_lanes(torch.where(cmt, inbox.a, -1)))

        # promises: only the round's highest prepare is promised, the
        # rest are rejected with the new floor
        prep = _first_per_key(v & (t == T_PREP), inbox.a)
        pmax = torch.maximum(s["promised"],
                             _max_lanes(torch.where(prep, inbox.a, -1)))
        prom_ok = prep & (inbox.a == pmax[:, None])
        prom_rej = prep & ~prom_ok

        # phase 2a: accept iff the ballot clears the promise floor;
        # fenced proposals nack (T_P2R); accepting b promises b
        p2a = _first_per_key(v & (t == T_P2A), inbox.a)
        in_cap = p2a & (inbox.a >= 0) & (inbox.a < C)
        ok2a = in_cap & (inbox.c >= pmax[:, None])
        nack = in_cap & ~ok2a
        s["promised"] = torch.maximum(
            pmax, _max_lanes(torch.where(ok2a, inbox.c, -1)))
        tgt = inbox.a.clamp(0, C - 1)
        s["acc_cmd"] = _put_rows(s["acc_cmd"], ok2a, tgt, inbox.b)
        s["acc_has"] = _put_rows(s["acc_has"], ok2a, tgt, True)
        s["acc_bal"] = _put_rows(s["acc_bal"], ok2a, tgt, inbox.c)
        s["acc_hi"] = torch.maximum(
            s["acc_hi"], _max_lanes(torch.where(ok2a, inbox.a, -1)))

        # recovery reads: the post-update (cmd, accepted ballot) of the
        # slot
        qry = v & (t == T_QRY)
        qs = tgt.long()
        g_cmd = torch.gather(s["acc_cmd"], 1, qs)
        g_bal = torch.gather(s["acc_bal"], 1, qs)
        g_has = (torch.gather(s["acc_has"], 1, qs) & (inbox.a >= 0)
                 & (inbox.a < C))

        # one reply a lane (each lane is exactly one RPC kind)
        rtype = torch.where(
            ok2a, T_P2B, torch.where(
                nack, T_P2R, torch.where(
                    prom_ok, T_PROM, torch.where(prom_rej, T_REJP,
                                                 T_QVAL))))
        rb = torch.where(qry, g_cmd, torch.where(prom_rej, 0, me))
        qval_c = (me << 16) | torch.where(g_has, g_bal + 1, 0)
        prom_c = ((s["acc_cmt"] + 1) << 13) | (s["acc_hi"] + 1)
        rc = torch.where(ok2a, inbox.c, torch.where(
            nack | prom_rej, pmax[:, None],
            torch.where(prom_ok, prom_c[:, None], qval_c)))
        out = _out((n, K_), dev,
                   valid=ok2a | nack | prom_ok | prom_rej | qry,
                   dest=inbox.src, type=rtype, a=inbox.a, b=rb, c=rc)
        return s, out

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [n, K], ctx) -> (state', outbox Msgs [n,
        K])."""
        stall = ctx.get("stall")
        elect = self.lay.S > 1
        if not K.use_kernel(inbox.valid):
            plain = self.step_plain_elect if elect else self.step_plain
            return freeze_step(stall, state, *plain(state, inbox))
        n, C = self.n_nodes, self.lay.cap
        kern = (K.COMPARTMENT_ACCEPTOR_ELECT if elect
                else K.COMPARTMENT_ACCEPTOR_STEP)
        K_ = _check_inbox(kern, inbox, n)
        keys = ACC_ELECT_KEYS if elect else ACC_ELECT_KEYS[:2]
        _check_state(kern, state, {
            k: (torch.bool if k == "acc_has" else I32,
                (n, C) if k in ("acc_cmd", "acc_has", "acc_bal") else (n,))
            for k in keys})
        if K_ > MAX_ROWS:
            raise ValueError(f"{kern.name}: inbox {K_} > {MAX_ROWS}")
        dev = inbox.valid.device
        out = _new_msgs((n, K_), dev)
        old = [state[k].contiguous() for k in keys]
        new = {k: torch.empty_like(state[k]) for k in keys}
        vec = C % 16 == 0 and _aligned16(
            *[p for p in old if p.dim() == 2],
            *[new[k] for k in keys if new[k].dim() == 2])
        kern.launch(
            _in_ptrs(inbox) + old + [_check_stall(kern, stall, n)]
            + _out_ptrs(out) + [new[k] for k in keys],
            [n, K_, C, int(vec)], dev)
        return new, out


class GridAcceptors(AcceptorRole):
    """Acceptor role with named fault subgroups: the grid's rows and
    columns, for `--nemesis-targets partition=acceptor-col-0` style
    role-targeted faults."""

    def fault_subgroups(self, names):
        lay = self.lay
        out = {}
        for c in range(lay.cols):
            out[f"acceptor-col-{c}"] = [names[r * lay.cols + c]
                                        for r in range(lay.rows)]
        for r in range(lay.rows):
            out[f"acceptor-row-{r}"] = list(
                names[r * lay.cols:(r + 1) * lay.cols])
        return out


class ReplicaRole(NodeProgram):
    """The apply tier: learned commands land at their slots and every
    deduped learn acks back (T_EXEC) the moment it is stored — storage
    acks, not apply acks, so one slot's completion never waits on
    another's. Commands apply strictly in slot order (AP a round; a slot
    learned this round may apply this round), and the designated
    replica (`slot % R`) answers the client with the apply-point value."""

    name = "compartment-replica"
    durable_keys = None

    def __init__(self, opts, nodes, lay: Layout, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.lay = lay
        self.inbox_cap = lay.K
        self.outbox_cap = lay.AP + lay.K

    def init_state(self):
        n, C, dev = self.n_nodes, self.lay.cap, self.device

        def z(*s):
            return torch.zeros(s, dtype=I32, device=dev)
        return {"r_cmd": z(n, C), "r_client": z(n, C), "r_mid": z(n, C),
                "r_has": torch.zeros((n, C), dtype=torch.bool, device=dev),
                "applied": torch.full((n,), -1, dtype=I32, device=dev),
                "kv": z(n, self.lay.keys)}

    def quiet_planes(self, state):
        # the next slot to apply is stored: busy (read at clip(applied +
        # 1), with no idx < C test, as the JAX package's `quiescent`)
        nxt = (state["applied"] + 1).clamp(0, self.lay.cap - 1)
        return [torch.gather(state["r_has"], 1, nxt[:, None].long())[:, 0]]

    def step_plain(self, state, inbox, rnd=None):
        lay = self.lay
        n, K_ = inbox.valid.shape
        C, keys, dev = lay.cap, lay.keys, inbox.valid.device
        s = dict(state)
        me = torch.arange(n, dtype=I32, device=dev)
        client_in, slot_in = lay.unpack_learn_a(inbox.a)
        lr = _first_per_key(inbox.valid & (inbox.type == T_LEARN), slot_in)
        in_cap = lr & (slot_in < C)
        tgt = slot_in.clamp(0, C - 1)
        s["r_cmd"] = _put_rows(s["r_cmd"], in_cap, tgt, inbox.b)
        s["r_client"] = _put_rows(s["r_client"], in_cap, tgt, client_in)
        s["r_mid"] = _put_rows(s["r_mid"], in_cap, tgt, inbox.c)
        s["r_has"] = _put_rows(s["r_has"], in_cap, tgt, True)

        # storage acks: every deduped learn acks once stored
        ack_out = _out((n, K_), dev, valid=in_cap, dest=inbox.src,
                       type=T_EXEC, a=slot_in, b=me[:, None])

        # in-order apply, one chunk a round (a CAS may read the key the
        # previous step wrote: the kv chain is sequential)
        kv = torch.cat([s["kv"], s["kv"].new_zeros((n, 1))], dim=1)
        applied = s["applied"]

        def at(plane, i):
            return torch.gather(plane, 1, i[:, None].long())[:, 0]
        lanes = []
        for _j in range(lay.AP):
            idx = applied + 1
            safe = idx.clamp(0, C - 1)
            active = (idx < C) & at(s["r_has"], safe)
            cmd = at(s["r_cmd"], safe)
            client, mid = at(s["r_client"], safe), at(s["r_mid"], safe)
            key, op, v1, v2 = _unpack_cmd(cmd)
            inb = key < keys
            # a key past the row reads JAX's fill (INT32_MIN) and writes
            # nothing
            cur_v = torch.where(inb, at(kv, key.clamp(max=keys)),
                                torch.iinfo(torch.int32).min).to(I32)
            cas_ok = (op == OP_CAS) & (cur_v == v1) & (cur_v > 0)
            do_write = active & ((op == OP_WRITE) | cas_ok) & inb
            new_v = torch.where(op == OP_WRITE, v1, v2)
            kv = kv.scatter(1, torch.where(do_write, key, keys)[:, None]
                            .long(), new_v[:, None])
            applied = torch.where(active, idx, applied)
            desig = (active & ((idx % lay.R) == me) & (mid >= 0)
                     & (op != OP_NOOP))
            rtype = torch.where(
                op == OP_READ, torch.where(cur_v > 0, T_READ_OK, T_ERR),
                torch.where(op == OP_WRITE, T_WRITE_OK,
                            torch.where(cas_ok, T_CAS_OK, T_ERR))).to(I32)
            ra = torch.where(
                op == OP_READ, torch.where(cur_v > 0, cur_v, 20),
                torch.where((op == OP_CAS) & ~cas_ok,
                            torch.where(cur_v > 0, 22, 20), 0)).to(I32)
            lanes.append((desig, lay.n_nodes + client, rtype, ra, mid))
        s["kv"] = kv[:, :keys]
        s["applied"] = applied

        def col(i):
            return torch.stack([ln[i] for ln in lanes], dim=1)
        apply_out = _out((n, lay.AP), dev, valid=col(0), dest=col(1),
                         type=col(2), a=col(3), reply_to=col(4))
        return s, cat_lanes(apply_out, ack_out)

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [n, K], ctx) -> (state', outbox Msgs [n,
        AP + K])."""
        stall = ctx.get("stall")
        if not K.use_kernel(inbox.valid):
            return freeze_step(stall, state, *self.step_plain(state, inbox))
        lay, n, kern = self.lay, self.n_nodes, K.COMPARTMENT_REPLICA_STEP
        K_ = _check_inbox(kern, inbox, n)
        C, keys = lay.cap, lay.keys
        _check_state(kern, state, {
            **{k: (I32, (n, C)) for k in REPLICA_KEYS[:3]},
            "r_has": (torch.bool, (n, C)), "applied": (I32, (n,)),
            "kv": (I32, (n, keys))})
        if K_ > MAX_ROWS or keys > MAX_KV_KEYS:
            raise ValueError(f"{kern.name}: inbox {K_}, keys {keys}")
        dev = inbox.valid.device
        out = _new_msgs((n, lay.AP + K_), dev)
        names = REPLICA_KEYS + ("applied", "kv")
        old = [state[k].contiguous() for k in names]
        new = {k: torch.empty_like(state[k]) for k in names}
        vec = C % 16 == 0 and _aligned16(*old[:4],
                                         *[new[k] for k in REPLICA_KEYS])
        # the learn word's layout: client<<16 | slot with one sequencer,
        # client<<12 | slot (12-bit fields) with an elected tier
        slot_mask, cshift, cmask = ((0x7FFF, 16, -1) if lay.S == 1
                                    else (0xFFF, 12, 0xFFF))
        kern.launch(
            _in_ptrs(inbox) + old + [_check_stall(kern, stall, n)]
            + _out_ptrs(out) + [new[k] for k in names],
            [n, K_, C, keys, lay.AP, lay.R, lay.n_nodes, int(vec),
             slot_mask, cshift, cmask], dev)
        return new, out


@register
class CompartmentProgram(LinKVWire, RolePartition):
    """`--node tpu:compartment`: the role-partitioned compartmentalized
    consensus cluster (see the module docstring). Serves lin-kv through
    the shared wire vocabulary; clients talk to the sequencer the host
    believes leads, following not-leader redirects (code 31 with a
    `hint` node) through the runner's seeded backoff requeue."""

    name = "compartment"

    def __init__(self, opts, nodes, device="cuda"):
        lay = Layout(opts, len(nodes))
        self.lay = lay
        # the adversary's surfaces (byz_wire) and the proxies' evidence
        # (byz_evidence) exist only when the fault set holds byzantine
        self.byz = byz_enabled(opts)
        # the host's leader guess: where new client ops are routed,
        # moved by redirect hints, timeouts and the lease
        self._leader_guess = lay.leader
        # the client-side leader lease: with an elected tier the guess
        # expires `leader_lease_ms` of virtual time after the last reply
        # from it (default twice the election timeout; 0 turns it off),
        # so new ops rotate to the next candidate at detection speed
        # instead of each waiting out its RPC timeout. One probe an
        # expired window (the expiry re-arms)
        self._host_round = 0
        self._lease_ok = None       # armed at the first routed op
        self._lease_rounds = 0
        if lay.S > 1:
            mpr = float(opts.get("ms_per_round", 1.0) or 1.0)
            lease_ms = opts.get("leader_lease_ms")
            if lease_ms is None:
                self._lease_rounds = 2 * lay.etimeout
            else:
                self._lease_rounds = max(0, int(float(lease_ms) / mpr))
        roles = [
            ("sequencers", SequencerRole(opts, nodes[:lay.p_base], lay,
                                         device=device)),
            ("proxies", ProxyRole(opts, nodes[lay.p_base:lay.a_base], lay,
                                  device=device)),
            ("acceptors", GridAcceptors(opts, nodes[lay.a_base:lay.r_base],
                                        lay, device=device)),
            ("replicas", ReplicaRole(opts, nodes[lay.r_base:], lay,
                                     device=device)),
        ]
        RolePartition.__init__(self, opts, nodes, roles)

    def node_for_op(self, op):
        if self._lease_rounds:
            if self._lease_ok is None:
                # arm at the first routed op: before any op there is no
                # silence to measure
                self._lease_ok = self._host_round
            elif self._host_round - self._lease_ok > self._lease_rounds:
                # expired: rotate to the next candidate and re-arm
                self._leader_guess = (self._leader_guess + 1) % self.lay.S
                self._lease_ok = self._host_round
        return self._leader_guess

    def observe_round(self, r: int):
        """Runner hook: the virtual round at each routing boundary (what
        the lease expiry is measured against)."""
        self._host_round = int(r)

    def note_reply(self, node_idx: int, rnd: int | None = None):
        """Runner hook: any reply from the guessed leader (ok, shed or
        redirect) proves it alive and renews the lease."""
        if int(node_idx) == self._leader_guess:
            r = int(rnd) if rnd is not None else self._host_round
            self._lease_ok = (r if self._lease_ok is None
                              else max(self._lease_ok, r))

    # --- leader-redirect client routing (runner hooks) ------------------

    def decode_body(self, t, a, b, c, intern):
        if t == T_ERR and a == E_NOT_LEADER:
            return {"type": "error", "code": E_NOT_LEADER,
                    "text": "not leader", "hint": int(b)}
        if t == T_ERR and a == E_BYZANTINE:
            return {"type": "error", "code": E_BYZANTINE,
                    "text": "byzantine", "slot": int(b), "bal": int(c)}
        return super().decode_body(t, a, b, c, intern)

    # --- the byzantine adversary -------------------------------------------

    def byz_wire(self):
        """The pool-path corruption surface (`byzantine.corrupt_pool`,
        K30), or None without the adversary: the culprit sequencer's
        T_ASSIGN lanes. Equivocation xors the command's value byte with a
        round-varying nonzero pattern, so any two emissions of one slot
        and ballot conflict (a consistent lie would pass for an honest
        assign); with S > 1 stale-ballot re-stamps the ballot outside the
        sender's residue class. S == 1 has no ballot field."""
        return PoolWire(T_ASSIGN, self.lay.S) if self.byz else None

    def byz_evidence(self, nodes_host) -> list:
        """The proxies' evidence planes as conviction triples: per rule
        with a nonzero count, the loudest witness proxy names the culprit
        (its last convicted source, else the raw index) and the evidence
        (the count over the tier, the witness's slot or ballot, and the
        earliest first-conviction round)."""
        if not self.byz:
            return []
        px = nodes_host["proxies"]
        out = []
        for rule, cnt_key, src_key, ev_key, ev_name in (
                ("equivocation", "z_eq", "z_eq_src", "z_eq_slot", "slot"),
                ("stale-ballot", "z_sb", "z_sb_src", "z_sb_bal",
                 "ballot")):
            cnt = np.asarray(px[cnt_key])
            if int(cnt.sum()) == 0:
                continue
            w = int(cnt.argmax())
            src = int(np.asarray(px[src_key])[w])
            culprit = (self.nodes[src] if 0 <= src < len(self.nodes)
                       else src)
            rnds = np.asarray(px[cnt_key + "_rnd"])
            live = rnds[rnds >= 0]
            out.append(conviction(
                rule, culprit,
                {"count": int(cnt.sum()),
                 ev_name: int(np.asarray(px[ev_key])[w]),
                 "round": int(live.min()) if live.size else -1},
                witness=self.nodes[self.lay.p_base + w]))
        return out

    def redirect_hint(self, body):
        """A leader-redirect error body -> the hinted node id (-1 = no
        live leader known: probe the next candidate), or None for every
        other error (complete normally)."""
        if body.get("code") == E_NOT_LEADER:
            return int(body.get("hint", -1))
        return None

    def next_probe(self, contacted: int) -> int:
        """Round-robin candidate probe when a redirect carries no hint."""
        return (int(contacted) + 1) % self.lay.S

    def note_leader(self, node_idx: int):
        if 0 <= int(node_idx) < self.lay.S:
            self._leader_guess = int(node_idx)
            # a fresh hint is lease evidence: do not expire at once the
            # node a redirect just pointed at
            self._lease_ok = self._host_round

    def note_timeout(self, node_idx: int):
        """An RPC to `node_idx` timed out: if that was the leader guess
        (a killed, paused or cut-off leader), rotate to the next
        candidate so new ops probe the rest of the tier."""
        if self.lay.S > 1 and int(node_idx) == self._leader_guess:
            self._leader_guess = (self._leader_guess + 1) % self.lay.S

    # --- dynamic nemesis targeting and election accounting ----------------

    def dynamic_fault_groups(self):
        """`--nemesis-targets kill=sequencer` resolves at invoke time to
        the live leader, unlike the static `sequencers` group."""
        return ("sequencer",)

    def current_leader_host(self, nodes_host) -> int:
        """The live leader's global node id from a host copy of the node
        state (the nemesis reads it at each targeted kill)."""
        if self.lay.S == 1:
            return self.lay.leader
        import numpy as np
        seq = nodes_host["sequencers"]
        lead = np.asarray(seq["leading"])
        bal = np.asarray(seq["bal"])
        if lead.any():
            return int(np.argmax(np.where(lead, bal, -1)))
        return int(np.max(np.asarray(seq["seen"])) % self.lay.S)

    def election_report(self, nodes_host) -> dict | None:
        """Election accounting for `checkers/availability.py`: completed
        failovers (wins past node 0's ballot-0 incumbency), rounds from
        candidacy to win (mean / max), the highest ballot burned and the
        current leader. None with one sequencer."""
        if self.lay.S == 1:
            return None
        import numpy as np
        seq = nodes_host["sequencers"]
        won = np.asarray(seq["won_count"])
        wsum = np.asarray(seq["won_sum"])
        wmax = np.asarray(seq["won_max"])
        total = int(won.sum())
        rep = {
            "candidates": int(self.lay.S),
            "failovers": total,
            "wins-per-candidate": [int(x) for x in won],
            "ballot": int(np.asarray(seq["bal"]).max()),
            "leader": self.current_leader_host(nodes_host),
            "ballot-overflows": int(
                np.asarray(seq["bal_overflow"]).sum()),
        }
        if total:
            rep["rounds-to-leader"] = {
                "mean": round(float(wsum.sum()) / total, 2),
                "max": int(wmax.max()),
            }
        return rep
