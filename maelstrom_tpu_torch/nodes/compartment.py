"""Compartmentalized consensus with a stable leader: the role-partitioned
sequencer / proxy / acceptor / replica cluster serving lin-kv, `--node
tpu:compartment`.

Counterpart of `maelstrom_tpu/nodes/compartment.py` with one sequencer
(`--roles sequencers=1`, the default), held against it by
`tests/test_torch_compartment.py`. "Scaling Replicated State Machines
with Compartmentalization" (arxiv 2012.15762) splits MultiPaxos' leader
into tiers that scale on their own, four roles over contiguous node-id
ranges of one `sim.RolePartition`:

    node 0                  the sequencer (leads at ballot 0, durable)
    nodes [1, 1+P)          proxies   (VOLATILE: a kill wipes them; the
                                       leader's resends rebuild them)
    nodes [1+P, 1+P+A)      acceptors (a rows x cols grid, durable)
    nodes [1+P+A, N)        replicas  (apply the log, durable)

selected with `--roles proxies=P,acceptors=RxC,replicas=R`:

  1. clients send read / write / cas to the sequencer (reads take a slot
     too, so every op linearizes at its apply point);
  2. the sequencer assigns the next slot, parks the command in its
     durable in-flight table and sends T_ASSIGN to proxy `slot % P`,
     again on every retry tick until T_DONE: the retry root that makes
     a volatile proxy safe. A full table or log sheds the command with
     error 11, a definite fail;
  3. the proxy sends T_P2A to every acceptor and folds the T_P2B acks
     by grid index; any complete grid ROW is a write quorum;
  4. the chosen command goes to every replica (T_LEARN) until each acks
     T_EXEC, and the proxy reports T_DONE to the sequencer;
  5. replicas store each learned command at its slot, ack it at once,
     apply the log strictly in slot order (AP = K slots a round) over
     their key rows, and the designated replica (`slot % R`) answers
     the client with the value at the apply point.

Each role's `step` has a hand-written CUDA kernel in
`csrc/compartment.cu` (K23 `compartment_sequencer_step`, K24
`compartment_proxy_step`, K25 `compartment_acceptor_step`, K26
`compartment_replica_step`) and its plain PyTorch version `step_plain`.
Killed and paused nodes (`ctx["stall"]`) keep their state and send
nothing: the kernels apply the freeze, the plain versions go through
`freeze_step`.

Elections and failover (`sequencers > 1`: ballots, phase 1 over grid
columns, recovery) and the proxies' byzantine conviction lanes are not
ported: the constructor refuses them, naming what brings each."""

from __future__ import annotations

import torch

from .. import kernels as K
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
T_ASSIGN = 30    # leader -> proxy:    a = client<<16 | slot, b = cmd, c = mid
T_P2A = 31       # proxy -> acceptor:  a = slot, b = cmd, c = ballot (0)
T_P2B = 32       # acceptor -> proxy:  a = slot, b = acceptor grid index
T_LEARN = 33     # proxy -> replica:   a = client<<16 | slot, b = cmd, c = mid
T_EXEC = 34      # replica -> proxy:   a = slot, b = replica index
T_DONE = 35      # proxy -> leader:    a = slot

# protocol error codes on the client surface
E_UNAVAILABLE = 11   # leader table full: definite backpressure shed
E_NOT_LEADER = 31    # contacted sequencer does not lead; b = hint or -1
E_BYZANTINE = 32     # receiver convicted the message of lying

_DEFAULT_ROLES = {"sequencers": 1, "proxies": 2, "rows": 2, "cols": 2,
                  "replicas": 2}
DEFAULT_ROLES = "sequencers=1,proxies=2,acceptors=2x2,replicas=2"

# what brings the options this module refuses
ELECTION = "the compartment election and failover"
BYZANTINE = "the byzantine adversary"

# the inbox fields the kernels read, in their argument order
_IN_FIELDS = ("valid", "src", "mid", "type", "a", "b", "c")
# the kernels' block of threads is at most 1,024, a table row or an inbox
# lane a thread; K26 keeps a replica's key row in shared memory
MAX_ROWS = 1024
MAX_KV_KEYS = 4095


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


# the sequencer's and the proxy's table leaves, in the kernels' order
SEQ_KEYS = ("t_valid", "t_slot", "t_cmd", "t_client", "t_mid", "t_last")
PROXY_KEYS = ("p_valid", "p_learn", "p_slot", "p_cmd", "p_client", "p_mid",
              "p_last", "p_acks")
REPLICA_KEYS = ("r_cmd", "r_client", "r_mid", "r_has")


class SequencerRole(NodeProgram):
    """The sequencer: slot assignment plus the durable in-flight table,
    the retry root that makes the volatile proxies safe. With one
    sequencer there are no ballots and no elections."""

    name = "compartment-sequencer"
    durable_keys = None          # sequencer state fsyncs before acting

    def __init__(self, opts, nodes, lay: Layout, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.lay = lay
        self.inbox_cap = lay.K
        self.outbox_cap = lay.QL + lay.K

    def init_state(self):
        n, Q, dev = self.n_nodes, self.lay.QL, self.device

        def z(*s):
            return torch.zeros(s, dtype=I32, device=dev)
        return {"next_slot": z(n),
                "t_valid": torch.zeros((n, Q), dtype=torch.bool,
                                       device=dev),
                "t_slot": z(n, Q), "t_cmd": z(n, Q),
                "t_client": z(n, Q), "t_mid": z(n, Q),
                "t_last": torch.full((n, Q), -(1 << 20), dtype=I32,
                                     device=dev)}

    def quiet_planes(self, state):
        return [state["t_valid"]]

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
        op_of = torch.where(t == T_WRITE, OP_WRITE,
                            torch.where(t == T_CAS, OP_CAS, OP_READ)).to(I32)
        keyk = inbox.a.clamp(0, lay.keys - 1)
        wc = (t == T_WRITE) | (t == T_CAS)
        v1 = torch.where(wc, inbox.b + 1, 0).clamp(0, 0xFF).to(I32)
        v2 = torch.where(t == T_CAS, inbox.c + 1, 0).clamp(0, 0xFF).to(I32)
        cmd = _pack_cmd(keyk, op_of, v1, v2)
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

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [n, K], ctx) -> (state', outbox Msgs [n,
        QL + K]); ctx["round"] the i32 round, ctx.get("stall") the [n]
        bool mask of stalled nodes."""
        stall, rnd = ctx.get("stall"), ctx["round"]
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


class ProxyRole(NodeProgram):
    """The stateless fan-out tier: phase-2a to the acceptor grid,
    row-quorum collection, then learn until every replica acks.
    VOLATILE (`durable_keys = ()`): a kill wipes the table and the
    leader's resends rebuild it."""

    name = "compartment-proxy"
    durable_keys = ()            # stateless tier: nothing survives

    def __init__(self, opts, nodes, lay: Layout, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.lay = lay
        self.inbox_cap = lay.K
        self.outbox_cap = lay.QP * lay.AR + lay.QP

    def init_state(self):
        n, Q, AR, dev = self.n_nodes, self.lay.QP, self.lay.AR, self.device

        def z(*s):
            return torch.zeros(s, dtype=I32, device=dev)
        return {"p_valid": torch.zeros((n, Q), dtype=torch.bool, device=dev),
                "p_learn": torch.zeros((n, Q), dtype=torch.bool, device=dev),
                "p_slot": z(n, Q), "p_cmd": z(n, Q),
                "p_client": z(n, Q), "p_mid": z(n, Q),
                "p_last": torch.full((n, Q), -(1 << 20), dtype=I32,
                                     device=dev),
                "p_acks": torch.zeros((n, Q, AR), dtype=torch.bool,
                                      device=dev)}

    def quiet_planes(self, state):
        return [state["p_valid"]]

    def step_plain(self, state, inbox, rnd):
        lay = self.lay
        n, K_ = inbox.valid.shape
        Q, AR, dev = lay.QP, lay.AR, inbox.valid.device
        s = dict(state)
        v, t = inbox.valid, inbox.type
        idx_ar = torch.arange(AR, dtype=I32, device=dev)
        onehot = inbox.b[:, :, None] == idx_ar[None, None, :]   # [n, K, AR]

        # acceptor acks onto phase-2 rows, replica acks onto learn rows
        p2b = _match_rows(s["p_valid"] & ~s["p_learn"], s["p_slot"],
                          v & (t == T_P2B), inbox.a)
        ex = _match_rows(s["p_valid"] & s["p_learn"], s["p_slot"],
                         v & (t == T_EXEC), inbox.a)
        s["p_acks"] = s["p_acks"] | (
            (p2b | ex)[:, :, :, None] & onehot[:, None]).any(dim=2)

        # every replica acked: retire the row, T_DONE to the leader
        done = (s["p_valid"] & s["p_learn"]
                & s["p_acks"][:, :, :lay.R].all(dim=2))
        done_out = _out((n, Q), dev, valid=done, dest=lay.leader,
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

        # new assignments (slot-keyed dedup; a slot with a live row and a
        # full table drop, the leader's retry tick re-delivers)
        _b, client_in, slot_in = lay.unpack_assign_a(inbox.a)
        asg = _first_per_key(v & (t == T_ASSIGN), slot_in)
        hit = _match_rows(s["p_valid"], s["p_slot"], asg, slot_in)
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
        lane_c = torch.where(learn, s["p_mid"][:, :, None], 0)

        def flat(x):
            return x.expand(n, Q, AR).reshape(n, Q * AR)
        fan_out = _out((n, Q * AR), dev, valid=flat(lane_valid),
                       dest=flat(lane_dest), type=flat(lane_type),
                       a=flat(lane_a), b=flat(lane_b), c=flat(lane_c))
        return s, cat_lanes(fan_out, done_out)

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [n, K], ctx) -> (state', outbox Msgs [n,
        QP * AR + QP])."""
        stall, rnd = ctx.get("stall"), ctx["round"]
        if not K.use_kernel(inbox.valid):
            return freeze_step(stall, state,
                               *self.step_plain(state, inbox, rnd))
        lay, n, kern = self.lay, self.n_nodes, K.COMPARTMENT_PROXY_STEP
        K_ = _check_inbox(kern, inbox, n)
        Q, AR = lay.QP, lay.AR
        _check_state(kern, state, {
            "p_valid": (torch.bool, (n, Q)), "p_learn": (torch.bool, (n, Q)),
            **{k: (I32, (n, Q)) for k in PROXY_KEYS[2:7]},
            "p_acks": (torch.bool, (n, Q, AR))})
        if max(Q, K_) > MAX_ROWS or Q * AR > 32768:
            raise ValueError(f"{kern.name}: proxy_slots {Q}, inbox {K_}, "
                             f"{AR} acks a row")
        dev = inbox.valid.device
        out = _new_msgs((n, Q * AR + Q), dev)
        new = {k: torch.empty_like(state[k]) for k in PROXY_KEYS}
        kern.launch(
            _in_ptrs(inbox) + [state[k].contiguous() for k in PROXY_KEYS]
            + [_check_round(kern, rnd), _check_stall(kern, stall, n)]
            + _out_ptrs(out) + [new[k] for k in PROXY_KEYS],
            [n, K_, Q, AR, lay.A, lay.R, lay.rows, lay.cols, lay.leader,
             lay.a_base, lay.r_base, lay.retry], dev)
        return new, out


class AcceptorRole(NodeProgram):
    """One grid cell: stores the command proposed for each slot and acks
    with its grid index so proxies can assemble row quorums. Durable:
    accepted state fsyncs before the ack leaves."""

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
        return {"acc_cmd": torch.zeros((n, C), dtype=I32, device=dev),
                "acc_has": torch.zeros((n, C), dtype=torch.bool,
                                       device=dev)}

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

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [n, K], ctx) -> (state', outbox Msgs [n,
        K])."""
        stall = ctx.get("stall")
        if not K.use_kernel(inbox.valid):
            return freeze_step(stall, state, *self.step_plain(state, inbox))
        n, C, kern = self.n_nodes, self.lay.cap, K.COMPARTMENT_ACCEPTOR_STEP
        K_ = _check_inbox(kern, inbox, n)
        _check_state(kern, state, {"acc_cmd": (I32, (n, C)),
                                   "acc_has": (torch.bool, (n, C))})
        if K_ > MAX_ROWS:
            raise ValueError(f"{kern.name}: inbox {K_} > {MAX_ROWS}")
        dev = inbox.valid.device
        out = _new_msgs((n, K_), dev)
        cmd, has = state["acc_cmd"].contiguous(), state["acc_has"].contiguous()
        new = {"acc_cmd": torch.empty_like(cmd),
               "acc_has": torch.empty_like(has)}
        vec = C % 16 == 0 and _aligned16(cmd, has, *new.values())
        kern.launch(
            _in_ptrs(inbox) + [cmd, has, _check_stall(kern, stall, n)]
            + _out_ptrs(out) + [new["acc_cmd"], new["acc_has"]],
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
        kern.launch(
            _in_ptrs(inbox) + old + [_check_stall(kern, stall, n)]
            + _out_ptrs(out) + [new[k] for k in names],
            [n, K_, C, keys, lay.AP, lay.R, lay.n_nodes, int(vec)], dev)
        return new, out


def _byz_requested(opts) -> bool:
    """Whether the run's fault set includes the byzantine adversary."""
    pkg = opts.get("nemesis_pkg") or {}
    faults = pkg.get("faults")
    if faults is None:
        faults = opts.get("nemesis")
    if not faults:
        return False
    if isinstance(faults, str):
        faults = faults.split(",")
    return "byzantine" in set(faults)


def checked_layout(opts, n_nodes) -> Layout:
    """The cluster's `Layout`, or ValueError: the JAX layout's own
    refusals first, word for word, then what this port does not run (an
    elected sequencer tier, the byzantine adversary), naming what brings
    each. `core.build_test` calls it before any store dir is made."""
    lay = Layout(opts, n_nodes)
    if lay.S > 1:
        raise ValueError(
            f"--roles sequencers={lay.S}: an elected sequencer tier is not "
            f"ported to maelstrom_tpu_torch yet; it comes with {ELECTION}")
    if _byz_requested(opts):
        raise ValueError(
            "--nemesis byzantine on tpu:compartment is not ported to "
            f"maelstrom_tpu_torch yet; it comes with {BYZANTINE}")
    return lay


@register
class CompartmentProgram(LinKVWire, RolePartition):
    """`--node tpu:compartment`: the role-partitioned compartmentalized
    consensus cluster with one sequencer (see the module docstring).
    Serves lin-kv through the shared wire vocabulary; every client op
    goes to the sequencer, node 0."""

    name = "compartment"

    def __init__(self, opts, nodes, device="cuda"):
        lay = checked_layout(opts, len(nodes))
        self.lay = lay
        # the host's leader guess: where new client ops are routed (the
        # ballot-0 leader; redirects come only from an elected tier)
        self._leader_guess = lay.leader
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
        return self._leader_guess

    # --- leader-redirect client routing (runner hooks) ------------------

    def decode_body(self, t, a, b, c, intern):
        if t == T_ERR and a == E_NOT_LEADER:
            return {"type": "error", "code": E_NOT_LEADER,
                    "text": "not leader", "hint": int(b)}
        if t == T_ERR and a == E_BYZANTINE:
            return {"type": "error", "code": E_BYZANTINE,
                    "text": "byzantine", "slot": int(b), "bal": int(c)}
        return super().decode_body(t, a, b, c, intern)

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

    def note_timeout(self, node_idx: int):
        """An RPC to `node_idx` timed out: with one sequencer the guess
        stays on it."""
        if self.lay.S > 1 and int(node_idx) == self._leader_guess:
            self._leader_guess = (self._leader_guess + 1) % self.lay.S

    # --- dynamic nemesis targeting ----------------------------------------

    def dynamic_fault_groups(self):
        """`--nemesis-targets kill=sequencer` resolves at invoke time to
        the live leader (with one sequencer, always node 0)."""
        return ("sequencer",)

    def current_leader_host(self, nodes_host) -> int:
        return self.lay.leader

    def election_report(self, nodes_host):
        """No elections with a stable sequencer."""
        return None
