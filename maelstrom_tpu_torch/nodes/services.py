"""The reference's built-in service nodes as role-partitioned in-cluster
programs: `--node tpu:services`.

Counterpart of `maelstrom_tpu/nodes/services.py`, held against it by
`tests/test_torch_services.py`. One `RolePartition` with

    node 0                 lin-tso   (linearizable timestamp oracle)
    node 1                 seq-kv    (single-copy KV)
    nodes [2, 2+n)         lww-kv    (n last-write-wins replicas with
                                      Lamport clocks, converging by
                                      per-key dirty-set gossip)

selected with `--service-roles lin-tso=1,seq-kv=1,lww-kv=3` (the default
5-node layout). The `lin-tso` workload drives the TSO tier end to end
(`-w lin-tso --node tpu:services`, graded by `checkers/tso.py`); the KV
tiers serve the lin-kv wire codes for in-cluster callers.

Each role's `step` has a hand-written CUDA kernel in `csrc/services.cu`
(K20 `tso_step`, K21 `seq_kv_step`, K22 `lww_kv_step`) and its plain
PyTorch version `step_plain`. Killed and paused nodes (`ctx["stall"]`)
keep their state and send nothing: the kernels apply the freeze, the
plain versions go through `freeze_step`."""

from __future__ import annotations

import torch

from .. import kernels as K
from ..net.tpu import I32, Msgs, cat_lanes
from ..sim import RolePartition
from ..tree import resolve_device
from . import NodeProgram, freeze_step, register
from .raft import T_CAS, T_READ, T_WRITE

T_ERR = 1
T_READ_OK = 11
T_WRITE_OK = 13
T_CAS_OK = 15
T_TS = 40        # -> lin-tso
T_TS_OK = 41     # a = timestamp
T_MERGE = 45     # lww gossip: a = key, b = write ts, c = value+1

DEFAULT_SERVICE_ROLES = "lin-tso=1,seq-kv=1,lww-kv=3"
_SERVICE_NAMES = ("lin-tso", "seq-kv", "lww-kv")

# the KV kernels keep a node's key row in shared memory
MAX_KV_KEYS = 4096

_MSG_FIELDS = ("valid", "src", "dest", "due", "mid", "reply_to", "type",
               "a", "b", "c")
# the wire codes the KV kernels read, in their argument order
_KV_CODES = (T_READ, T_WRITE, T_CAS, T_MERGE, T_READ_OK, T_WRITE_OK,
             T_CAS_OK, T_ERR)


def parse_service_roles(spec) -> dict:
    spec = spec or DEFAULT_SERVICE_ROLES
    out: dict = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        k, sep, val = part.partition("=")
        k = k.strip()
        if k not in _SERVICE_NAMES:
            raise ValueError(f"--service-roles: unknown service {k!r} "
                             f"(expected {list(_SERVICE_NAMES)})")
        n = int(val) if sep else 1
        if n < 1:
            raise ValueError(f"--service-roles: {k} must be >= 1")
        out[k] = n
    for name in _SERVICE_NAMES:
        out.setdefault(name, 0)
    if out["lin-tso"] != 1 or out["seq-kv"] > 1:
        raise ValueError(
            "--service-roles: lin-tso and seq-kv are single-copy "
            "services (exactly one lin-tso, at most one seq-kv)")
    return out


def roles_node_count(spec) -> int:
    r = parse_service_roles(spec)
    return r["lin-tso"] + r["seq-kv"] + r["lww-kv"]


def _plus1_byte(x):
    """clip(x + 1, 0, 0xFF) after an int32 add that wraps, as JAX's and
    torch's do: INT32_MAX + 1 is negative and clips to 0."""
    return (x + 1).clamp(0, 0xFF)


def _kv_reply(t, cur, cas_ok):
    """The lin-kv reply encoding of the KV tiers: (rtype, ra) per the
    raft conventions. READ_OK carries value+1, absent keys error 20, a
    failed cas 22 (or 20 when absent)."""
    rtype = torch.where(
        t == T_READ, torch.where(cur > 0, T_READ_OK, T_ERR),
        torch.where(t == T_WRITE, T_WRITE_OK,
                    torch.where(cas_ok, T_CAS_OK, T_ERR))).to(I32)
    ra = torch.where(
        t == T_READ, torch.where(cur > 0, cur, 20),
        torch.where((t == T_CAS) & ~cas_ok,
                    torch.where(cur > 0, 22, 20), 0)).to(I32)
    return rtype, ra


def _reply_lanes(inbox, req, rtype, ra) -> Msgs:
    """The [n, K] reply outbox of the KV tiers: a reply to each request
    lane (dest = src, reply_to = mid), every other field as `Msgs.empty`
    makes it."""
    return Msgs.empty(tuple(req.shape), req.device).replace(
        valid=req, dest=inbox.src, type=rtype, a=ra, reply_to=inbox.mid)


def _check_inbox(kernel, inbox, n):
    K_ = inbox.valid.shape[1]
    for f in _MSG_FIELDS:
        t = getattr(inbox, f)
        if tuple(t.shape) != (n, K_) or t.dtype != (
                torch.bool if f == "valid" else I32):
            raise ValueError(f"{kernel.name} inbox.{f}: {tuple(t.shape)} "
                             f"{t.dtype}")
    return K_


def _check_stall(kernel, stall, n):
    if stall is not None and (tuple(stall.shape) != (n,)
                              or stall.dtype != torch.bool):
        raise ValueError(f"{kernel.name} stall: {tuple(stall.shape)} "
                         f"{stall.dtype}")
    return None if stall is None else stall.contiguous()


def _new_msgs(shape, dev) -> Msgs:
    return Msgs(valid=torch.empty(shape, dtype=torch.bool, device=dev),
                **{f: torch.empty(shape, dtype=I32, device=dev)
                   for f in _MSG_FIELDS[1:]})


class TSORole(NodeProgram):
    """`PersistentTSO` on the device: a strictly monotonic timestamp
    oracle (a reply carries the pre-increment value). Requests landing in
    one round are linearized by inbox lane order."""

    name = "lin-tso"

    def __init__(self, opts, nodes, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.inbox_cap = int(opts.get("service_inbox", 8))
        self.outbox_cap = self.inbox_cap

    def init_state(self):
        return {"ts": torch.zeros(self.n_nodes, dtype=I32,
                                  device=self.device)}

    def quiet_planes(self, state):
        return []

    def step_plain(self, state, inbox):
        req = inbox.valid & (inbox.type == T_TS)
        r = req.to(I32)
        rank = torch.cumsum(r, dim=1, dtype=I32) - r
        ts = state["ts"]
        out = inbox.replace(
            valid=req, dest=inbox.src, reply_to=inbox.mid,
            type=torch.full_like(inbox.type, T_TS_OK), a=ts[:, None] + rank,
            b=torch.zeros_like(inbox.b), c=torch.zeros_like(inbox.c))
        return {"ts": ts + r.sum(dim=1, dtype=I32)}, out

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [n, K], ctx) -> (state', outbox Msgs [n,
        K]); ctx.get("stall") the [n] bool mask of stalled nodes."""
        stall = ctx.get("stall")
        if not K.use_kernel(inbox.valid):
            return freeze_step(stall, state, *self.step_plain(state, inbox))
        n = self.n_nodes
        K_ = _check_inbox(K.TSO_STEP, inbox, n)
        ts = state["ts"]
        if tuple(ts.shape) != (n,) or ts.dtype != I32:
            raise ValueError(f"tso_step ts: {tuple(ts.shape)} {ts.dtype}")
        dev = inbox.valid.device
        new = _new_msgs((n, K_), dev)
        # dest = src, reply_to = mid and the passed-through fields are the
        # inbox's own tensors, as in the plain version
        out = inbox.replace(valid=new.valid, dest=inbox.src,
                            reply_to=inbox.mid, type=new.type, a=new.a,
                            b=new.b, c=new.c)
        ts2 = torch.empty_like(ts)
        K.TSO_STEP.launch(
            [inbox.valid.contiguous(), inbox.type.contiguous(),
             ts.contiguous(), _check_stall(K.TSO_STEP, stall, n),
             out.valid, out.type, out.a, out.b, out.c, ts2],
            [n, K_, T_TS, T_TS_OK], dev)
        return {"ts": ts2}, out


class SeqKVRole(NodeProgram):
    """`PersistentKV` on the device, single copy: read, write and cas
    applied in arrival order (linearizable, hence sequentially
    consistent). Values are small ints stored as value+1 (0 = absent),
    the lin-kv wire convention."""

    name = "seq-kv"

    def __init__(self, opts, nodes, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.keys = int(opts.get("kv_keys", 256))
        self.inbox_cap = int(opts.get("service_inbox", 8))
        self.outbox_cap = self.inbox_cap

    def init_state(self):
        return {"kv": torch.zeros((self.n_nodes, self.keys), dtype=I32,
                                  device=self.device)}

    def quiet_planes(self, state):
        return []

    def step_plain(self, state, inbox):
        n, K_ = inbox.valid.shape
        t, b = inbox.type, inbox.b
        keys = inbox.a.clamp(0, self.keys - 1).long()
        req = inbox.valid & ((t == T_READ) | (t == T_WRITE) | (t == T_CAS))
        is_cas = t == T_CAS
        frm = _plus1_byte(b)
        new_v = torch.where(t == T_WRITE, frm, _plus1_byte(inbox.c))
        do_write = req & (t == T_WRITE)
        kv = state["kv"].clone()
        curs, oks = [], []
        # lanes apply strictly in order: a cas may read the key the lane
        # before it wrote
        for k in range(K_):
            key = keys[:, k:k + 1]
            cur = kv.gather(1, key)[:, 0]
            ok = is_cas[:, k] & (cur > 0) & (cur == frm[:, k])
            # one key a row: a row that writes nothing writes its key back
            do = do_write[:, k] | (req[:, k] & ok)
            kv.scatter_(1, key, torch.where(do, new_v[:, k], cur)[:, None])
            curs.append(cur)
            oks.append(ok)
        rtype, ra = _kv_reply(t, torch.stack(curs, 1), torch.stack(oks, 1))
        return {"kv": kv}, _reply_lanes(inbox, req, rtype, ra)

    def step(self, state, inbox, ctx):
        stall = ctx.get("stall")
        if not K.use_kernel(inbox.valid):
            return freeze_step(stall, state, *self.step_plain(state, inbox))
        n = self.n_nodes
        K_ = _check_inbox(K.SEQ_KV_STEP, inbox, n)
        kv = state["kv"]
        if tuple(kv.shape) != (n, self.keys) or kv.dtype != I32 \
                or self.keys > MAX_KV_KEYS:
            raise ValueError(f"seq_kv_step kv: {tuple(kv.shape)} "
                             f"{kv.dtype} (keys <= {MAX_KV_KEYS})")
        dev = inbox.valid.device
        out = _new_msgs((n, K_), dev)
        kv2 = torch.empty_like(kv)
        K.SEQ_KV_STEP.launch(
            [getattr(inbox, f).contiguous() for f in _MSG_FIELDS]
            + [kv.contiguous(), _check_stall(K.SEQ_KV_STEP, stall, n)]
            + [getattr(out, f) for f in _MSG_FIELDS] + [kv2],
            # the KV kernels' one int layout: no gossip lanes, no base
            [n, K_, self.keys, 0, 0, *_KV_CODES], dev)
        return {"kv": kv2}, out


class LWWKVRole(NodeProgram):
    """`LWWKV` on the device: n replicas, Lamport write timestamps,
    per-key last-write-wins merge (ties keep ours), converging by
    dirty-set gossip: each round every replica ships up to `gossip_keys`
    dirty (key, ts, value) triples to its ring successor, and adoption
    marks the key dirty at the receiver, so an update travels the whole
    ring and the dirty sets drain (the quiescence signal)."""

    name = "lww-kv"

    def __init__(self, opts, nodes, base: int = 0, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)
        self.base = base
        self.keys = int(opts.get("kv_keys", 256))
        self.G = int(opts.get("gossip_keys", 8))
        self.inbox_cap = int(opts.get("service_inbox", 8))
        self.outbox_cap = self.inbox_cap + self.G
        # no gossip for a single replica (nobody to converge with)
        self.gossip = self.G if self.n_nodes > 1 and self.G > 0 else 0

    def init_state(self):
        n, dev = self.n_nodes, self.device
        return {"kv": torch.zeros((n, self.keys), dtype=I32, device=dev),
                "vts": torch.full((n, self.keys), -1, dtype=I32,
                                  device=dev),
                "clock": torch.zeros(n, dtype=I32, device=dev),
                "dirty": torch.zeros((n, self.keys), dtype=torch.bool,
                                     device=dev)}

    def quiet_planes(self, state):
        return [] if self.n_nodes <= 1 else [state["dirty"]]

    def step_plain(self, state, inbox):
        n, K_ = inbox.valid.shape
        keys, dev = self.keys, inbox.valid.device
        valid, t, b, c = inbox.valid, inbox.type, inbox.b, inbox.c
        key_all = inbox.a.clamp(0, keys - 1).long()
        # gossip merge: adopt strictly newer stamps (ties keep ours)
        mg = valid & (t == T_MERGE)
        merge_clock = torch.where(mg, b + 1, 0)
        valid_cas = valid & (t == T_CAS)
        valid_write = valid & (t == T_WRITE)
        frm = _plus1_byte(b)
        write_v = torch.where(t == T_WRITE, frm, _plus1_byte(c))
        req = valid & ((t == T_READ) | (t == T_WRITE) | (t == T_CAS))
        kv, vts = state["kv"].clone(), state["vts"].clone()
        dirty, clock = state["dirty"].clone(), state["clock"]
        curs, oks = [], []
        for k in range(K_):
            key = key_all[:, k:k + 1]
            cur, kts = kv.gather(1, key)[:, 0], vts.gather(1, key)[:, 0]
            adopt = mg[:, k] & (b[:, k] > kts)
            ok = valid_cas[:, k] & (cur > 0) & (cur == frm[:, k])
            wr = valid_write[:, k] | ok
            # one key a row: a row that writes nothing writes its key
            # back; the stamp takes the clock before this lane moves it
            do = adopt | wr
            kv.scatter_(1, key, torch.where(
                do, torch.where(adopt, c[:, k], write_v[:, k]), cur)[:, None])
            vts.scatter_(1, key, torch.where(
                do, torch.where(adopt, b[:, k], clock), kts)[:, None])
            dirty.scatter_(1, key, (do | dirty.gather(1, key)[:, 0])[:, None])
            clock = torch.where(wr, clock + 1,
                                torch.maximum(clock, merge_clock[:, k]))
            curs.append(cur)
            oks.append(ok)
        rtype, ra = _kv_reply(t, torch.stack(curs, 1), torch.stack(oks, 1))
        out = _reply_lanes(inbox, req, rtype, ra)
        G = self.gossip
        if G:
            # the first G dirty keys of each replica, by prefix count, to
            # the ring successor; the rest stay dirty
            rank = torch.cumsum(dirty.to(torch.int64), dim=1) - 1
            sel = dirty & (rank < G)
            r_idx, k_idx = torch.nonzero(sel, as_tuple=True)
            lane = rank[r_idx, k_idx]

            def pick(src, fill):
                buf = torch.full((n, G), fill, dtype=src.dtype, device=dev)
                buf[r_idx, lane] = src[r_idx, k_idx]
                return buf
            key_ar = torch.arange(keys, dtype=I32, device=dev).expand(n, keys)
            dirty = dirty & ~sel
            me = torch.arange(n, dtype=I32, device=dev)
            succ = self.base + (me + 1) % n
            gossip = Msgs.empty((n, G), dev).replace(
                valid=pick(sel, False),
                dest=succ[:, None].expand(n, G).contiguous(),
                type=torch.full((n, G), T_MERGE, dtype=I32, device=dev),
                a=pick(key_ar, 0), b=pick(vts, 0), c=pick(kv, 0))
            out = cat_lanes(out, gossip)
        return {"kv": kv, "vts": vts, "clock": clock, "dirty": dirty}, out

    def step(self, state, inbox, ctx):
        stall = ctx.get("stall")
        if not K.use_kernel(inbox.valid):
            return freeze_step(stall, state, *self.step_plain(state, inbox))
        n, keys = self.n_nodes, self.keys
        K_ = _check_inbox(K.LWW_KV_STEP, inbox, n)
        for name, dt, shape in (("kv", I32, (n, keys)),
                                ("vts", I32, (n, keys)),
                                ("dirty", torch.bool, (n, keys)),
                                ("clock", I32, (n,))):
            t = state[name]
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"lww_kv_step {name}: {tuple(t.shape)} "
                                 f"{t.dtype}")
        if keys > MAX_KV_KEYS:
            raise ValueError(f"lww_kv_step: keys {keys} > {MAX_KV_KEYS}")
        dev = inbox.valid.device
        out = _new_msgs((n, K_ + self.gossip), dev)
        new = {k: torch.empty_like(state[k])
               for k in ("kv", "vts", "clock", "dirty")}
        K.LWW_KV_STEP.launch(
            [getattr(inbox, f).contiguous() for f in _MSG_FIELDS]
            + [state[k].contiguous() for k in ("kv", "vts", "dirty",
                                               "clock")]
            + [_check_stall(K.LWW_KV_STEP, stall, n)]
            + [getattr(out, f) for f in _MSG_FIELDS]
            + [new[k] for k in ("kv", "vts", "dirty", "clock")],
            [n, K_, keys, self.gossip, self.base, *_KV_CODES], dev)
        return new, out


@register
class ServicesProgram(RolePartition):
    """`--node tpu:services`: the built-in service nodes as one
    role-partitioned cluster (see the module docstring). The client role
    is lin-tso, the `lin-tso` workload's surface."""

    name = "services"

    def __init__(self, opts, nodes, device="cuda"):
        r = parse_service_roles(opts.get("service_roles"))
        roles = []
        base = 0
        for name, cls in (("lin-tso", TSORole), ("seq-kv", SeqKVRole),
                          ("lww-kv", LWWKVRole)):
            if not r[name]:
                continue
            kw = {"base": base} if cls is LWWKVRole else {}
            roles.append((name, cls(opts, nodes[base:base + r[name]],
                                    device=device, **kw)))
            base += r[name]
        RolePartition.__init__(self, opts, nodes, roles)

    # --- host boundary: the lin-tso RPC surface -------------------------

    def request_for_op(self, op):
        return {"type": "ts"}

    def node_for_op(self, op):
        return 0

    def encode_body(self, body, intern):
        assert body["type"] == "ts"
        return (T_TS, 0, 0, 0)

    def decode_body(self, t, a, b, c, intern):
        if t == T_TS_OK:
            return {"type": "ts_ok", "ts": int(a)}
        return NodeProgram.decode_body(self, t, a, b, c, intern)

    def completion(self, op, body, read_state, intern):
        return {**op, "type": "ok", "value": int(body["ts"])}
