"""The byzantine adversary: seeded wire corruption that the checkers must
convict.

Counterpart of `maelstrom_tpu/byzantine.py`, held against it by
`tests/test_torch_byzantine.py`. Every other nemesis package is benign:
nodes stop or delay, they never lie. The ``byzantine`` package rewrites
message contents inside the round, on the two audit surfaces the
programs carry:

  - ``equivocation``: a compromised sequencer of the compartment assigns
    one slot different commands on different emissions (the rewrite
    varies by round, so any two deliveries of one slot and ballot
    conflict);
  - ``forged-proof``: a batched-broadcast node acks a `(lo, n, checksum)`
    range it never expanded (the count inflated on odd rounds, the
    checksum forged on even ones);
  - ``stale-ballot``: a sequencer's T_ASSIGN traffic is re-stamped with a
    ballot outside its residue class (ballots are `k * S + me`, so an
    honest ballot satisfies `bal % S == src`).

A byzantine run is valid only if every attack kind that injected at
least once is convicted (a `(rule, culprit, evidence)` triple in the
``byzantine`` results block), and no conviction names an attack that
injected nothing (`assemble_block`).

The attack plan (kind, culprit, nonce) comes from the ``byzantine``
decision stream of `nemesis.NemesisDecisions`; the per-round gate is a
pure integer hash of (round, nonce), so the adversary consumes no PRNG
state and the benign decision streams stay as they are. The carry
(`init_state`) rides `SimState.byz` only when the run's fault set holds
``byzantine``: benign runs carry None and launch nothing of this module.

The round rewrites the culprit's outbox rows through `corrupt_pool`
(the pool path; the compartment's T_ASSIGN lanes) and `corrupt_edge`
(the edge path's client-reply batch; the batched program's T_BATCH_OK
acks). Each takes its plain PyTorch version for tensors on the CPU and
launches its hand-written kernel on CUDA tensors (K30
`byz_corrupt_pool`, K31 `byz_corrupt_edge`, `csrc/byzantine.cu`), or
raises. A program names its surface with `byz_wire()` / `byz_wire_edge()`
(a `PoolWire` / `EdgeWire`); the rewrite formulas live here, one copy
for the plain versions, mirrored by the kernels."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import kernels as K
from .errors import BYZANTINE
from .net.tpu import I32, Msgs

# attack kinds, in the decision stream's draw order; the index is the
# carry's `attack` code and the slot of the `injected` ledger
ATTACKS = ("equivocation", "forged-proof", "stale-ballot")
EQUIVOCATION, FORGED_PROOF, STALE_BALLOT = range(3)

# conviction rule -> the attack kind it convicts. The proof auditor's
# rules are finer than attack kinds, so the validity fold maps each rule
# back to the attack whose injection it proves.
RULE_ATTACK = {
    "equivocation": "equivocation",
    "stale-ballot": "stale-ballot",
    "forged-proof": "forged-proof",
    "forged-count": "forged-proof",
    "truncated-batch": "forged-proof",
    "malformed-ack": "forged-proof",
    "duplicate-in-batch": "forged-proof",
    "replayed-batch": "forged-proof",
}

# 2654435761 (Knuth's multiplicative hash) as a wrapped int32
HASH_MULT = -1640531535

# payload fields a forged-proof host corruption touches; the wire
# classifier calls a send/recv body diff confined to them a forgery
# (checkers/byzantine.py)
PROOF_FIELDS = ("lo", "n", "count", "proof", "batch_units")

# the carry's scalar leaves, in the kernels' argument order
SCALARS = ("active", "attack", "culprit", "delta", "rate_q")


def byz_enabled(opts) -> bool:
    """Whether the byzantine fault is in this run's fault set: the static
    gate for the programs' corruption surfaces and evidence state, so
    that benign runs build none of the adversary and their state trees
    stay as they are."""
    pkg = opts.get("nemesis_pkg") or {}
    faults = pkg.get("faults")
    if faults is None:
        faults = opts.get("nemesis")
    if not faults:
        return False
    if isinstance(faults, str):
        return faults == "byzantine"
    if isinstance(faults, (set, frozenset, list, tuple)):
        return "byzantine" in faults
    return False


# --- the device carry --------------------------------------------------------

def init_state(device) -> dict:
    """The zeroed adversary carry: int32 scalars and the [3] injection
    ledger, one slot per `ATTACKS` entry."""
    def full(v, shape=()):
        return torch.full(shape, v, dtype=I32, device=device)
    return {"active": full(0), "attack": full(0), "culprit": full(-1),
            "delta": full(1), "rate_q": full(0),
            "injected": full(0, (len(ATTACKS),))}


def start_state(byz: dict, attack: str, culprit: int, delta: int,
                rate: float) -> dict:
    """start-byzantine: a new carry with one drawn plan installed (new
    scalar tensors; the old carry is left as it was)."""
    dev = byz["injected"].device

    def full(v):
        return torch.full((), int(v), dtype=I32, device=dev)
    return {**byz, "active": full(1), "attack": full(ATTACKS.index(attack)),
            "culprit": full(culprit), "delta": full(delta),
            "rate_q": full(round(float(rate) * 1000))}


def stop_state(byz: dict) -> dict:
    """stop-byzantine: injection off, the ledger kept (convictions are
    audited against the whole run)."""
    return {**byz, "active": torch.zeros(
        (), dtype=I32, device=byz["injected"].device)}


def gate_plain(byz: dict, rnd) -> torch.Tensor:
    """The per-round injection gate: active, and a pure integer hash of
    (round, nonce) under the rate threshold (permille). The int32 wrap of
    `rnd * HASH_MULT + delta` is taken in int64 and masked to its low 31
    bits, which the mask keeps equal."""
    h = (torch.as_tensor(rnd).long() * HASH_MULT
         + byz["delta"].long()) & 0x7FFFFFFF
    return (byz["active"] > 0) & (h % 1000 < byz["rate_q"])


def culprit_rows(n: int, culprit, device) -> torch.Tensor:
    """[n, 1] mask of the culprit's outbox row (the row index is the
    program's node index: on a role partition's concatenated outbox, the
    global one)."""
    return (torch.arange(n, dtype=I32, device=device) == culprit)[:, None]


# --- the corruption surfaces -----------------------------------------------

@dataclass(frozen=True)
class PoolWire:
    """A program's pool-path surface: the culprit's lanes of `msg_type`
    (the compartment's T_ASSIGN). Equivocation xors word b with a
    round-varying nonzero pattern over its value byte; with S > 1
    stale-ballot repacks word a's ballot as (culprit + 1) % S in the
    elected assign layout `bal << 24 | client << 12 | slot`. S == 1 has
    no ballot field, so only equivocation."""
    msg_type: int
    S: int = 1


@dataclass(frozen=True)
class EdgeWire:
    """A program's edge-path surface, over the client-reply batch: the
    culprit's lanes of `msg_type` (the batched program's T_BATCH_OK).
    Forged-proof inflates the count b by 1 + (delta & 3) on odd rounds
    and xors the checksum c with (delta & 0xFFFF) | 1 on even ones,
    leaving the honest `lo` so the record still pairs with its
    invoke."""
    msg_type: int


def _selected(byz, batch: Msgs, msg_type, rnd, attack: int):
    n = batch.valid.shape[0]
    rows = culprit_rows(n, byz["culprit"], batch.valid.device)
    return (rows & batch.valid & (batch.type == msg_type)
            & gate_plain(byz, rnd) & (byz["attack"] == attack))


def _book(byz, counts) -> dict:
    """The carry with `counts` ({attack index: bool mask}) added to its
    ledger, as a new tensor."""
    add = torch.stack([counts[i].sum(dtype=I32) if i in counts
                       else torch.zeros((), dtype=I32,
                                        device=byz["injected"].device)
                       for i in range(len(ATTACKS))])
    return {**byz, "injected": byz["injected"] + add}


def corrupt_pool_plain(wire: PoolWire, byz, outbox: Msgs, rnd):
    """K30's plain version: (byz', outbox') with the active attack's
    rewrite on the culprit's valid `wire.msg_type` lanes, when the gate
    is open, and the rewritten lanes booked in the ledger."""
    r = torch.as_tensor(rnd, dtype=I32, device=outbox.valid.device)
    eq = _selected(byz, outbox, wire.msg_type, r, EQUIVOCATION)
    x = (((r ^ byz["delta"]) & 0x3F) | 1) << 8
    out = outbox.replace(b=torch.where(eq, outbox.b ^ x, outbox.b))
    counts = {EQUIVOCATION: eq}
    if wire.S > 1:
        st = _selected(byz, outbox, wire.msg_type, r, STALE_BALLOT)
        bal = (byz["culprit"] + 1) % wire.S
        na = (bal << 24) | (((outbox.a >> 12) & 0xFFF) << 12) \
            | (outbox.a & 0xFFF)
        out = out.replace(a=torch.where(st, na, outbox.a))
        counts[STALE_BALLOT] = st
    return _book(byz, counts), out


def corrupt_edge_plain(wire: EdgeWire, byz, client_out: Msgs, rnd):
    """K31's plain version: (byz', client_out') with the forged-proof
    rewrite on the culprit's valid `wire.msg_type` lanes, when the gate
    is open, booked in the ledger."""
    r = torch.as_tensor(rnd, dtype=I32, device=client_out.valid.device)
    m = _selected(byz, client_out, wire.msg_type, r, FORGED_PROOF)
    odd = (r & 1) > 0
    d = byz["delta"]
    nb = torch.where(odd, client_out.b + 1 + (d & 3), client_out.b)
    nc = torch.where(odd, client_out.c, client_out.c ^ ((d & 0xFFFF) | 1))
    out = client_out.replace(b=torch.where(m, nb, client_out.b),
                             c=torch.where(m, nc, client_out.c))
    return _book(byz, {FORGED_PROOF: m}), out


def _launch(kern, byz, batch: Msgs, fields, rnd, ints):
    """Rewrites the culprit's row of `batch` in place (the `fields` it
    names) and returns the carry with a new `injected` tensor."""
    dev = batch.valid.device
    n, L = batch.valid.shape
    planes = [batch.valid, batch.type] + [getattr(batch, f) for f in fields]
    for p in planes:
        if p.shape != (n, L) or not p.is_contiguous():
            raise ValueError(f"{kern.name}: every outbox field must be a "
                             f"contiguous [{n}, {L}] plane")
    ptrs = {p.data_ptr() for p in planes}
    if len(ptrs) != len(planes):
        raise ValueError(f"{kern.name}: outbox fields share memory")
    scal = [byz[k] for k in SCALARS]
    for s in scal + [byz["injected"]]:
        if s.dtype != I32 or s.device != dev:
            raise ValueError(f"{kern.name}: the carry must be int32 on "
                             f"{dev}")
    r = torch.as_tensor(rnd)
    if r.numel() != 1 or r.dtype != I32 or r.device != dev:
        raise ValueError(f"{kern.name}: the round must be an i32 scalar "
                         f"tensor on {dev}")
    new = torch.empty(len(ATTACKS), dtype=I32, device=dev)
    kern.launch(planes + scal + [byz["injected"].contiguous(),
                                 r.reshape(1), new],
                [n, L] + ints, dev)
    return {**byz, "injected": new}


def corrupt_pool(program, byz, outbox: Msgs, rnd):
    """Applies this round's corruption to the pool-path [N, O] outbox, per
    the program's `byz_wire()` (a `PoolWire`, or None where the program
    has no surface in this run). A program without one injects nothing,
    and an attack that injects nothing demands no conviction.

    On CUDA tensors K30 rewrites the culprit's row in place: the outbox
    is this round's fresh output of the step (the kernel's contiguous
    planes, or a role partition's concatenation), read next by the
    flatten and send and never carried, so no other tensor sees the
    rewrite. The ledger is written to a new tensor: `injected` is carry,
    and the scan's rollback keeps the old one."""
    hook = getattr(program, "byz_wire", None)
    wire = hook() if (byz is not None and hook is not None) else None
    if wire is None:
        return byz, outbox
    if not K.use_kernel(outbox.valid):
        return corrupt_pool_plain(wire, byz, outbox, rnd)
    return _launch(K.BYZ_CORRUPT_POOL, byz, outbox, ("a", "b"), rnd,
                   [wire.msg_type, wire.S]), outbox


def corrupt_edge(program, byz, client_out: Msgs, rnd):
    """The edge path's counterpart over the [N, K] client-reply batch, per
    `byz_wire_edge()` (an `EdgeWire`). K31 rewrites the culprit's row in
    place, for the reasons `corrupt_pool` gives: the batch is the step's
    fresh output, read next by the flatten and compaction."""
    hook = getattr(program, "byz_wire_edge", None)
    wire = hook() if (byz is not None and hook is not None) else None
    if wire is None:
        return byz, client_out
    if not K.use_kernel(client_out.valid):
        return corrupt_edge_plain(wire, byz, client_out, rnd)
    return _launch(K.BYZ_CORRUPT_EDGE, byz, client_out, ("b", "c"), rnd,
                   [wire.msg_type]), client_out


# --- conviction assembly -----------------------------------------------------

def conviction(rule: str, culprit, evidence, witness=None) -> dict:
    """One conviction triple of the `byzantine` results block: the
    violated rule, the node it names, the evidence that proves it, and
    the definite Byzantine error code."""
    out = {"rule": rule, "culprit": culprit, "evidence": evidence,
           "code": int(BYZANTINE.code)}
    if witness is not None:
        out["witness"] = witness
    return out


def assemble_block(convictions: list, injected: dict) -> dict:
    """Folds the run's convictions against its injection ledger into the
    `byzantine` results block: valid iff every attack kind that injected
    at least once has a conviction whose rule maps to it (`RULE_ATTACK`),
    and no conviction names an attack that injected nothing (a spurious
    conviction fails the run as a missed one does)."""
    inj = {a: int(injected.get(a, 0)) for a in ATTACKS}
    convicted: set = set()
    spurious: list = []
    for c in convictions:
        atk = RULE_ATTACK.get(c.get("rule"))
        if atk is not None and inj.get(atk, 0) > 0:
            convicted.add(atk)
        else:
            spurious.append(c.get("rule"))
    unconvicted = sorted(a for a, k in inj.items()
                         if k > 0 and a not in convicted)
    return {"convictions": list(convictions), "injected": inj,
            "unconvicted": unconvicted, "spurious": spurious,
            "valid": not unconvicted and not spurious}
