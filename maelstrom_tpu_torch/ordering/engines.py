"""The ordering-engine adapters: `OrderedStream` over the port's raft and
batched-broadcast programs.

Copies of `StreamBoundary`, `OrderedRaft` and `OrderedBatched` from
`maelstrom_tpu/ordering/engines.py`. Each adapter subclasses the
engine's unchanged node program, so its device half is the program's
(raft: kernel K10; batched: kernel K15) and only the host boundary
changes (`StreamBoundary`): propose an opaque interned command id, learn
its stream position from the reply, replay the committed prefix
through the applier.

Engine-specific surface (per adapter):
  - `propose_words(cid)`: the wire words that carry a proposal;
  - `reply_slot(body)`: the op's stream position from a decoded reply
    (None: not a stream reply);
  - `ingest(slot, read_state, intern)`: extend the replay frontier
    through `slot`, from replica state (raft) or from the intern table
    (batched);
  - `check_capacity(n)`: the engine's command-id space bound.

The compartment engine (`OrderedCompartment`) runs on the role partition
(`sim.RolePartition`, kernels K23-K26) with one sequencer; its client
replies carry no slot, so a completion finds its command by replaying the
best replica's applied prefix (`SCAN_SLOT`)."""

from __future__ import annotations

import numpy as np

from . import Applier
from ..checkers.set_full import range_checksum
from ..nodes import EncodeCapacityError
from ..nodes.broadcast_batched import (BroadcastBatchedProgram, T_BATCH,
                                       T_BATCH_OK)
from ..nodes.compartment import (CompartmentProgram, OP_WRITE as C_WRITE,
                                 _unpack_cmd)
# T_WRITE names a wire code in the results' send-count-by-type, as the
# JAX module's import does
from ..nodes.raft import (OP_TXN, RaftProgram, T_TXN, T_TXN_OK,  # noqa: F401
                          T_WRITE)


# sentinel slot: the engine's reply proves the command applied but not
# where — ingest() must locate it in the replayed log
SCAN_SLOT = -1


class StreamLagError(RuntimeError):
    """The acked stream position is not yet readable from any node's
    state: volatile commit indexes lag the ack, or a kill wiped them
    mid-stretch (raft's `commit` is rebuilt after restart, not
    durable). The command DID
    enter the stream — the ack proves it — so the op completes
    indeterminate (:info, may-have-happened), never crashes the run;
    a later replay that reaches the slot applies it exactly once."""


class StreamBoundary:
    """The shared host half of the `OrderedStream` contract (see the
    package docstring for the full protocol). Mixes in FIRST, so its
    request/encode/completion override the engine's welded wire
    vocabulary while decode_body (error shapes, redirect hints) stays
    the engine's."""

    def _stream_init(self, applier: Applier):
        self.applier = applier
        self._oseq = 0               # proposal counter (host_state)
        # replay state — reconstructed from the stream on resume,
        # never checkpointed
        self._app_state = applier.init_state()
        self._applied_ids: set = set()     # at-most-once filter
        self._results: dict = {}           # cid -> apply result
        self._frontier = 0                 # slots replayed so far

    # --- propose -------------------------------------------------------

    def request_for_op(self, op):
        if "_oseq" not in op:
            # stamp the proposal identity ON the op: a redirect requeue
            # or retry re-encodes the SAME (seq, cmd) — the same intern
            # id — so one op can never fork into two stream commands
            op["_oseq"] = self._oseq
            self._oseq += 1
            op["_ocmd"] = self.applier.command(op)
        return {"type": "propose", "seq": op["_oseq"],
                "cmd": op["_ocmd"]}

    def encode_body(self, body, intern):
        if body.get("type") != "propose":
            raise ValueError(f"ordered[{self.stream_engine}]: "
                             f"unexpected body {body.get('type')!r}")
        key = ["os", body["seq"], body["cmd"]]
        cid = intern.peek(key)
        if cid is None:
            self.check_capacity(len(intern))
            cid = intern.id(key)
        return self.propose_words(cid)

    # --- replay --------------------------------------------------------

    def _apply_cid(self, cid: int, intern):
        """Applies one delivered command id (at most once)."""
        if cid in self._applied_ids:
            return
        self._applied_ids.add(cid)
        cmd = intern.value(cid)[2]
        self._app_state, res = self.applier.apply(self._app_state, cmd)
        self._results[cid] = res

    def _own_cid(self, op, intern) -> int:
        cid = intern.peek(["os", op["_oseq"], op["_ocmd"]])
        if cid is None:            # encode ran, so the id must exist
            raise RuntimeError("ordered: completed op was never encoded")
        return cid

    def completion(self, op, body, read_state, intern):
        slot = self.reply_slot(body)
        if slot is None:
            # engine acks that carry no stream position (shouldn't
            # happen for stream proposals) complete bare
            return {**op, "type": "ok"}
        cid = self._own_cid(op, intern)
        if cid not in self._results:
            # replay is pure and slot-ordered, so a command already in
            # the replayed prefix needs no fresh state read
            try:
                self.ingest(slot, read_state, intern)
            except StreamLagError as e:
                return {**op, "type": "info", "error": ["stream-lag",
                                                        str(e)]}
        res = self._results.get(cid)
        if res is None:
            if self.ingest_covers_ack:
                # ingest returned having replayed through the acked
                # slot, so a missing command is a real invariant break
                # (id packing or replay), not replication lag
                raise RuntimeError(
                    f"ordered[{self.stream_engine}]: command {cid} "
                    f"acked at slot {slot} but absent from the "
                    f"replayed prefix")
            # SCAN_SLOT engines replay to the best visible prefix,
            # which a kill can leave short of the ack — same lag class
            return {**op, "type": "info", "error": [
                "stream-lag", f"command {cid} acked but not yet in "
                              f"any readable applied prefix"]}
        return self.applier.completed(op, res)

    def completion_payload(self, op, body, payload, intern):
        # engines with reply payloads (broadcast) route through the
        # same stream completion; the payload itself is unused
        return self.completion(op, body, None, intern)

    # --- checkpointable host state --------------------------------------

    def host_state(self):
        return {"ostream": {"seq": self._oseq,
                            "applier": self.applier.host_view()},
                "engine": super().host_state()}

    def set_host_state(self, st):
        if isinstance(st, dict) and "ostream" in st:
            self._oseq = int(st["ostream"].get("seq", 0))
            self.applier.restore(st["ostream"].get("applier"))
            super().set_host_state(st.get("engine"))
        else:
            super().set_host_state(st)

    # --- engine-specific surface ----------------------------------------

    # True: a successful ingest(slot, ...) has replayed THROUGH the
    # acked slot, so an acked command missing afterwards is a bug.
    # False (SCAN_SLOT engines): ingest replays to the best visible
    # prefix, which replication lag can leave short of the ack.
    ingest_covers_ack = True

    def propose_words(self, cid: int):
        raise NotImplementedError

    def reply_slot(self, body):
        raise NotImplementedError

    def ingest(self, slot, read_state, intern):
        raise NotImplementedError

    def check_capacity(self, n: int):
        raise NotImplementedError


class OrderedRaft(StreamBoundary, RaftProgram):
    """lin-kv's raft serving an arbitrary applier: commands ride the
    log as OP_TXN entries (16-bit interned ids split over the entry's
    v1/v2 bytes), the leader's apply-point reply carries the commit
    position, and the host replays the committed prefix — the
    `nodes/txn_list_append.py` architecture with the interpreter made
    pluggable. Committed entries are immutable and replica-identical,
    so end-of-stretch state reads are exact (`state_reads_final`)."""

    name = "ordered"
    stream_engine = "raft"
    needs_state_reads = True
    state_reads_final = True

    def __init__(self, opts, nodes, applier: Applier, device="cuda"):
        RaftProgram.__init__(self, opts, nodes, device=device)
        self._stream_init(applier)

    def check_capacity(self, n):
        if n > 0xFFFF:
            raise EncodeCapacityError(
                "ordered[raft] command table full (65536 commands)")

    def propose_words(self, cid):
        return (T_TXN, cid, 0, 0)

    def decode_body(self, t, a, b, c, intern):
        if t == T_TXN_OK:
            return {"type": "txn_ok", "position": int(a)}
        return super().decode_body(t, a, b, c, intern)

    def reply_slot(self, body):
        if body.get("type") == "txn_ok":
            return int(body["position"])
        return None

    def ingest(self, slot, read_state, intern):
        if slot < self._frontier:
            return
        # any replica whose commit reached `slot` serves the prefix
        # (the leader's has; committed entries are final everywhere)
        row = None
        for i in range(self.n_nodes):
            cand = read_state(i)
            if int(cand["commit"]) >= slot and int(cand["log_len"]) > slot:
                row = cand
                break
        if row is None:
            # the leader committed `slot` before acking, but commit
            # indexes are volatile: a kill + partition inside this
            # stretch can leave every readable replica behind the ack
            raise StreamLagError(
                f"ordered[raft]: no readable replica's commit covers "
                f"acked slot {slot}")
        log_a = np.asarray(row["log_a"])
        log_b = np.asarray(row["log_b"])
        for s in range(self._frontier, slot + 1):
            if (int(log_a[s]) & 0xF) != OP_TXN:
                continue           # NOOPs / non-stream entries
            cid = (int(log_b[s]) >> 8 & 0xFF) << 8 | (int(log_b[s]) & 0xFF)
            self._apply_cid(cid, intern)
        self._frontier = slot + 1


class OrderedBatched(StreamBoundary, BroadcastBatchedProgram):
    """Chop Chop-style batched atomic broadcast serving an arbitrary
    applier: the host-side distiller's contiguous id assignment IS the
    sequencer (arxiv 2304.07081 puts the ordering authority in the
    batching layer), so a command's stream position is its interned
    id — assigned between invoke and reply, which is what makes
    id-order serialization real-time consistent. The simulated network
    still carries every batch and its expansion-proof ack (faults
    delay acks, never reorder the stream), and replay needs no device
    reads at all: the host interned every command, so the prefix below
    any id is host-known by construction."""

    name = "ordered"
    stream_engine = "batched"
    needs_state_reads = False

    def __init__(self, opts, nodes, applier: Applier, device="cuda"):
        opts = dict(opts)
        # the value table must hold one id per client op: scale the
        # default with the offered op count like raft's log cap
        rate = float(opts.get("rate") or 0.0)
        tl = float(opts.get("time_limit") or 0.0)
        opts.setdefault("max_values", int(2 * rate * tl) + 256)
        BroadcastBatchedProgram.__init__(self, opts, nodes, device=device)
        self._stream_init(applier)

    def check_capacity(self, n):
        if n >= self.V:
            raise EncodeCapacityError(
                f"ordered[batched] command table full ({self.V}); "
                f"raise --max-values")

    def propose_words(self, cid):
        return (T_BATCH, cid, 1, range_checksum(cid, 1))

    def reply_slot(self, body):
        if body.get("type") == "batch_ok":
            return int(body["lo"])
        return None

    def ingest(self, slot, read_state, intern):
        # stream order is id order and the host knows every command:
        # replay straight off the intern table
        for cid in range(self._frontier, slot + 1):
            self._apply_cid(cid, intern)
        self._frontier = max(self._frontier, slot + 1)


class OrderedCompartment(StreamBoundary, CompartmentProgram):
    """The compartmentalized slot sequence serving an arbitrary applier:
    commands ride WRITE slots (the interned id packed into the 12-bit key
    x base-255 value fields), flowing sequencer -> proxy tier -> acceptor
    grid -> replicas exactly as the lin-kv path (`sim.RolePartition`,
    kernels K23-K26, K26-K29 with an elected tier: its elections,
    failover, leader redirects and lease too). Client replies don't carry the slot, so the
    completion locates its command by scanning the replica's applied
    prefix (every slot <= `applied` is chosen and final — the same
    `state_reads_final` argument as raft's committed log)."""

    name = "ordered"
    stream_engine = "compartment"
    ingest_covers_ack = False       # SCAN_SLOT: replays to best-visible

    def __init__(self, opts, nodes, applier: Applier, device="cuda"):
        CompartmentProgram.__init__(self, opts, nodes, device=device)
        # RolePartition.__init__ derived these from the client role
        # (False there), but the ordered boundary does read device state
        # in completions, and those reads are final (applied slots are
        # chosen): the declaration is instance state, set after the
        # partition's single-role check. Sound on a multi-role partition
        # because state_row maps global node ids into role subtrees.
        self.needs_state_reads = True
        self.state_reads_final = True
        self._stream_init(applier)
        self._id_cap = self.lay.keys * 255

    def check_capacity(self, n):
        if n >= self._id_cap:
            raise EncodeCapacityError(
                f"ordered[compartment] command table full "
                f"({self._id_cap}; raise kv_keys)")

    def propose_words(self, cid):
        # a WRITE whose (key, value) words carry the id in base 255: the
        # sequencer stores v1 = value + 1 (1..255), replicas apply
        # kv[key] = v1 — inert for the stream, which only reads the slot
        # sequence back
        return (T_WRITE, cid // 255, cid % 255, 0)

    def reply_slot(self, body):
        if body.get("type") == "write_ok":
            return SCAN_SLOT
        return None

    def ingest(self, slot, read_state, intern):
        lay = self.lay
        best, best_app = None, -1
        for j in range(lay.R):
            row = read_state(lay.r_base + j)
            app = int(row["applied"])
            if app > best_app:
                best_app, best = app, row
        if best is None or best_app < 0:
            # an ack exists, so SOME replica applied the command — but
            # kills can wipe every visible `applied` before this read
            raise StreamLagError("ordered[compartment]: no readable "
                                 "replica has applied anything")
        r_cmd = np.asarray(best["r_cmd"])
        for s in range(self._frontier, best_app + 1):
            key, opc, v1, _v2 = _unpack_cmd(int(r_cmd[s]))
            if opc != C_WRITE or v1 == 0:
                continue    # NOOPs / recovered gap fills apply inert
            self._apply_cid(int(key) * 255 + (int(v1) - 1), intern)
        self._frontier = best_app + 1


ENGINE_PROGRAMS = {
    "raft": OrderedRaft,
    "compartment": OrderedCompartment,
    "batched": OrderedBatched,
}
