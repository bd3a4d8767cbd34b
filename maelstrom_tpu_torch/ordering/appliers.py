"""The appliers: deterministic state machines extracted from the lin-kv,
kafka and txn-list-append paths.

Copies of `maelstrom_tpu/ordering/appliers.py`. Each is a pure replay
machine (`Applier`): the engine decides where in the stream a command
sits, the applier what it means. The lin-kv applier (lin-mutex's too:
its locks ride the lin-kv RPCs) is `services.PersistentKV`, the
reference's pure state machine; the kafka applier replays the classic
full-prefix workload (per-key append-only logs, full-observation polls,
monotone committed offsets), the shapes `checkers/kafka.py` audits; the
txn applier reuses `nodes.txn_list_append.apply_txn`, the interpreter
the Raft transaction program replays through. Every command is replayed
at one stream position with an at-most-once filter upstream
(`engines.StreamBoundary`), so `apply` sees each op exactly once, in
order."""

from __future__ import annotations

from types import SimpleNamespace

from . import Applier, fail_completion
from ..nodes.txn_list_append import apply_txn
from ..services import PersistentKV

# the workloads module defines the KV error codes 20/21/22 at import
# time; the applier surfaces the same codes
from ..workloads import lin_kv as _lin_kv_errors  # noqa: F401


class LinKVApplier(Applier):
    """read/write/cas over the pure reference KV machine
    (`services.PersistentKV`): values are arbitrary JSON."""

    name = "lin-kv"

    def init_state(self):
        return PersistentKV()

    def command(self, op):
        k, v = op["value"]
        if op["f"] == "read":
            return {"type": "read", "key": k}
        if op["f"] == "write":
            return {"type": "write", "key": k, "value": v}
        return {"type": "cas", "key": k, "from": v[0], "to": v[1]}

    def apply(self, state, cmd):
        return state.handle(SimpleNamespace(body=dict(cmd)))

    def completed(self, op, result):
        if result.get("type") == "error":
            return fail_completion(op, int(result.get("code", -1)),
                                   result.get("text", ""))
        if op["f"] == "read":
            return {**op, "type": "ok",
                    "value": [op["value"][0], result["value"]]}
        return {**op, "type": "ok"}


class KafkaApplier(Applier):
    """The classic full-prefix kafka workload as a replay machine: sends
    append to per-key logs (the result is the assigned offset), polls
    observe every key's full prefix, commits raise monotone per-key
    floors, lists read them back. Commit claims are fixed at command time
    from the session's polled floors, so replay is deterministic."""

    name = "kafka"

    def __init__(self, opts):
        super().__init__(opts)
        self._polled: dict = {}    # str(key) -> max polled offset

    def init_state(self):
        return {"logs": {}, "committed": {}}

    def command(self, op):
        f = op["f"]
        if f == "send":
            k, m = op["value"]
            return ["send", int(k), m]
        if f == "poll":
            return ["poll"]
        if f == "commit":
            return ["commit", dict(self._polled)]
        return ["list"]

    def apply(self, state, cmd):
        tag = cmd[0]
        if tag == "send":
            _t, k, m = cmd
            logs = dict(state["logs"])
            cur = list(logs.get(str(k), ()))
            cur.append(m)
            logs[str(k)] = cur
            return {**state, "logs": logs}, ["send_ok", len(cur) - 1]
        if tag == "poll":
            msgs = {k: [[o, m] for o, m in enumerate(log)]
                    for k, log in state["logs"].items() if log}
            return state, ["poll_ok", msgs]
        if tag == "commit":
            offs = {str(k): int(v) for k, v in cmd[1].items()}
            comm = dict(state["committed"])
            for k, v in offs.items():
                comm[k] = max(comm.get(k, -1), v)
            return {**state, "committed": comm}, ["commit_ok", offs]
        return state, ["list_ok", dict(state["committed"])]

    def completed(self, op, result):
        tag = result[0]
        if tag == "send_ok":
            k, m = op["value"]
            return {**op, "type": "ok", "value": [str(k), m, result[1]]}
        if tag == "poll_ok":
            msgs = result[1]
            for k, pairs in msgs.items():
                if pairs:
                    self._polled[k] = max(self._polled.get(k, -1),
                                          pairs[-1][0])
            return {**op, "type": "ok", "value": msgs}
        return {**op, "type": "ok", "value": result[1]}

    def host_view(self):
        return {"polled": dict(self._polled)}

    def restore(self, view):
        self._polled = dict((view or {}).get("polled") or {})


class TxnListAppendApplier(Applier):
    """Transactional list-append: the Raft transaction program's
    micro-op interpreter (`apply_txn`) over a persistent dict; reads
    observe the prefix state, appends extend it, graded by the Elle
    checker under strict serializability."""

    name = "txn-list-append"

    def init_state(self):
        return {}

    def command(self, op):
        return ["txn", op["value"]]

    def apply(self, state, cmd):
        return apply_txn(state, cmd[1])

    def completed(self, op, result):
        return {**op, "type": "ok", "value": result}


APPLIERS = {
    "lin-kv": LinKVApplier,
    "lin-mutex": LinKVApplier,      # lin-mutex rides the lin-kv RPCs
    "kafka": KafkaApplier,
    "txn-list-append": TxnListAppendApplier,
}
