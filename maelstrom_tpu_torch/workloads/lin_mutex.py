"""Distributed-lock workload: mutual exclusion graded by the holder-aware
mutex model (`checkers/linearizable.MutexModel`, the Knossos
knossos.model/mutex role).

A copy of `maelstrom_tpu/workloads/lin_mutex.py` without the host-network
client and its doc-only RPC registrations. The lock IS a lin-kv register:
the well-known key `LOCK_KEY` holds `FREE` or a holder id, and clients
contend with the standard cas RPC (acquire = cas(FREE -> 2+worker),
release = cas(2+worker -> FREE)), so the Raft lin-kv program
(`--node tpu:lin-kv`) serves it unchanged.

Histories are graded twice over the same ops: the cas ops under the
per-key WGL register checker, and mapped to acquire/release under the
mutex model (no two holders at once, no release by a non-holder).
Threads alternate acquire/release blindly: a failed acquire (22,
definite) makes the following release fail too, both excluded from the
WGL search. An init phase writes FREE once before contention starts."""

from __future__ import annotations

from .. import generators as g
from ..checkers import Checker
from ..checkers.linearizable import (INF, LinearizableRegisterChecker,
                                     MutexModel, check_history)
from ..history import coerce_history
from . import lin_kv  # noqa: F401  (the KV error codes 20-22)

LOCK_KEY = 0
FREE = 1          # 0 is "absent" on the raft wire; FREE must be a value


class UntilOk(g.Gen):
    """Re-emits `op_map` (one attempt in flight at a time) until an
    attempt completes ok; used for the init write, which fails fast
    with error 11 while the cluster is still electing. An attempt
    graded info may still apply later: schedule nemeses after the init
    phase (the default nemesis interval does), or the late re-apply can
    reset the lock mid-contention."""

    def __init__(self, op_map: dict, in_flight: bool = False,
                 done: bool = False):
        self.op_map = op_map
        self.in_flight = in_flight
        self.done = done

    def op(self, ctx):
        if self.done:
            return None, self
        if self.in_flight:
            return g.PENDING, self
        free = g.free_clients(ctx)
        if not free:
            return g.PENDING, self
        return (g.fill_op(dict(self.op_map), ctx, free[0]),
                UntilOk(self.op_map, True, False))

    def update(self, ctx, event):
        if (self.done or not self.in_flight
                or event.get("f") != self.op_map["f"]
                or event.get("value") != self.op_map.get("value")):
            return self
        return UntilOk(self.op_map, False, event.get("type") == "ok")


class LockScriptGen(g.Gen):
    """Per-process alternating acquire/release cas script. Each process's
    holder id is stable across timeouts: jepsen-style process bumping
    keeps `p % workers` the worker lineage."""

    def __init__(self, counts: dict | None = None):
        self.counts = counts or {}

    def op(self, ctx):
        free = g.free_clients(ctx)
        if not free:
            return g.PENDING, self
        p = free[0]
        workers = max(len(g.client_processes(ctx)), 1)
        holder = 2 + (p % workers) % 250     # 8-bit wire value headroom
        i = self.counts.get(p, 0)
        val = ([LOCK_KEY, [FREE, holder]] if i % 2 == 0
               else [LOCK_KEY, [holder, FREE]])
        op = g.fill_op({"f": "cas", "value": val}, ctx, p)
        return op, LockScriptGen({**self.counts, p: i + 1})


def _mutex_ops(history):
    ops = []
    for invoke, complete in history.pairs():
        if invoke.f != "cas":
            continue                      # the init write, reads
        if complete is not None and complete.is_fail():
            continue
        ok = complete is not None and complete.is_ok()
        _k, (frm, to) = invoke.value
        if frm == FREE and to != FREE:
            f, holder = "acquire", to
        elif to == FREE and frm != FREE:
            f, holder = "release", frm
        else:
            continue
        ops.append({"f": f, "value": holder, "inv": invoke.time,
                    "ret": complete.time if ok else INF, "ok": ok})
    return ops


class LinMutexChecker(Checker):
    """Mutual exclusion via the holder-aware mutex model, plus the
    register-level WGL check of the same cas history."""

    name = "lin-mutex"

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        ops = _mutex_ops(history)
        mutex = check_history(ops, MutexModel())
        register = LinearizableRegisterChecker().check(test, history,
                                                       opts)
        valid = (False if (mutex["valid"] is False
                           or register["valid"] is False) else
                 ("unknown" if "unknown" in (mutex["valid"],
                                             register["valid"])
                  else True))
        out = {"valid": valid,
               "acquire-release-ops": len(ops),
               "mutex": mutex,
               "register": register}
        if not ops and out["valid"] is True:
            # found anomalies dominate unknown; only a clean-but-empty
            # history downgrades
            out["valid"] = "unknown"
            out["error"] = "no acquire/release ever completed"
        return out


def workload(opts: dict) -> dict:
    return {
        "generator": g.phases(
            UntilOk({"f": "write", "value": [LOCK_KEY, FREE]}),
            LockScriptGen()),
        "checker": LinMutexChecker(),
    }
