"""Linearizable timestamp-oracle checker (the `lin-tso` workload).

A TSO is linearizable iff the timestamps it hands out form a
linearization witness: all granted timestamps are unique, and whenever
op A completes before op B is invoked (real-time order), A's timestamp
is smaller. Verified in O(n log n): sort granted ops by timestamp and
compare each op's invoke time against the suffix-minimum of completion
times — a later-timestamped op that completed before an
earlier-timestamped op invoked is a witness violation.

A copy of `maelstrom_tpu/checkers/tso.py`."""

from __future__ import annotations

from . import Checker
from ..history import coerce_history


class TSOChecker(Checker):
    name = "workload"

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        pairs = history.pairs()      # invoke -> completion
        granted = []
        for inv, comp in pairs:
            if comp is None or comp.type != "ok":
                continue
            granted.append((int(comp.value), inv.time, comp.time))
        out = {"granted-count": len(granted)}
        if not granted:
            out["valid"] = "unknown" if len(history) else True
            return out
        by_ts = sorted(granted)
        dup = [a[0] for a, b in zip(by_ts, by_ts[1:]) if a[0] == b[0]]
        if dup:
            out["valid"] = False
            out["duplicate-ts"] = dup[:8]
            return out
        # suffix-min of completion times over the ts-sorted ops: if any
        # later-ts op completed before this op invoked, ts order
        # contradicts real-time order
        violations = []
        suffix_min = [None] * len(by_ts)
        m = None
        for i in range(len(by_ts) - 1, -1, -1):
            _ts, _inv, comp = by_ts[i]
            suffix_min[i] = m if (m is not None and m < comp) else comp
            m = suffix_min[i]
        for i, (ts, inv, _comp) in enumerate(by_ts[:-1]):
            if suffix_min[i + 1] < inv:
                violations.append({"ts": ts, "invoked-ns": inv,
                                   "later-ts-completed-ns":
                                       suffix_min[i + 1]})
        out["monotonic"] = not violations
        if violations:
            out["violations"] = violations[:8]
        out["valid"] = not violations
        return out
