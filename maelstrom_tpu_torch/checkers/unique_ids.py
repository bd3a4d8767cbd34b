"""Unique-ID checker: every acknowledged `generate` returned a distinct
id (classic Maelstrom's unique-ids workload).

A copy of `maelstrom_tpu/checkers/unique_ids.py`.

Semantics: ok-completed `generate` ops must carry pairwise-distinct
values. `fail`/`info` ops don't constrain anything — an id the client
never received can be reissued (the node may reuse it or not; nobody
observed it). Duplicates are reported with the processes and times of
every collision, so a failing run names its witness like every other
checker here.
"""

from __future__ import annotations

from . import Checker
from ..history import coerce_history


class UniqueIdsChecker(Checker):
    name = "unique-ids"

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        seen: dict = {}          # id -> first (process, time)
        dups: dict = {}          # id -> [(process, time), ...]
        attempts = 0
        acked = 0
        for invoke, complete in history.pairs():
            if invoke.f != "generate":
                continue
            attempts += 1
            if complete is None or not complete.is_ok():
                continue
            acked += 1
            v = complete.value
            key = repr(v)
            if key in seen:
                dups.setdefault(key, [seen[key]]).append(
                    (complete.process, complete.time))
            else:
                seen[key] = (complete.process, complete.time)
        # zero observations can't violate uniqueness, but they can't
        # certify it either: "unknown", the codebase convention for
        # no-observation histories (cf. the stats checker) — the stats
        # gate separately fails a run whose generates never succeed
        valid = (False if dups else ("unknown" if acked == 0 else True))
        out = {
            "valid": valid,
            "attempt-count": attempts,
            "acknowledged-count": acked,
            "distinct-count": len(seen),
        }
        if dups:
            out["duplicated-count"] = len(dups)
            out["duplicated"] = {
                k: [{"process": p, "time": t} for p, t in v]
                for k, v in sorted(dups.items())[:16]}
        if acked == 0:
            out["error"] = "no generate op ever succeeded"
        return out
