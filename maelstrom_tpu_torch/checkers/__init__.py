"""Checkers: pure functions of histories.

A copy of `maelstrom_tpu/checkers/__init__.py` without the stream
observers of the overlap pipeline (not ported). `Compose` gathers every
checker's byzantine convictions into the `byzantine` results block.

A checker takes (test, history, opts) and returns a map with at least
`{"valid": True | False | "unknown"}`. Mirrors jepsen.checker/Checker as used
by the reference (`core.clj:82-89`). Checkers must stay pure over plain
history data so they can be unit-tested with literal fixtures (reference
`test/maelstrom/workload/pn_counter_test.clj`).
"""

from __future__ import annotations

import traceback

from ..history import coerce_history


class Checker:
    name = "checker"

    def check(self, test: dict, history, opts: dict | None = None) -> dict:
        raise NotImplementedError

    def convictions(self, test: dict, history, opts: dict | None = None):
        """The byzantine conviction hook: a list of `{"rule", "culprit",
        "evidence", ...}` dicts (`byzantine.conviction`), one for each
        lying node this checker can prove misbehaved. `Compose` gathers
        them from every checker into the `byzantine` results block. By
        default a checker has nothing to say."""
        return []


def merge_valid(vs) -> bool | str:
    """Jepsen semantics for composing validity: false dominates, then
    unknown, then true."""
    vs = list(vs)
    if any(v is False for v in vs):
        return False
    if any(v == "unknown" for v in vs):
        return "unknown"
    return True


class Compose(Checker):
    """Runs a map of named checkers over the same history and merges their
    validity (reference `core.clj:82-89` / jepsen checker/compose)."""

    name = "compose"

    def __init__(self, checkers: dict[str, Checker]):
        self.checkers = checkers

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        results = {}
        for name, c in self.checkers.items():
            try:
                results[name] = c.check(test, history, opts or {})
            except Exception as e:     # a crashed checker is an invalid test
                results[name] = {"valid": "unknown",
                                 "error": repr(e),
                                 "traceback": traceback.format_exc()}
        self._check_convictions(test, history, opts, results)
        results["valid"] = merge_valid(
            r.get("valid", "unknown") for r in results.values())
        return results

    def _check_convictions(self, test, history, opts, results):
        """Gathers the byzantine convictions of every checker and grades
        them against the injection ledger (`test["byz_injected"]`, which
        the runner sets). The block appears only when a byzantine nemesis
        ran or a checker convicted someone: a benign run that stays
        conviction-free has none."""
        convictions, cerrs = [], []
        for c in self.checkers.values():
            try:
                convictions.extend(c.convictions(test, history, opts or {}))
            except Exception as e:  # a crashed auditor proves no innocence
                cerrs.append({"checker": c.name, "error": repr(e),
                              "traceback": traceback.format_exc()})
        injected = test.get("byz_injected")
        if injected is None and not convictions and not cerrs:
            return
        from ..byzantine import assemble_block
        block = assemble_block(convictions, injected or {})
        if cerrs:
            block["errors"] = cerrs
            block["valid"] = False
        results["byzantine"] = block


class UnhandledExceptions(Checker):
    """Surfaces ops that failed with unexpected exceptions, like
    jepsen.checker/unhandled-exceptions (reference `core.clj:86`)."""

    name = "exceptions"

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        exceptions = [o.to_dict() for o in history
                      if o.error is not None
                      and isinstance(o.error, (list, tuple))
                      and len(o.error) > 0
                      and o.error[0] == "exception"]
        return {"valid": True, "exceptions": exceptions}


class Stats(Checker):
    """Op counts overall and by :f, like jepsen.checker/stats
    (reference `core.clj:87`). Valid iff every :f had at least one ok op
    (jepsen's rule), unknown when there were no completions at all."""

    name = "stats"

    def check(self, test, history, opts=None):
        history = coerce_history(history)

        def count_group(ops):
            counts = {"count": 0, "ok-count": 0, "fail-count": 0,
                      "info-count": 0}
            for o in ops:
                if o.type in ("ok", "fail", "info"):
                    counts["count"] += 1
                    counts[f"{o.type}-count"] += 1
            counts["valid"] = ("unknown" if counts["count"] == 0
                               else counts["ok-count"] > 0)
            return counts

        completions = [o for o in history.client_ops()
                       if o.type in ("ok", "fail", "info")]
        by_f: dict[str, list] = {}
        for o in completions:
            by_f.setdefault(o.f, []).append(o)
        result = count_group(completions)
        result["by-f"] = {f: count_group(ops) for f, ops in by_f.items()}
        result["valid"] = merge_valid(
            [result["valid"]] +
            [r["valid"] for r in result["by-f"].values()])
        return result
