"""PN-counter interval-arithmetic checker.

Verifies that every final read is the sum of all known-completed adds plus
any subset of possibly-completed (indeterminate) adds. This is the same
interval-set algorithm as the reference (`workload/pn_counter.clj:79-125`):
start with the definite sum, then for each indeterminate add union in a
shifted copy of the acceptable set. Output format matches the reference
checker exactly (see `test/maelstrom/workload/pn_counter_test.clj:7-36`).

A copy of `maelstrom_tpu/checkers/pn_counter.py`.
"""

from __future__ import annotations

from . import Checker
from ..history import coerce_history
from ..intervals import IntervalSet


class PNCounterChecker(Checker):
    name = "pn-counter"

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        # Classify adds. Completion-only fixture histories (like the
        # reference's unit test) and full invoke/complete histories both
        # work: an invoke with no completion is indeterminate, exactly like
        # an info completion.
        definite_sum = 0
        indeterminate: list = []
        open_invokes: dict = {}     # process -> Op
        for o in history:
            if o.f != "add":
                continue
            if o.type == "invoke":
                open_invokes[o.process] = o
                continue
            open_invokes.pop(o.process, None)
            if o.is_ok():
                definite_sum += o.value
            elif o.is_info():
                indeterminate.append(o.value)
            # fail: definitely didn't happen
        indeterminate.extend(o.value for o in open_invokes.values())

        acceptable = IntervalSet([(definite_sum, definite_sum)])
        for delta in indeterminate:
            # The add may or may not have happened: allow both outcomes
            # (reference `pn_counter.clj:100-109`).
            acceptable = acceptable.union(acceptable.shift(delta))

        reads = [o for o in history if o.final and o.is_ok()]
        errors = []
        for r in reads:
            assert isinstance(r.value, int), (
                "fractional reads break the interval arithmetic "
                f"(got {r.value!r})")
            if r.value not in acceptable:
                errors.append(r.to_dict())

        return {"valid": not errors,
                "errors": errors or None,
                "final-reads": [r.value for r in reads],
                "acceptable": acceptable.to_vecs()}
