"""Full set checker: the grading oracle for broadcast.

A copy of the set-full half of `maelstrom_tpu/checkers/set_full.py`.

A reimplementation of jepsen.checker/set-full semantics, which the reference
uses for g-set (`workload/g_set.clj:62`) and (with :broadcast remapped to
:add) for broadcast (`workload/broadcast.clj:215-227`). For every element
attempted, classifies it as:

  - stable:      eventually present in every read that begins afterwards
  - lost:        known (acknowledged or observed), but a read that began
                 after it was known returned without it, and it never came
                 back — data loss, the test fails
  - never-read:  no read began after the element was known, so we can't say
  - stale:       eventually stable, but some read that began after the
                 element was known missed it (visibility lag)

Also reports stable-latencies at quantiles {0, 0.5, 0.95, 0.99, 1}:
the ms from an element becoming *known* (acknowledged or first
observed) to the last moment any read observed it missing — pure
propagation-visibility lag, 0 when no read ever missed it. This matches
the reference's tables (`doc/03-broadcast/02-performance.md:139-272`),
whose quantile 0 is always exactly 0 and whose maxima track propagation
time rather than the idle gap before final reads.
"""

from __future__ import annotations

from . import Checker
from ..history import coerce_history


def quantiles(sorted_xs: list, qs=(0, 0.5, 0.95, 0.99, 1)) -> dict:
    if not sorted_xs:
        return {q: None for q in qs}
    n = len(sorted_xs)
    out = {}
    for q in qs:
        i = min(n - 1, int(q * n))
        out[q] = sorted_xs[i]
    return out


class SetFullChecker(Checker):
    name = "set-full"

    def __init__(self, add_f: str = "add"):
        # Broadcast remaps :broadcast -> :add (`broadcast.clj:215-227`);
        # rather than rewriting history we accept the add f directly.
        self.add_f = add_f

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        pairs = history.pairs()

        # Element -> add info
        attempts = {}          # element -> invoke time
        acked = {}             # element -> ack (completion) time
        for invoke, complete in pairs:
            if invoke.f != self.add_f:
                continue
            attempts[invoke.value] = invoke.time
            if complete is not None and complete.is_ok():
                acked[invoke.value] = complete.time

        # Reads: (invoke_time, complete_time, frozenset elements, dup counts)
        reads = []
        duplicated = {}
        for invoke, complete in pairs:
            if invoke.f != "read" or complete is None or not complete.is_ok():
                continue
            value = complete.value if complete.value is not None else []
            els = frozenset(value)
            if len(els) < len(value):
                counts = {}
                for e in value:
                    counts[e] = counts.get(e, 0) + 1
                for e, c in counts.items():
                    if c > 1:
                        duplicated[e] = max(duplicated.get(e, 0), c)
            reads.append((invoke.time, complete.time, els))
        reads.sort()

        lost, stable, never_read, stale = [], [], [], []
        stale_durations = {}
        stable_latencies = []

        for e, invoke_time in attempts.items():
            present = [(ti, tc) for (ti, tc, els) in reads if e in els]
            # known: acknowledged, or observed by any read
            if e in acked:
                known_time = acked[e]
            elif present:
                known_time = min(tc for ti, tc in present)
            else:
                continue   # unacknowledged and never seen: no claim on it

            counting_absent = [ti for (ti, tc, els) in reads
                               if ti > known_time and e not in els]
            last_absent = max(counting_absent, default=None)

            if last_absent is not None and not any(
                    ti > last_absent for ti, tc in present):
                lost.append(e)
                continue
            if not present and not counting_absent:
                never_read.append(e)
                continue

            stable.append(e)
            # Stability latency, jepsen set-full style: the time from the
            # element becoming known to the LAST moment any read observed
            # it missing — 0 when no read ever missed it. (A value only
            # re-confirmed by the final reads still gets its true
            # propagation latency, not the idle gap before the finals;
            # this is what makes the reference's quantile-0 exactly 0 and
            # its grid@100ms max ~791 ms ≈ full propagation,
            # `doc/03-broadcast/02-performance.md:187-191`.)
            if last_absent is not None:
                stale.append(e)
                stale_durations[e] = last_absent - known_time
            stable_latencies.append(
                max(0, ((last_absent or known_time) - known_time)) / 1e6)

        worst_stale = sorted(stale_durations,
                             key=lambda e: -stale_durations[e])[:8]
        stable_latencies.sort()

        any_reads = bool(reads)
        valid = (False if lost
                 else ("unknown" if not any_reads else True))
        return {
            "valid": valid,
            "attempt-count": len(attempts),
            "acknowledged-count": len(acked),
            "stable-count": len(stable),
            "lost-count": len(lost),
            "lost": sorted(lost, key=repr),
            "never-read-count": len(never_read),
            "never-read": sorted(never_read, key=repr),
            "stale-count": len(stale),
            "stale": sorted(stale, key=repr),
            "worst-stale": worst_stale,
            "duplicated-count": len(duplicated),
            "duplicated": duplicated,
            "stable-latencies": {
                str(q): (round(v, 3) if v is not None else None)
                for q, v in quantiles(stable_latencies).items()},
        }


class BroadcastChecker(SetFullChecker):
    """set-full with :broadcast as the add op
    (reference `workload/broadcast.clj:215-227`)."""

    name = "broadcast"

    def __init__(self):
        super().__init__(add_f="broadcast")
