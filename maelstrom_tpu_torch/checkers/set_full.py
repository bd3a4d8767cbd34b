"""Full set checker: the grading oracle for broadcast.

A copy of `maelstrom_tpu/checkers/set_full.py`: the set-full fold and the
batched half (the expansion-proof audit of `broadcast-batched` and its
expanded grade).

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
from ..byzantine import conviction
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


# --- batched atomic broadcast (nodes/broadcast_batched.py) ---

BATCH_F = "broadcast-batch"
# The ONE definition of the expansion-proof checksum: this module is
# the auditor, so it owns the spec; the node program
# (nodes/broadcast_batched.py) imports both names and implements the
# device half against them.
PROOF_MOD = 0x7FFFFFFF          # checksums stay positive int32


def range_checksum(lo: int, n: int) -> int:
    """sum(lo..lo+n-1) mod PROOF_MOD: the arithmetic-series identity
    all three parties compute — the client at distillation time, the
    server from its own expansion mask, and this checker from the
    acked (lo, n) record."""
    return (n * lo + (n * (n - 1)) // 2) % PROOF_MOD


def verify_batch_proofs(history) -> tuple[list, dict]:
    """Audits every `broadcast-batch` op's server-side expansion proof
    against its claim. Returns (errors, stats). Each error is a definite
    fail: a server that mis-expands a batch (or a batcher that ships a
    malformed record) degrades results exactly like silent message loss.

      - duplicate-in-batch: the distilled claim itself holds one value
        twice — distillation failed to dedup.
      - forged-count: the acked count disagrees with the claimed batch
        size (or with the server's own expanded id list).
      - truncated-batch: the server expanded different values than the
        batch claimed (fewer, extra, or reordered).
      - forged-proof: the acked checksum is not the arithmetic-series
        sum of the acked id range — count and range were tampered
        inconsistently.
      - replayed-batch: two acknowledged batches claim the same id
        range. Ranges are disjoint by construction (fresh sequential
        interns), so a second ack of one range is a replay — the
        at-least-once hazard the `duplicate` nemesis models.
    """
    history = coerce_history(history)
    errors: list = []
    acked_lo: dict = {}
    batches = acked = ops_claimed = 0
    for invoke, complete in history.pairs():
        if invoke.f != BATCH_F:
            continue
        batches += 1
        claimed = list(invoke.value or ())
        ops_claimed += len(claimed)
        keys = [repr(v) for v in claimed]
        if len(set(keys)) != len(keys):
            errors.append({"index": invoke.index,
                           "process": invoke.process,
                           "error": "duplicate-in-batch"})
        if complete is None or not complete.is_ok():
            continue
        acked += 1
        rec = complete.value
        if not (isinstance(rec, dict)
                and {"lo", "n", "proof", "expanded"} <= set(rec)):
            errors.append({"index": invoke.index,
                           "process": invoke.process,
                           "error": "malformed-ack", "value": rec})
            continue
        lo, n = int(rec["lo"]), int(rec["n"])
        expanded = list(rec["expanded"])
        if n != len(claimed) or n != len(expanded):
            errors.append({"index": invoke.index,
                           "process": invoke.process, "error": "forged-count",
                           "claimed": len(claimed), "acked": n,
                           "expanded": len(expanded)})
        if expanded != claimed:
            errors.append({"index": invoke.index,
                           "process": invoke.process,
                           "error": "truncated-batch",
                           "claimed": claimed, "expanded": expanded})
        if int(rec["proof"]) != range_checksum(lo, n):
            errors.append({"index": invoke.index,
                           "process": invoke.process, "error": "forged-proof",
                           "proof": int(rec["proof"]),
                           "expected": range_checksum(lo, n)})
        if lo in acked_lo:
            errors.append({"index": invoke.index,
                           "process": invoke.process,
                           "error": "replayed-batch", "lo": lo,
                           "first": acked_lo[lo]})
        else:
            acked_lo[lo] = invoke.index
    return errors, {"batch-count": batches, "acked-batch-count": acked,
                    "batched-op-count": ops_claimed}


def expand_batched_history(history):
    """The equivalent unbatched history: every `broadcast-batch` op is
    expanded into one `broadcast` op per claimed value (invoke/complete
    times preserved; each expanded op gets a synthetic sub-process so
    invoke/completion pairing stays adjacent per process), reads pass
    through unchanged. `BatchedBroadcastChecker` grades THIS history
    with the stock set-full fold — which is what makes its verdict
    bit-equal to the unbatched broadcast checker on the same op stream
    by construction (pinned in tests/test_broadcast_batched.py)."""
    from ..history import History
    history = coerce_history(history)
    out = History()
    for invoke, complete in history.pairs():
        if invoke.f != BATCH_F:
            out.append_row(invoke.type, invoke.f, invoke.value,
                           invoke.process, invoke.time,
                           final=invoke.final)
            if complete is not None:
                out.append_row(complete.type, complete.f, complete.value,
                               complete.process, complete.time,
                               complete.error, complete.final)
            continue
        for j, v in enumerate(invoke.value or ()):
            p = f"{invoke.process}#b{j}"
            out.append_row("invoke", "broadcast", v, p, invoke.time,
                           final=invoke.final)
            if complete is not None:
                out.append_row(complete.type, "broadcast", v, p,
                               complete.time, complete.error,
                               complete.final)
    return out


class BatchedBroadcastChecker(Checker):
    """Grades a batched-atomic-broadcast history: (1) every batch's
    server-side expansion proof is verified (`verify_batch_proofs` — any
    violation is a definite fail), (2) the expanded per-value stream is
    graded by the stock `BroadcastChecker` fold, so lost/stable/stale
    classification and stable-latency quantiles are bit-equal to the
    unbatched checker on the same op stream."""

    name = "broadcast-batched"

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        errors, stats = verify_batch_proofs(history)
        sub = BroadcastChecker().check(
            test, expand_batched_history(history), opts)
        out = dict(sub)
        out.update(stats)
        out["proof-errors"] = errors
        if errors:
            out["valid"] = False
        return out

    def convictions(self, test, history, opts=None):
        """Byzantine conviction hook (doc/faults.md): every expansion-
        proof audit error doubles as a conviction of the node that
        served the batch — the proof vocabulary is exactly the surface
        the forged-proof attack corrupts, and the audit is a definite
        fail either way. Culprit: batch acks come from the client's
        home node (`process % N`, the runner's routing for non-leader
        programs on both paths)."""
        errors, _stats = verify_batch_proofs(history)
        nodes = list(test.get("nodes") or ())
        agg: dict = {}
        for e in errors:
            p = e.get("process")
            culprit = (nodes[p % len(nodes)]
                       if nodes and isinstance(p, int) else "unknown")
            key = (e["error"], culprit)
            if key in agg:
                agg[key]["evidence"]["count"] += 1
            else:
                agg[key] = conviction(e["error"], culprit,
                                      {"count": 1, **e})
        return list(agg.values())

