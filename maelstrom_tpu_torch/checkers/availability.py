"""Availability accounting: no-reply gaps in virtual rounds.

A copy of `maelstrom_tpu/checkers/availability.py`. It folds the history's ok
completions into no-reply gaps and, when the nemesis killed nodes, the
rounds from each kill to the next ok completion (virtual rounds, so the
numbers are deterministic per seed), and adds the program's election
report (`election_report`: the elected compartment's failovers, rounds
to leader, highest ballot, current leader) where it has one. Purely
observational: `valid` is always True. Everything but `check-wall-s` is a pure function of the
history."""

from __future__ import annotations

import time

from . import Checker
from ..history import coerce_history


def gaps_rounds(ok_rounds: list, start_r: int, end_r: int) -> list:
    """[(gap_start_round, gap_rounds)] between consecutive committed
    replies, including the leading (start -> first ok) and trailing
    (last ok -> end) windows. Empty history = one gap spanning the
    run."""
    out = []
    prev = start_r
    for r in ok_rounds:
        if r > prev:
            out.append((prev, r - prev))
        prev = max(prev, r)
    if end_r > prev:
        out.append((prev, end_r - prev))
    return out


def availability_block(history, ms_per_round: float, end_round: int,
                       dip_threshold_rounds: int,
                       kill_rounds: list | None = None) -> dict:
    """The pure (history-only) part of the block: longest no-ok gap,
    dips past the threshold, and per-kill recovery times. All units are
    VIRTUAL rounds."""
    history = coerce_history(history)
    ns_pr = ms_per_round * 1e6
    ok_r = sorted(int(o.time // ns_pr) for o in history
                  if o.type == "ok" and o.process != "nemesis")
    gaps = gaps_rounds(ok_r, 0, int(end_round))
    longest = max((g for _s, g in gaps), default=int(end_round))
    dips = [(s, g) for s, g in gaps if g > dip_threshold_rounds]
    out = {
        "ok-count": len(ok_r),
        "final-round": int(end_round),
        "longest-ok-gap-rounds": int(longest),
        "dip-threshold-rounds": int(dip_threshold_rounds),
        "dip-count": len(dips),
        # cap the listing: the headline numbers above stay exact
        "dips": [{"from-round": int(s), "rounds": int(g)}
                 for s, g in dips[:32]],
    }
    if kill_rounds is None:
        kill_rounds = [int(o.time // ns_pr) for o in history
                       if o.process == "nemesis" and o.type == "invoke"
                       and o.f == "start-kill"]
    if kill_rounds:
        import bisect
        rec = []
        for kr in kill_rounds:
            i = bisect.bisect_right(ok_r, kr)
            rec.append((ok_r[i] - kr) if i < len(ok_r)
                       else (int(end_round) - kr))
        out["failover-recovery-rounds"] = {
            "per-kill": [int(x) for x in rec],
            "mean": round(sum(rec) / len(rec), 2),
            "max": int(max(rec)),
        }
    return out


class AvailabilityChecker(Checker):
    """Runner-attached availability block (installed by `run_tpu_test`
    next to TpuNetStats).
    The dip threshold defaults to the run's RPC timeout in rounds — a
    no-reply window longer than the client timeout is an outage by any
    client's measure — and is overridable via the
    `availability_dip_rounds` option."""

    name = "availability"

    def __init__(self, runner):
        self.runner = runner

    def check(self, test, history, opts=None):
        t0 = time.perf_counter()
        thr = int(test.get("availability_dip_rounds")
                  or self.runner.timeout_rounds)
        out = availability_block(
            history,
            ms_per_round=float(test.get("ms_per_round", 1.0)),
            end_round=int(getattr(self.runner, "final_round", 0) or 0),
            dip_threshold_rounds=thr)
        rep_fn = getattr(self.runner.program, "election_report", None)
        if rep_fn is not None:
            try:
                rep = rep_fn(self.runner._nodes_host())
            except Exception as e:    # observational: never fail the run
                rep = {"error": repr(e)}
            if rep is not None:
                out["election"] = rep
        out["valid"] = True
        out["check-wall-s"] = round(time.perf_counter() - t0, 6)
        return out
