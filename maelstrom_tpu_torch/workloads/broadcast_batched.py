"""Batched atomic broadcast workload (serving
`nodes/broadcast_batched.py`).

A copy of `maelstrom_tpu/workloads/broadcast_batched.py` without its
host-network client (the bin path has no distilled-batch RPC): client
values aggregate into distilled batches (`generators.BatchCounting`:
up to `batch_max` fresh values plus a `batch_dup_rate` share of
duplicate re-submissions, deduped and sorted in one numpy pass), and one
batch rides ONE simulated network message. `BatchedBroadcastChecker`
audits every expansion proof and grades the expanded per-value stream
with the set-full fold."""

from __future__ import annotations

from .. import generators as g
from ..checkers.set_full import BatchedBroadcastChecker


def workload(opts: dict) -> dict:
    batch_max = int(opts.get("batch_max") or 16)
    dup_rate = float(opts.get("batch_dup_rate", 0.25))
    return {
        "generator": g.mix([
            g.BatchCounting(batch_max=batch_max, dup_rate=dup_rate,
                            seed=int(opts.get("seed", 0))),
            g.Repeat({"f": "read"})]),
        "final_generator": g.each_thread({"f": "read", "final": True}),
        "checker": BatchedBroadcastChecker(),
    }
