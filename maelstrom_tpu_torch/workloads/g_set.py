"""Grow-only set workload (reference `src/maelstrom/workload/g_set.clj`).

A copy of `maelstrom_tpu/workloads/g_set.py` without the host-network
client and its RPC schemas (external node processes are not ported):
adds of counting elements mixed with reads, final reads on every client,
graded by the set-full checker."""

from __future__ import annotations

from .. import generators as g
from ..checkers.set_full import SetFullChecker


def workload(opts: dict) -> dict:
    return {
        "generator": g.mix([
            g.Counting("add"),
            g.Repeat({"f": "read"})]),
        "final_generator": g.each_thread({"f": "read", "final": True}),
        "checker": SetFullChecker(),
    }
