"""PN-counter workload: an eventually consistent counter with increments
and decrements (reference `src/maelstrom/workload/pn_counter.clj`).

A copy of `maelstrom_tpu/workloads/pn_counter.py` without the
host-network client and its RPC schemas (external node processes are not
ported)."""

from __future__ import annotations

import random

from .. import generators as g
from ..checkers.pn_counter import PNCounterChecker


class AddOpGen:
    """Picklable op source: add with delta in [-5, 4]
    (reference `pn_counter.clj:127-133`)."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)

    def __call__(self):
        return {"f": "add", "value": self.rng.randint(-5, 4)}


def workload(opts: dict) -> dict:
    return {
        "generator": g.mix([
            g.Fn(AddOpGen(opts.get("seed", 0))),
            g.Repeat({"f": "read"})]),
        "final_generator": g.each_thread({"f": "read", "final": True}),
        "checker": PNCounterChecker(),
    }
