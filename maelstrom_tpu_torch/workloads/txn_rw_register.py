"""Transactional read/write-register workload (classic Maelstrom's
`txn-rw-register`).

A copy of `maelstrom_tpu/workloads/txn_rw_register.py` without the
host-network client and its RPC schemas. Transactions are arrays of
micro-ops `[f, k, v]` with f in {"r", "w"}: reads are submitted with
v=null and completed with the observed value (null = never written);
writes set the register. The generator never reuses a (key, value) pair:
write uniqueness is what lets the checker trace every read to its
writer. Graded by `checkers/txn_rw_register.py`."""

from __future__ import annotations

import random

from .. import generators as g
from ..checkers.txn_rw_register import RWRegisterChecker
# error 30 (txn-conflict, definite) registration: the checker's G1a rule
# depends on aborted txns grading `fail`, not `info`
from . import txn_list_append  # noqa: F401


class RWOpGen:
    """Random r/w transactions; per-key counters keep every written
    value unique (the checker's traceability contract)."""

    def __init__(self, opts: dict):
        self.rng = random.Random(opts.get("seed", 0))
        self.key_count = opts.get("key_count") or 8
        self.max_txn_length = opts.get("max_txn_length", 4)
        self.counters: dict = {}

    def __call__(self):
        n = self.rng.randint(1, self.max_txn_length)
        mops = []
        for _ in range(n):
            k = self.rng.randrange(self.key_count)
            if self.rng.random() < 0.5:
                mops.append(["r", k, None])
            else:
                self.counters[k] = self.counters.get(k, 0) + 1
                mops.append(["w", k, self.counters[k]])
        return {"f": "txn", "value": mops}


def workload(opts: dict) -> dict:
    return {
        "generator": g.Fn(RWOpGen(opts)),
        "checker": RWRegisterChecker(),
    }
