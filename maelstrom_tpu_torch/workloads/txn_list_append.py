"""Transactional list-append workload
(reference `src/maelstrom/workload/txn_list_append.clj`).

A copy of `maelstrom_tpu/workloads/txn_list_append.py` without the
host-network client and its RPC schemas (external node processes are not
ported): the txn-conflict error, the op generator and `workload()`.
Transactions are arrays of micro-ops `[f, k, v]` where f is "r" (read,
submitted with v=null, completed with the observed list) or "append".
Nonexistent keys read as null; lists are created implicitly on append.
Graded by `checkers/elle.py` (device path: `--device-checker`)."""

from __future__ import annotations

import random

from .. import generators as g
from ..checkers.elle import ElleListAppendChecker
from ..errors import deferror

deferror(30, "txn-conflict",
         "The requested transaction has been aborted because of a conflict "
         "with another transaction. Servers need not return this error on "
         "every conflict: they may choose to retry automatically instead.",
         definite=True)


class TxnOpGen:
    """Random transactions over a sliding window of keys, honoring
    --key-count, --max-txn-length, --max-writes-per-key
    (reference `txn_list_append.clj:112-124` via jepsen append/test)."""

    def __init__(self, opts: dict):
        self.rng = random.Random(opts.get("seed", 0))
        self.key_count = opts.get("key_count") or 10
        self.max_txn_length = opts.get("max_txn_length", 4)
        self.min_txn_length = opts.get("min_txn_length", 1)
        self.max_writes = opts.get("max_writes_per_key", 16)
        self.base = 0
        self.appends: dict = {}

    def _next_value(self, k):
        self.appends[k] = self.appends.get(k, 0) + 1
        if self.appends[k] >= self.max_writes:
            # retire the oldest active key by advancing the window
            self.base += 1
        return self.appends[k]

    def __call__(self):
        length = self.rng.randint(self.min_txn_length, self.max_txn_length)
        txn = []
        for _ in range(length):
            k = self.base + self.rng.randrange(self.key_count)
            if self.rng.random() < 0.5:
                txn.append(["r", k, None])
            else:
                txn.append(["append", k, self._next_value(k)])
        return {"f": "txn", "value": txn}


def generator(opts):
    return g.Fn(TxnOpGen(opts))


def workload(opts: dict) -> dict:
    return {
        "generator": generator(opts),
        "checker": ElleListAppendChecker(
            opts.get("consistency_models", ["strict-serializable"]),
            device=opts.get("device_checker")),
    }
