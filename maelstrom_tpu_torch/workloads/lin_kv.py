"""Linearizable key-value workload (reference
`src/maelstrom/workload/lin_kv.clj`).

A copy of `maelstrom_tpu/workloads/lin_kv.py` without the host-network
client and its RPC schemas (external node processes are not ported): the
KV errors the workload defines, the independent-keys op generator and
`workload()`, the generator and checker of a test. The runner drives the
ops through the program's `request_for_op`, as for broadcast."""

from __future__ import annotations

import random

from .. import generators as g
from ..checkers.linearizable import LinearizableRegisterChecker
from ..errors import deferror

# KV errors are defined by this workload (reference lin_kv.clj:12-27)
deferror(20, "key-does-not-exist",
         "The client requested an operation on a key which does not exist "
         "(assuming the operation should not automatically create missing "
         "keys).",
         definite=True)
deferror(21, "key-already-exists",
         "The client requested the creation of a key which already exists, "
         "and the server will not overwrite it.",
         definite=True)
deferror(22, "precondition-failed",
         "The requested operation expected some conditions to hold, and "
         "those conditions were not met. For instance, a compare-and-set "
         "operation might assert that the value of a key is currently 5; if "
         "the value is 3, the server would return `precondition-failed`.",
         definite=True)


class KVOpGen:
    """Independent per-key register ops, rotating through keys like
    jepsen.independent/concurrent-generator: each key sees a bounded number
    of ops, then a fresh key starts."""

    def __init__(self, seed: int, ops_per_key: int):
        self.rng = random.Random(seed)
        self.ops_per_key = ops_per_key
        self.n = 0

    def __call__(self):
        key = self.n // self.ops_per_key
        self.n += 1
        r = self.rng.random()
        if r < 0.5:
            return {"f": "read", "value": [key, None]}
        if r < 0.8:
            return {"f": "write", "value": [key, self.rng.randrange(5)]}
        return {"f": "cas",
                "value": [key, [self.rng.randrange(5),
                                self.rng.randrange(5)]]}


def generator(opts):
    return g.Fn(KVOpGen(opts.get("seed", 0), opts.get("ops_per_key", 40)))


def workload(opts: dict) -> dict:
    return {
        "generator": generator(opts),
        "checker": LinearizableRegisterChecker(),
    }
