"""Linearizable timestamp-oracle workload (the reference's built-in
`lin-tso` service, `service.clj:116-122`).

A copy of `maelstrom_tpu/workloads/lin_tso.py` without the host-network
client and its RPC schema (external node processes are not ported): the
op source and `workload()`. Clients request timestamps; the oracle must
hand out unique, real-time-monotonic values (`checkers/tso.py`). It is
served by the role-partitioned services cluster (`-w lin-tso --node
tpu:services`, `nodes/services.py`)."""

from __future__ import annotations

from .. import generators as g
from ..checkers.tso import TSOChecker


class TSOpGen:
    """Picklable timestamp-request stream."""

    def __call__(self):
        return {"f": "ts", "value": None}


def generator(opts):
    return g.Fn(TSOpGen())


def workload(opts: dict) -> dict:
    return {
        "generator": generator(opts),
        "checker": TSOChecker(),
    }
