"""Unique-ID generation workload (classic Maelstrom's `unique-ids`):
clients ask any node for a fresh id, and no two acknowledged ids may be
equal.

A copy of `maelstrom_tpu/workloads/unique_ids.py` without the
host-network client and its RPC schema (external node processes are not
ported)."""

from __future__ import annotations

from .. import generators as g
from ..checkers.unique_ids import UniqueIdsChecker


def workload(opts: dict) -> dict:
    return {
        "generator": g.Repeat({"f": "generate"}),
        "checker": UniqueIdsChecker(),
    }
