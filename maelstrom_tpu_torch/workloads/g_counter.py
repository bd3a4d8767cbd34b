"""Grow-only counter workload: pn-counter restricted to non-negative
deltas (reference `src/maelstrom/workload/g_counter.clj:30-40`).

A copy of `maelstrom_tpu/workloads/g_counter.py` without its doc-only
RPC registrations (the host-network RPC schemas are not ported)."""

from __future__ import annotations

from .. import generators as g
from . import pn_counter


def non_negative(op: dict) -> bool:
    """Drop negative-delta adds (picklable Filter predicate)."""
    return not (op.get("f") == "add" and op.get("value", 0) < 0)


def workload(opts: dict) -> dict:
    w = pn_counter.workload(opts)
    w["generator"] = g.Filter(non_negative, w["generator"])
    return w
