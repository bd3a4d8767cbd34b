"""Perf checker: latency statistics (jepsen checker/perf equivalent,
reference `core.clj:83-84`).

A copy of `maelstrom_tpu/checkers/perf.py` without its plots
(latency-raw.svg, latency-quantiles.svg, rate.svg, timeline.html),
which are not ported: the results blocks are the same."""

from __future__ import annotations

import numpy as np

from . import Checker
from ..history import OK, TYPE_CODES, coerce_history


def _quantile_block(lats: np.ndarray) -> dict:
    """Stats over a SORTED float latency array, with the index rule and
    rounding the sequential path always used (q(p) = lats[min(n-1,
    int(p*n))], round 3)."""
    n = len(lats)
    if not n:
        return {}

    def q(p):
        return float(lats[min(n - 1, int(p * n))])
    return {"count": n, "p50": round(q(0.5), 3),
            "p95": round(q(0.95), 3), "p99": round(q(0.99), 3),
            "max": round(float(lats[-1]), 3)}


def latency_stats(history, by_f: bool = False) -> dict:
    """Latency percentiles over ok client ops, computed columnar: one
    `pairs_index()` pass + numpy masks over the history's
    struct-of-arrays columns — no per-pair Python loop. With `by_f`,
    adds a per-:f breakdown under "by-f"."""
    history = coerce_history(history)
    soa = history.soa()
    pairs = history.pairs_index()
    if not len(pairs):
        return {}
    inv, comp = pairs[:, 0], pairs[:, 1]
    try:
        nem = soa.process_table.index("nemesis")
    except ValueError:
        nem = -1
    ok_code = TYPE_CODES[OK]
    safe_comp = np.where(comp >= 0, comp, 0)
    mask = ((comp >= 0) & (soa.process[inv] != nem)
            & (soa.type[safe_comp] == ok_code))
    if not mask.any():
        return {}
    inv, comp = inv[mask], comp[mask]
    lats = (soa.time[comp] - soa.time[inv]) / 1e6
    order = np.argsort(lats, kind="stable")
    out = _quantile_block(lats[order])
    if by_f:
        fcodes = soa.f[inv]
        out["by-f"] = {
            str(soa.f_table[fc]): _quantile_block(
                np.sort(lats[fcodes == fc], kind="stable"))
            for fc in np.unique(fcodes)}
    return out


class PerfChecker(Checker):
    name = "perf"

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        return {"valid": True,
                "latency-ms": latency_stats(history, by_f=True)}


class TimelineChecker(Checker):
    name = "timeline"

    def check(self, test, history, opts=None):
        return {"valid": True}
