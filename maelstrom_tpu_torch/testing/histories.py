"""Histories for the checkers' equivalence suites, the checker bench's
screen fixtures and the chip smoke's Elle kernel checks.

A copy of `random_append_history` from
`maelstrom_tpu/testing/histories.py` (deterministic per seed and
concurrency-shaped like runner output, so the port's bench and tests
grade the same histories as the JAX package's), and the hand-built
txn-list-append histories of the JAX package's device-Elle tests
(`ELLE_FIXTURES`): seeded G0, G1c, G-single and G-nonadjacent cycles, a
realtime cycle, list-subclass reads, no reads, the empty history."""

from __future__ import annotations

import random

from ..history import History


def random_append_history(seed, n_txn=150, keys=5, workers=6,
                          corrupt=0.0, empty_reads=False):
    """txn-list-append histories with overlapping invocations: appends
    land atomically at completion, reads observe the then-current list
    (a valid serializable execution when corrupt == 0; corrupt > 0
    plants truncated/reversed reads that seed real anomalies).
    ok/fail/info outcomes mixed like runner output."""
    rng = random.Random(seed)
    h = History()
    t = 0
    lists = {k: [] for k in range(keys)}
    nextv = [0]
    openp = {}
    for i in range(n_txn * 2):
        t += rng.randrange(1, 3)
        p = rng.randrange(workers)
        if p in openp:
            micro, kind = openp.pop(p)
            if kind != "ok":
                h.append_row(kind, "txn", micro, p, t)
                continue
            done = []
            for f, k, v in micro:
                if f == "append":
                    lists[k].append(v)
                    done.append([f, k, v])
                else:
                    obs = [] if empty_reads else list(lists[k])
                    if corrupt and rng.random() < corrupt:
                        obs = obs[:-1][::-1]
                    done.append([f, k, obs])
            h.append_row("ok", "txn", done, p, t)
        else:
            micro = []
            for _ in range(rng.randrange(1, 4)):
                k = rng.randrange(keys)
                if not empty_reads and rng.random() < 0.5:
                    nextv[0] += 1
                    micro.append(["append", k, nextv[0]])
                else:
                    micro.append(["r", k, None])
            kind = rng.choices(["ok", "fail", "info"],
                               [0.85, 0.07, 0.08])[0]
            h.append_row("invoke", "txn", micro, p, t)
            openp[p] = (micro, kind)
    return h


class ObservedList(list):
    """A list subclass as a read's value: the checker's read filter
    (`isinstance(v, list)`) must keep it."""


def _pair(h, micro_in, micro_out, t0, t1, proc=0):
    h.append({"type": "invoke", "f": "txn", "value": micro_in,
              "process": proc, "time": t0})
    h.append({"type": "ok", "f": "txn", "value": micro_out,
              "process": proc, "time": t1})


def _g0():
    h = []
    _pair(h, [["append", 1, 1], ["append", 2, 2]],
          [["append", 1, 1], ["append", 2, 2]], 0, 10, proc=0)
    _pair(h, [["append", 1, 2], ["append", 2, 1]],
          [["append", 1, 2], ["append", 2, 1]], 1, 11, proc=1)
    _pair(h, [["r", 1, None], ["r", 2, None]],
          [["r", 1, [1, 2]], ["r", 2, [1, 2]]], 12, 13)
    return h


def _g1c():
    h = []
    _pair(h, [["append", 1, 1], ["r", 2, None]],
          [["append", 1, 1], ["r", 2, [1]]], 0, 10, proc=0)
    _pair(h, [["append", 1, 2], ["append", 2, 1]],
          [["append", 1, 2], ["append", 2, 1]], 1, 11, proc=1)
    _pair(h, [["r", 1, None]], [["r", 1, [1, 2]]], 12, 13)
    return h


def _g_single(lst=list):
    h = []
    _pair(h, [["append", 1, 1], ["append", 2, 1]],
          [["append", 1, 1], ["append", 2, 1]], 0, 10, proc=0)
    _pair(h, [["r", 1, None], ["r", 2, None]],
          [["r", 1, lst([1])], ["r", 2, lst([])]], 1, 11, proc=1)
    _pair(h, [["r", 2, None]], [["r", 2, lst([1])]], 12, 13)
    return h


def _g_nonadjacent():
    h = []
    _pair(h, [["r", "a", None], ["append", "d", 2]],
          [["r", "a", []], ["append", "d", 2]], 0, 10, proc=0)
    _pair(h, [["append", "a", 1], ["append", "b", 1]],
          [["append", "a", 1], ["append", "b", 1]], 1, 11, proc=1)
    _pair(h, [["r", "c", None], ["append", "b", 2]],
          [["r", "c", []], ["append", "b", 2]], 2, 12, proc=2)
    _pair(h, [["append", "c", 1], ["append", "d", 1]],
          [["append", "c", 1], ["append", "d", 1]], 3, 13, proc=3)
    _pair(h, [["r", "a", None], ["r", "b", None],
              ["r", "c", None], ["r", "d", None]],
          [["r", "a", [1]], ["r", "b", [1, 2]],
           ["r", "c", [1]], ["r", "d", [1, 2]]], 4, 14, proc=4)
    return h


def _realtime_cycle():
    # data acyclic, but a read misses a write that returned before the
    # reader invoked
    h = []
    _pair(h, [["append", 1, 1]], [["append", 1, 1]], 0, 1, proc=0)
    _pair(h, [["r", 1, None]], [["r", 1, []]], 10, 11, proc=1)
    _pair(h, [["r", 1, None]], [["r", 1, [1]]], 20, 21, proc=2)
    return h


def _no_reads():
    h = []
    _pair(h, [["append", 1, 1]], [["append", 1, 1]], 0, 1, proc=0)
    _pair(h, [["append", 1, 2]], [["append", 1, 2]], 2, 3, proc=0)
    return h


# name -> a function returning the history's rows (dicts with type, f,
# value, process, time)
ELLE_FIXTURES = {"G0": _g0, "G1c": _g1c, "G-single": _g_single,
                 "G-nonadjacent": _g_nonadjacent,
                 "realtime-cycle": _realtime_cycle,
                 "list-subclass-reads": lambda: _g_single(ObservedList),
                 "no-reads": _no_reads, "empty": list}


def from_rows(rows) -> History:
    """A History of fixture rows."""
    h = History()
    for r in rows:
        h.append_row(r["type"], r["f"], r["value"], r["process"],
                     r["time"])
    return h
