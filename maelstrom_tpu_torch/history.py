"""Operation histories.

A copy of `maelstrom_tpu/history.py` (the checkpoint and segment-append
paths left out): the runner appends rows, the checkers read them, the
store writes them as `history.jsonl`.

The history is the framework's core observable artifact: a list of operations
recorded by client worker threads, in the Jepsen style the reference inherits.
Each operation appears (usually) twice: once as an `invoke` and once as a
completion (`ok`, `fail`, or `info`):

  - invoke: the client began the operation
  - ok:     the operation definitely completed
  - fail:   the operation definitely did NOT take place (definite errors,
            reference `client.clj:214-233`)
  - info:   the outcome is unknown (timeouts / indefinite errors); the op may
            take effect at any later time

Checkers are pure functions of histories (reference test strategy,
`test/maelstrom/workload/pn_counter_test.clj`), so Op is a plain dataclass
that round-trips to JSON.

Storage is columnar (struct-of-arrays): scalar fields live in numpy
columns (type/f/process as small interned codes, time/index as int64,
final as bool) with one object column each for values and errors. At
production scale the analysis pipeline — partitioning, pairing,
screening — runs as numpy group-bys over these columns instead of
per-op Python interpretation; `Op` remains the lazy row view,
materialized on access and never stored.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

# type codes are fixed (the four Jepsen op types); anything else interns
# past them, so a malformed fixture degrades to a slow code, not a crash
TYPE_CODES = {INVOKE: 0, OK: 1, FAIL: 2, INFO: 3}


@dataclass
class Op:
    type: str                   # invoke | ok | fail | info
    f: Optional[str] = None     # e.g. "read", "add", "broadcast", "txn"
    value: Any = None
    process: Any = None         # worker thread id or :nemesis
    time: int = 0               # nanoseconds since test start (virtual or real)
    index: int = -1             # position in the history
    error: Any = None
    final: bool = False         # marks final reads (pn-counter/set checkers)

    def is_ok(self):
        return self.type == OK

    def is_info(self):
        return self.type == INFO

    def is_fail(self):
        return self.type == FAIL

    def to_dict(self) -> dict:
        d = {"index": self.index, "type": self.type, "f": self.f,
             "value": self.value, "process": self.process, "time": self.time}
        if self.error is not None:
            d["error"] = self.error
        if self.final:
            d["final"] = True
        return d

class _Interner:
    """Bidirectional value<->small-int-code table for a column whose
    domain is tiny (op types, :f names, process ids)."""

    __slots__ = ("values", "codes")

    def __init__(self, seed=()):
        self.values: list = list(seed)
        self.codes: dict = {v: i for i, v in enumerate(self.values)}

    def code(self, v) -> int:
        c = self.codes.get(v)
        if c is None:
            c = len(self.values)
            self.codes[v] = c
            self.values.append(v)
        return c


class Columns:
    """The struct-of-arrays view of a history: trimmed (length-n) column
    arrays plus the intern tables decoding the coded columns. Arrays are
    live views into the history's buffers — append-only, so rows < n are
    immutable and safe to read from analysis worker threads."""

    __slots__ = ("n", "type", "f", "process", "time", "index", "final",
                 "value", "error", "f_table", "process_table")

    def __init__(self, n, type_, f, process, time, index, final, value,
                 error, f_table, process_table):
        self.n = n
        self.type = type_
        self.f = f
        self.process = process
        self.time = time
        self.index = index
        self.final = final
        self.value = value
        self.error = error
        self.f_table = f_table
        self.process_table = process_table


def _obj_array(seq, m: int) -> np.ndarray:
    out = np.empty(m, object)
    out[:] = list(seq)
    return out


class History:
    """An indexed operation history with invoke/completion pairing
    (the analogue of knossos.history/pair-index used by the echo checker,
    reference `workload/echo.clj:49-63`).

    Backed by growable numpy columns; `history[i]` / iteration
    materialize `Op` rows lazily. `append_row` is the no-Op-object hot
    path used by the runners; `soa()` exposes the columns to the
    vectorized checkers."""

    _INIT_CAP = 1024

    def __init__(self):
        self._n = 0
        cap = self._INIT_CAP
        self._type = np.zeros(cap, np.int8)
        self._f = np.zeros(cap, np.int32)
        self._process = np.zeros(cap, np.int32)
        self._time = np.zeros(cap, np.int64)
        self._index = np.zeros(cap, np.int64)
        self._final = np.zeros(cap, bool)
        self._value = np.empty(cap, object)
        self._error = np.empty(cap, object)
        self._types = _Interner((INVOKE, OK, FAIL, INFO))
        self._fs = _Interner()
        self._procs = _Interner()

    # --- growth ---

    def _grow(self):
        cap = max(2 * len(self._type), self._INIT_CAP)
        for name in ("_type", "_f", "_process", "_time", "_index",
                     "_final", "_value", "_error"):
            old = getattr(self, name)
            new = (np.empty(cap, object) if old.dtype == object
                   else np.zeros(cap, old.dtype))
            new[:self._n] = old[:self._n]
            setattr(self, name, new)

    # --- append paths ---

    def append_row(self, type: str, f=None, value=None, process=None,
                   time: int = 0, error=None, final: bool = False,
                   index: int = -1) -> int:
        """Appends one operation without constructing an Op. Returns the
        row index."""
        i = self._n
        if i >= len(self._type):
            self._grow()
        self._type[i] = self._types.code(type)
        self._f[i] = self._fs.code(f)
        self._process[i] = self._procs.code(process)
        self._time[i] = time
        self._index[i] = i if index < 0 else index
        self._final[i] = final
        self._value[i] = value
        self._error[i] = error
        self._n = i + 1
        return i

    # --- columnar access ---

    def soa(self) -> Columns:
        n = self._n
        return Columns(n, self._type[:n], self._f[:n], self._process[:n],
                       self._time[:n], self._index[:n], self._final[:n],
                       self._value[:n], self._error[:n],
                       self._fs.values, self._procs.values)

    # --- Op facade ---

    def _materialize(self, i: int) -> Op:
        return Op(type=self._types.values[self._type[i]],
                  f=self._fs.values[self._f[i]],
                  value=self._value[i],
                  process=self._procs.values[self._process[i]],
                  time=int(self._time[i]), index=int(self._index[i]),
                  error=self._error[i], final=bool(self._final[i]))

    def __iter__(self):
        for i in range(self._n):
            yield self._materialize(i)

    def __len__(self):
        return self._n

    # --- pairing ---

    def pairs_index(self) -> np.ndarray:
        """Vectorized invoke/completion pairing: [n_invokes, 2] int64
        rows of (invoke row, completion row or -1), in invoke order.

        Within one process, ops alternate invoke/completion (a worker is
        blocked until its op completes), so pairing reduces to adjacency
        in per-process order: a stable sort by process groups each
        process's rows in history order, and an invoke pairs with its
        immediate successor iff that successor is a same-process
        completion — exactly the open-slot scan the list form ran,
        as numpy index arithmetic."""
        n = self._n
        if n == 0:
            return np.empty((0, 2), np.int64)
        t = self._type[:n]
        order = np.argsort(self._process[:n], kind="stable")
        ts = t[order]
        is_inv = ts == TYPE_CODES[INVOKE]
        procs = self._process[:n][order]
        paired = np.zeros(n, bool)
        paired[:-1] = (is_inv[:-1] & (ts[1:] != TYPE_CODES[INVOKE])
                       & (procs[1:] == procs[:-1]))
        comp = np.full(n, -1, np.int64)
        good = np.flatnonzero(paired)
        comp[good] = order[good + 1]
        inv_rows = order[is_inv]
        inv_comp = comp[is_inv]
        by_invoke = np.argsort(inv_rows, kind="stable")
        return np.stack([inv_rows[by_invoke], inv_comp[by_invoke]],
                        axis=1)

    def pairs(self) -> list[tuple[Op, Optional[Op]]]:
        """Pairs each invoke with its completion (same process, next
        occurrence). Returns [(invoke, completion-or-None), ...]."""
        return [(self._materialize(i),
                 None if j < 0 else self._materialize(j))
                for i, j in self.pairs_index()]

    # --- filtered views (materialize on demand) ---

    def _where(self, mask) -> list[Op]:
        return [self._materialize(i) for i in np.flatnonzero(mask)]

    def client_ops(self) -> list[Op]:
        nem = self._procs.codes.get("nemesis")
        if nem is None:
            return list(self)
        return self._where(self._process[:self._n] != nem)

    # --- (de)serialization ---

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(o.to_dict(), default=str)
                         for o in self)



def coerce_history(history) -> History:
    """The checkers' history argument (the JAX package also takes lists
    of ops or dicts, fixture style; nothing here passes them)."""
    if not isinstance(history, History):
        raise TypeError(f"expected a History, got {type(history)}")
    return history
