"""Client-session bookkeeping of the runner.

A copy of `CoroutineSessions` from `maelstrom_tpu/runner/sessions.py`,
the backend a standalone run uses: every in-flight client RPC is a row
keyed by its message id, with its owning worker process, op, contacted
node and timeout deadline; a leader redirect re-issues its op as a
backoff-delayed requeue row, and the retry attempt counters follow each
process's redirect chain. The checkpoint meta (`to_meta`, `load_meta`)
comes with checkpoint and resume, the fleet's columnar table with the
fleets."""

from __future__ import annotations


def trunc_exp_bound(base, cap, attempt: int):
    """The truncated-exponential backoff bound: min(cap, base *
    2^attempt), the shift clamped so a long redirect chain cannot
    overflow. The runner's leader-redirect requeue draws virtual ROUNDS
    under it from a seeded hash (`tpu_runner._backoff_rounds`)."""
    return min(cap, base * (1 << min(int(attempt), 16)))


class CoroutineSessions:
    """The pending dict (insertion-ordered, mid -> (process, op, node,
    deadline)), the redirect-requeue list and the retry attempt / open
    structures."""

    def __init__(self):
        self._pending: dict[int, tuple] = {}
        self._requeue: list[tuple] = []
        self._attempt: dict[int, int] = {}
        self._open: set[int] = set()

    # --- pending RPCs ---------------------------------------------------

    def register(self, mid: int, process, op, node: int, deadline: int):
        self._pending[mid] = (process, op, node, deadline)

    def absorb_results(self, mids) -> list:
        """Folds a batch of drained reply ids into the table: pops and
        returns the (process, op, node, deadline) entry per mid, None
        for a stale reply (already completed/timed out)."""
        pop = self._pending.pop
        return [pop(m, None) for m in mids]

    def take_expired(self, r: int) -> list:
        """Pops every pending row whose timeout deadline has passed, in
        REGISTRATION order (the dict-insertion order the timeout
        completions have always used). Returns (process, op, node)."""
        expired = [m for m, (_, _, _, dl) in self._pending.items()
                   if dl <= r]
        return [self._pending.pop(m)[:3] for m in expired]

    def min_deadline(self):
        if not self._pending:
            return None
        return min(v[3] for v in self._pending.values())

    def __len__(self):
        return len(self._pending)

    def __bool__(self):
        return bool(self._pending)

    # --- leader-redirect requeue ----------------------------------------

    def requeue(self, due, process, op, node, t, a, b, c):
        self._requeue.append((due, process, op, node, t, a, b, c))

    def has_requeue(self) -> bool:
        return bool(self._requeue)

    def requeue_min_due(self):
        if not self._requeue:
            return None
        return min(rw[0] for rw in self._requeue)

    def take_due_requeues(self, r: int) -> list:
        """Pops rows whose backoff elapsed (due <= r), stable-sorted by
        due round (append order kept within a round). Returns (process,
        op, node, t, a, b, c) rows ready to inject."""
        due_rows = sorted((rw for rw in self._requeue if rw[0] <= r),
                          key=lambda rw: rw[0])
        if due_rows:
            self._requeue = [rw for rw in self._requeue if rw[0] > r]
        return [rw[1:] for rw in due_rows]

    def drain_requeues(self, r: int) -> list:
        """Pops EVERY row (continuous mode: retries join the scheduled
        stream), due rounds clamped to the current window start, append
        order kept. Returns (due, process, op, node, t, a, b, c)."""
        rows = [(max(int(rw[0]), r),) + tuple(rw[1:])
                for rw in self._requeue]
        self._requeue = []
        return rows

    # --- retry / redirect chains ----------------------------------------

    def attempt(self, process) -> int:
        return self._attempt.get(process, 0)

    def open_retry(self, process, attempt: int):
        self._attempt[process] = attempt
        self._open.add(process)

    def retry_is_open(self, process) -> bool:
        return process in self._open

    def close_retry(self, process):
        self._attempt.pop(process, None)
        self._open.discard(process)
