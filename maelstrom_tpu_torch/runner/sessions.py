"""Client-session bookkeeping of the runner.

A copy of `CoroutineSessions` from `maelstrom_tpu/runner/sessions.py`,
the backend a standalone run uses, cut to the pending-RPC table: every
in-flight client RPC is a row keyed by its message id, with its owning
worker process, op, contacted node and timeout deadline. The
leader-redirect requeue and retry counters (programs with redirect
hints) and the fleet's columnar table are not ported."""

from __future__ import annotations


class CoroutineSessions:
    """The pending dict (insertion-ordered, mid -> (process, op, node,
    deadline))."""

    def __init__(self):
        self._pending: dict[int, tuple] = {}

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
