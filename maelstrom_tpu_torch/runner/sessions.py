"""Client-session bookkeeping of the runner.

Counterpart of `maelstrom_tpu/runner/sessions.py`: every in-flight
client RPC is a row keyed by its message id, with its owning worker
process, op, contacted node and timeout deadline; a leader redirect
re-issues its op as a backoff-delayed requeue row, and the retry attempt
counters follow each process's redirect chain. Two interchangeable
backends, picked by `--sessions` (`resolve_mode`):

  - `CoroutineSessions`: dict/list/set bookkeeping, one a runner (the
    default standalone);
  - `ColumnarSessions`: one table for a whole fleet, [F, S] numpy
    deadline and validity columns refreshed by one pass a wave
    (`encode_wave`), used through per-shell `SessionView` facades (the
    default under `--fleet`).

Same seed, same histories and results under either. `encode_wave`'s
device mode (F >= 64, or MAELSTROM_SESSIONS_DEVICE=0|1) runs the two
masked minima as kernel K33 `wave_reduce` (`csrc/fleet.cu`; its plain
version on the CPU). The checkpoint meta (`to_meta`, `load_meta`) comes
with checkpoint and resume."""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import kernels as K
from ..tree import resolve_device

_I64MAX = np.iinfo(np.int64).max
_I32MAX = np.iinfo(np.int32).max


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


# --- the wave pass's masked minima (K33) -----------------------------------

def wave_reduce_plain(p_mid, p_dl, r_valid, r_due):
    """(dl [F], due [F]): min of p_dl where p_mid >= 0 and of r_due where
    r_valid, row by row, INT32_MAX for an empty row (int32 in and out,
    the JAX package's `_wave_reduce_fn`)."""
    dl = torch.where(p_mid >= 0, p_dl, _I32MAX).amin(dim=1)
    due = torch.where(r_valid, r_due, _I32MAX).amin(dim=1)
    return dl.to(torch.int32), due.to(torch.int32)


def wave_reduce(p_mid, p_dl, r_valid, r_due):
    """The two masked minima of the session table (see
    `wave_reduce_plain`): p_mid, p_dl int32 [F, S], r_valid bool [F, R],
    r_due int32 [F, R]; the kernel is K33 `wave_reduce` in
    `csrc/fleet.cu`, one block a cluster row."""
    if not K.use_kernel(p_mid):
        return wave_reduce_plain(p_mid, p_dl, r_valid, r_due)
    F, S = p_mid.shape
    R = r_valid.shape[1]
    for name, t, shape, dt in (("p_mid", p_mid, (F, S), torch.int32),
                               ("p_dl", p_dl, (F, S), torch.int32),
                               ("r_valid", r_valid, (F, R), torch.bool),
                               ("r_due", r_due, (F, R), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"wave_reduce {name}: {tuple(t.shape)} "
                             f"{t.dtype}")
    dev = p_mid.device
    dl = torch.empty(F, dtype=torch.int32, device=dev)
    due = torch.empty(F, dtype=torch.int32, device=dev)
    K.WAVE_REDUCE.launch([p_mid.contiguous(), p_dl.contiguous(),
                          r_valid.contiguous(), r_due.contiguous(), dl, due],
                         [F, S, R], dev)
    return dl, due


class ColumnarSessions:
    """One client-session table for a whole fleet (the JAX package's
    `ColumnarSessions`): pending-RPC, timeout-deadline, retry/backoff and
    redirect-requeue state beside [F, S] numpy validity and deadline
    columns. `encode_wave()` is the one vectorized pass a wave: it
    refreshes every shell's min-deadline and min-due aggregates in one
    masked reduction, so a shell the wave left untouched answers its
    scan bound in O(1). Shells mutate through `SessionView` facades
    (`view(i)`); per-event point ops go through per-shell
    insertion-ordered mid -> slot dicts and free-slot stacks, op for op
    the coroutine backend's, while the numpy columns shadow the fields
    the wave pass reduces. A mutation that can lower a cached bound
    updates it in place; one that can raise it marks its shell's row
    dirty, and a dirty shell recomputes its bound with the coroutine
    backend's Python scan.

    Capacity starts at 2x concurrency (a worker holds at most one RPC in
    flight) and doubles on demand. Pending payloads are (process, op,
    node, deadline, mid); requeue payloads the legacy (due, process, op,
    node, t, a, b, c) row plus an append `seq`.

    `device_reduce` (None: F >= 64, or MAELSTROM_SESSIONS_DEVICE=0|1)
    runs the wave pass as K33 on `device` (the plain version there when
    it is the CPU); both paths give the same aggregates."""

    def __init__(self, fleet: int, concurrency: int, cap: int = 0,
                 device_reduce: bool | None = None, device="cuda"):
        F = max(int(fleet), 1)
        C = max(int(concurrency), 1)
        S = int(cap) or max(2 * C, 8)
        R = max(C, 8)
        self.F, self.C = F, C
        if device_reduce is None:
            env = os.environ.get("MAELSTROM_SESSIONS_DEVICE", "")
            device_reduce = env == "1" if env in ("0", "1") else F >= 64
        self.device_reduce = bool(device_reduce)
        self.device = (resolve_device(device) if self.device_reduce
                       else None)
        self.device_waves = 0
        # wave-pass columns [F, S]: mid < 0 marks a free slot
        self.p_mid = np.full((F, S), -1, np.int64)
        self.p_dl = np.zeros((F, S), np.int64)
        # requeue columns [F, R]
        self.r_valid = np.zeros((F, R), bool)
        self.r_due = np.zeros((F, R), np.int64)
        # retry columns [F, C]: attempt counter and open-chain flag per
        # worker process
        self.attempt_col = np.zeros((F, C), np.int32)
        self.open_col = np.zeros((F, C), bool)
        # per-event mirrors: the insertion-ordered mid -> slot dicts (the
        # coroutine pending-dict order), slot payloads, free-slot stacks
        self._slots = [dict() for _ in range(F)]
        self._pmeta = [[None] * S for _ in range(F)]
        self._pfree = [list(range(S - 1, -1, -1)) for _ in range(F)]
        self._rqmeta = [[None] * R for _ in range(F)]
        self._rqfree = [list(range(R - 1, -1, -1)) for _ in range(F)]
        self._rqn = [0] * F
        self._rqseq = [0] * F
        # the per-wave aggregate cache, exact where _cache_ok
        self._cache_ok = np.zeros(F, bool)
        self._min_dl = np.full(F, _I64MAX, np.int64)
        self._min_due = np.full(F, _I64MAX, np.int64)

    def view(self, i: int) -> "SessionView":
        return SessionView(self, i)

    # --- the per-wave table pass ----------------------------------------

    def encode_wave(self):
        """The one vectorized pass a wave: one masked reduction over the
        whole table refreshes every shell's min-deadline and min-due
        aggregates (K33 in device mode: int32 in, the int64 sentinel
        restored on the way out, as the JAX package does)."""
        if self.device_reduce:
            dev = self.device

            def put(a, dt):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    dt).to(dev)
            dl, due = wave_reduce(
                put(self.p_mid.astype(np.int32), torch.int32),
                put(np.minimum(self.p_dl, _I32MAX).astype(np.int32),
                    torch.int32),
                put(self.r_valid, torch.bool),
                put(np.minimum(self.r_due, _I32MAX).astype(np.int32),
                    torch.int32))
            dl = dl.cpu().numpy().astype(np.int64)
            due = due.cpu().numpy().astype(np.int64)
            dl[dl == _I32MAX] = _I64MAX
            due[due == _I32MAX] = _I64MAX
            self._min_dl, self._min_due = dl, due
            self._cache_ok[:] = True
            self.device_waves += 1
            return
        pvalid = self.p_mid >= 0
        self._min_dl = np.where(pvalid, self.p_dl, _I64MAX).min(axis=1)
        self._min_due = np.where(self.r_valid, self.r_due,
                                 _I64MAX).min(axis=1)
        self._cache_ok[:] = True

    def _refresh_shell(self, i: int):
        # the dirty-shell fallback: the coroutine backend's Python scans
        meta = self._pmeta[i]
        self._min_dl[i] = min(
            (meta[s][3] for s in self._slots[i].values()),
            default=_I64MAX)
        if self._rqn[i]:
            self._min_due[i] = min(m[0] for m in self._rqmeta[i]
                                   if m is not None)
        else:
            self._min_due[i] = _I64MAX
        self._cache_ok[i] = True

    # --- pending RPCs ---------------------------------------------------

    def _grow_pending(self):
        F, S = self.p_mid.shape
        self.p_mid = np.concatenate(
            [self.p_mid, np.full((F, S), -1, np.int64)], axis=1)
        self.p_dl = np.concatenate(
            [self.p_dl, np.zeros((F, S), np.int64)], axis=1)
        grown = range(2 * S - 1, S - 1, -1)
        for i in range(F):
            self._pmeta[i].extend([None] * S)
            self._pfree[i].extend(grown)

    def register(self, i, mid, process, op, node, deadline):
        free = self._pfree[i]
        if not free:
            self._grow_pending()
            free = self._pfree[i]
        s = free.pop()
        mid = int(mid)
        deadline = int(deadline)
        self.p_mid[i, s] = mid
        self.p_dl[i, s] = deadline
        self._pmeta[i][s] = (process, op, node, deadline, mid)
        self._slots[i][mid] = s
        if self._cache_ok[i] and deadline < self._min_dl[i]:
            self._min_dl[i] = deadline

    def absorb_results(self, i, mids) -> list:
        """Pops a wave's drained reply ids for shell i: the (process, op,
        node, deadline) entry per mid, None for a stale reply."""
        slots = self._slots[i]
        meta = self._pmeta[i]
        free = self._pfree[i]
        out = []
        for m in mids:
            s = slots.pop(int(m), -1)
            if s < 0:
                out.append(None)
                continue
            mt = meta[s]
            meta[s] = None
            self.p_mid[i, s] = -1
            free.append(s)
            if self._cache_ok[i] and mt[3] <= self._min_dl[i]:
                self._cache_ok[i] = False
            out.append(mt[:4])
        return out

    def take_expired(self, i, r) -> list:
        slots = self._slots[i]
        if not slots:
            return []
        if self._cache_ok[i] and r < self._min_dl[i]:
            return []       # the wave pass's bound: nothing expired
        meta = self._pmeta[i]
        expired = [s for s in slots.values() if meta[s][3] <= r]
        if not expired:
            self._refresh_shell(i)
            return []
        out = []
        free = self._pfree[i]
        for s in expired:          # dict order == registration order
            mt = meta[s]
            out.append(mt[:3])
            del slots[mt[4]]
            meta[s] = None
            self.p_mid[i, s] = -1
            free.append(s)
        self._cache_ok[i] = False
        return out

    def min_deadline(self, i):
        if not self._slots[i]:
            return None
        if not self._cache_ok[i]:
            self._refresh_shell(i)
        return int(self._min_dl[i])

    # --- leader-redirect requeue ----------------------------------------

    def _grow_requeue(self):
        F, R = self.r_valid.shape
        self.r_valid = np.concatenate(
            [self.r_valid, np.zeros((F, R), bool)], axis=1)
        self.r_due = np.concatenate(
            [self.r_due, np.zeros((F, R), np.int64)], axis=1)
        grown = range(2 * R - 1, R - 1, -1)
        for i in range(F):
            self._rqmeta[i].extend([None] * R)
            self._rqfree[i].extend(grown)

    def requeue(self, i, due, process, op, node, t, a, b, c):
        free = self._rqfree[i]
        if not free:
            self._grow_requeue()
            free = self._rqfree[i]
        s = free.pop()
        due = int(due)
        self.r_valid[i, s] = True
        self.r_due[i, s] = due
        self._rqmeta[i][s] = (due, process, op, node, t, a, b, c,
                              self._rqseq[i])
        self._rqseq[i] += 1
        self._rqn[i] += 1
        if self._cache_ok[i] and due < self._min_due[i]:
            self._min_due[i] = due

    def has_requeue(self, i) -> bool:
        return self._rqn[i] > 0

    def requeue_min_due(self, i):
        if not self._rqn[i]:
            return None
        if not self._cache_ok[i]:
            self._refresh_shell(i)
        return int(self._min_due[i])

    def _rq_pop(self, i, s):
        self.r_valid[i, s] = False
        self._rqmeta[i][s] = None
        self._rqfree[i].append(s)
        self._rqn[i] -= 1

    def take_due_requeues(self, i, r) -> list:
        if not self._rqn[i]:
            return []
        if self._cache_ok[i] and r < self._min_due[i]:
            return []
        live = [(s, m) for s, m in enumerate(self._rqmeta[i])
                if m is not None and m[0] <= r]
        if not live:
            self._refresh_shell(i)
            return []
        # stable by due round, append (seq) order within a round
        live.sort(key=lambda sm: (sm[1][0], sm[1][8]))
        for s, _ in live:
            self._rq_pop(i, s)
        self._cache_ok[i] = False
        return [m[1:8] for _, m in live]

    def drain_requeues(self, i, r) -> list:
        if not self._rqn[i]:
            return []
        live = [(s, m) for s, m in enumerate(self._rqmeta[i])
                if m is not None]
        live.sort(key=lambda sm: sm[1][8])      # append order
        for s, _ in live:
            self._rq_pop(i, s)
        self._cache_ok[i] = False
        return [(max(m[0], r),) + m[1:8] for _, m in live]

    # --- retry / redirect chains ----------------------------------------

    def _retry_slot(self, process) -> bool:
        # retry state attaches only to client processes (int worker ids
        # < C); the nemesis has no column
        return isinstance(process, int) and 0 <= process < self.C

    def attempt(self, i, process) -> int:
        if not self._retry_slot(process):
            return 0
        return int(self.attempt_col[i, process])

    def open_retry(self, i, process, attempt):
        self.attempt_col[i, process] = attempt
        self.open_col[i, process] = True

    def retry_is_open(self, i, process) -> bool:
        return self._retry_slot(process) \
            and bool(self.open_col[i, process])

    def close_retry(self, i, process):
        if self._retry_slot(process) and self.open_col[i, process]:
            self.attempt_col[i, process] = 0
            self.open_col[i, process] = False


class SessionView:
    """One shell's facade over the shared `ColumnarSessions` table: the
    operations `CoroutineSessions` has, delegated with the shell's row
    index. The dispatch loops hold one of these or a CoroutineSessions
    and never know which."""

    __slots__ = ("table", "i")

    def __init__(self, table: ColumnarSessions, i: int):
        self.table, self.i = table, i

    def register(self, mid, process, op, node, deadline):
        self.table.register(self.i, mid, process, op, node, deadline)

    def absorb_results(self, mids):
        return self.table.absorb_results(self.i, mids)

    def take_expired(self, r):
        return self.table.take_expired(self.i, r)

    def min_deadline(self):
        return self.table.min_deadline(self.i)

    def __len__(self):
        return len(self.table._slots[self.i])

    def __bool__(self):
        return bool(self.table._slots[self.i])

    def requeue(self, due, process, op, node, t, a, b, c):
        self.table.requeue(self.i, due, process, op, node, t, a, b, c)

    def has_requeue(self):
        return self.table.has_requeue(self.i)

    def requeue_min_due(self):
        return self.table.requeue_min_due(self.i)

    def take_due_requeues(self, r):
        return self.table.take_due_requeues(self.i, r)

    def drain_requeues(self, r):
        return self.table.drain_requeues(self.i, r)

    def attempt(self, process):
        return self.table.attempt(self.i, process)

    def open_retry(self, process, attempt):
        self.table.open_retry(self.i, process, attempt)

    def retry_is_open(self, process):
        return self.table.retry_is_open(self.i, process)

    def close_retry(self, process):
        self.table.close_retry(self.i, process)


SESSION_MODES = ("coroutine", "columnar")


def resolve_mode(test: dict) -> str:
    """The effective --sessions mode: an explicit choice sticks; None is
    columnar for a fleet, coroutine standalone (the backends give the
    same bytes)."""
    mode = test.get("sessions")
    if mode is None:
        return ("columnar" if int(test.get("fleet") or 1) > 1
                else "coroutine")
    mode = str(mode)
    if mode not in SESSION_MODES:
        raise ValueError(f"--sessions {mode!r}: expected one of "
                         f"{SESSION_MODES}")
    return mode


def make_sessions(test: dict, concurrency: int, device="cuda"):
    """A standalone runner's session backend (a fleet shares one
    ColumnarSessions table across its shells instead)."""
    if resolve_mode(test) == "columnar":
        return ColumnarSessions(1, concurrency, device=device).view(0)
    return CoroutineSessions()
