"""Jepsen-style operation generators.

A copy of `maelstrom_tpu/generators.py`, cut to the combinators the
port's workloads, the nemesis schedules and the test's phase composition
use: `stagger`, `mix`, `each_thread`, `phases`, `Fn`, `Filter`,
`time_limit`, `sleep`, `Log`, `Seq` over a `cycle`, `Any2`, the client
and nemesis routing wrappers, and the leaf generators behind them
(`BatchCounting` among them: the distilled batches of
broadcast-batched), and the continuous mode's pre-scheduler
(`schedule_ahead`) and its columnar encode (`sched_columns`).
They are pure generators, as there:

  - result is an op dict   -> dispatch it (process/time filled in)
  - result is PENDING      -> nothing yet; ask again at ctx["time"] >=
                              the generator's next interesting time
  - result is None         -> exhausted forever

`update(ctx, event)` lets generators observe invocations/completions.
ctx is {"time": ns, "free": processes, "processes": processes}, where
"nemesis" is a special process; all others are client workers.

One change of representation, none of behaviour: ctx["free"] and
ctx["processes"] are ordered views that are iterated lazily (`Procs`,
and `FreeSet.rotated` for the runner's free workers), where the JAX
package builds lists. A test with 100,000 client workers emits 100,000
final reads in one pass, and building a 100,000-entry list for every op
made that pass quadratic. Each generator asks only for what it needs (the
first free process, whether any is left), in the order the lists had.
"""

from __future__ import annotations

import math
import random
from typing import Optional

PENDING = "pending"
NEMESIS = "nemesis"


class Procs:
    """An ordered view of processes, optionally filtered by `pred`,
    iterated lazily: `bool(view)` and `view[0]` look no further than the
    first match."""

    __slots__ = ("_base", "_pred")

    def __init__(self, base, pred=None):
        self._base = base
        self._pred = pred

    def __iter__(self):
        if self._pred is None:
            return iter(self._base)
        pred = self._pred
        return (p for p in self._base if pred(p))

    def __bool__(self):
        for _ in self:
            return True
        return False

    def __len__(self):
        # a full walk (lin-mutex's holder ids count the client processes)
        return sum(1 for _ in self)

    def __getitem__(self, i):
        if i != 0:
            raise IndexError("a process view only answers [0]")
        for p in self:
            return p
        raise IndexError("no process in view")


class FreeSet:
    """The runner's set of free processes. Besides set membership it
    answers "the j-th free process in str order" in O(log n) (a Fenwick
    tree over the processes ranked by `str`), so `rotated(k)` gives the
    first process of `rotate_free`'s list without sorting the set."""

    def __init__(self, processes):
        self._order = sorted(processes, key=str)
        self._rank = {p: i for i, p in enumerate(self._order)}
        self._tree = [0] * (len(self._order) + 1)
        self._members: set = set()
        self._size = len(self._order)
        self.version = 0
        self._log = 1 << max(self._size.bit_length() - 1, 0)

    def _bump(self, i, d):
        i += 1
        while i <= self._size:
            self._tree[i] += d
            i += i & -i

    def add(self, p):
        if p not in self._members:
            self._members.add(p)
            self._bump(self._rank[p], 1)
            self.version += 1

    def discard(self, p):
        if p in self._members:
            self._members.discard(p)
            self._bump(self._rank[p], -1)
            self.version += 1

    def __len__(self):
        return len(self._members)

    def copy(self) -> "FreeSet":
        out = FreeSet(self._order)
        for p in self._members:
            out.add(p)
        return out

    def _select(self, j: int) -> int:
        """Rank (in str order) of the j-th member, 0-based."""
        pos, rem, step = 0, j + 1, self._log
        while step:
            nxt = pos + step
            if nxt <= self._size and self._tree[nxt] < rem:
                pos = nxt
                rem -= self._tree[nxt]
            step >>= 1
        return pos

    def rotated(self, k: int) -> "Procs":
        """The free processes in str order, rotated to start at the
        (k mod n)-th: `rotate_free`'s list, as a lazy view. The view
        refuses to be read after the set changes."""
        n = len(self._members)
        if not n:
            return Procs(())
        return Procs(_Rotated(self, self._select(k % n)))


class _Rotated:
    """Iterates a FreeSet's members in str order from rank `start`,
    wrapping around."""

    __slots__ = ("fs", "start", "version")

    def __init__(self, fs: FreeSet, start: int):
        self.fs, self.start, self.version = fs, start, fs.version

    def __iter__(self):
        fs = self.fs
        if fs.version != self.version:
            raise RuntimeError("free set changed under its view")
        order, m = fs._order, fs._members
        for i in range(self.start, len(order)):
            if order[i] in m:
                yield order[i]
        for i in range(self.start):
            if order[i] in m:
                yield order[i]


def rotate_free(free: FreeSet, dispatch_count: int) -> Procs:
    """Rotates the sorted free-process list by a monotonically increasing
    dispatch counter so successive ops spread across workers — and
    therefore across nodes (worker i talks to node i % n). Leaf generators
    take free[0]; always offering the same first worker would starve every
    node but one of client traffic (fatal for e.g. a raft leader elsewhere).
    The counter must count dispatches, not history length: history grows by
    two per op (invoke + completion), which aliases even-sized pools.
    The list is sorted by `str`, as the JAX package sorts it."""
    return free.rotated(dispatch_count)


def client_processes(ctx):
    """Processes visible in this context. Routing to clients vs the nemesis
    is done by the OnProcesses wrappers (clients()/nemesis_gen()), so leaf
    generators simply take whatever the context offers."""
    return ctx["processes"]


def free_clients(ctx):
    return ctx["free"]


class Gen:
    def op(self, ctx):
        raise NotImplementedError

    def update(self, ctx, event):
        return self

    def next_interesting_time(self, ctx) -> float:
        """After this generator returned PENDING at ctx["time"]: the
        earliest ctx time (ns) at which it might produce an op *without any
        new completion event*, or +inf if only a completion (reply/timeout
        freeing a worker) can unblock it. Lets the runner scan many rounds
        in one dispatch, stopping exactly where the generator could next
        act. Returning a too-late time would delay ops (wrong); too-early
        merely costs a dispatch (safe). The inf default is correct for
        every generator that PENDs only for lack of free processes."""
        return math.inf


def fill_op(op: dict, ctx, process) -> dict:
    out = dict(op)
    out.setdefault("process", process)
    out["time"] = ctx["time"]
    out.setdefault("type", "invoke")
    return out


def to_gen(x) -> Optional[Gen]:
    """Checks that `x` is a generator (the JAX package also coerces maps
    and iterables, which no generator of this slice passes)."""
    if x is None or isinstance(x, Gen):
        return x
    raise TypeError(f"can't coerce {x!r} to a generator")


class cycle:
    """Endless iterator over a fixed element list (the nemesis on/off
    schedule feeds one to Seq)."""

    def __init__(self, elements, i: int = 0):
        self.elements = list(elements)
        self.i = i

    def __iter__(self):
        return self

    def __next__(self):
        x = self.elements[self.i % len(self.elements)]
        self.i += 1
        return x


class Seq(Gen):
    """Emits ops from an iterable, one per request. Elements may themselves
    be generators (e.g. the nemesis cycle interleaves Sleep gens with op
    maps); a nested generator runs until exhausted, then Seq advances."""

    def __init__(self, iterable):
        self.it = iter(iterable)
        self.head = None        # lookahead buffer (op map or nested Gen)

    def op(self, ctx):
        while True:
            if self.head is None:
                try:
                    self.head = next(self.it)
                except StopIteration:
                    return None, self
            h = self.head
            if isinstance(h, Gen) or callable(h) or not isinstance(h, dict):
                sub = to_gen(h)
                res, sub2 = sub.op(ctx)
                if res is None:
                    self.head = None    # nested gen exhausted: next element
                    continue
                self.head = sub2        # keep successor state
                return res, self
            free = free_clients(ctx)
            if not free:
                return PENDING, self
            self.head = None
            return fill_op(h, ctx, free[0]), self

    def next_interesting_time(self, ctx) -> float:
        if isinstance(self.head, Gen):
            return self.head.next_interesting_time(ctx)
        return math.inf


class Fn(Gen):
    """Calls a zero-arg function to produce each op map (the lin-kv
    workload's `KVOpGen`; the reference's `(fn [] ...)` generators)."""

    def __init__(self, f):
        self.f = f

    def op(self, ctx):
        free = free_clients(ctx)
        if not free:
            return PENDING, self
        op_map = self.f()
        if op_map is None:
            return None, self
        return fill_op(op_map, ctx, free[0]), self


class Counting(Gen):
    """Emits {"f": f, "value": 0}, {"f": f, "value": 1}, ... (reference
    `broadcast.clj:229-233`)."""

    def __init__(self, f: str, n: int = 0):
        self.f = f
        self.n = n

    def op(self, ctx):
        free = free_clients(ctx)
        if not free:
            return PENDING, self
        op_map = {"f": self.f, "value": self.n}
        return fill_op(op_map, ctx, free[0]), Counting(self.f, self.n + 1)


class BatchCounting(Gen):
    """Columnar distilled-batch assembly (doc/perf.md "batched atomic
    broadcast"): each emission is ONE `broadcast-batch` op whose value
    is a distilled batch — up to `batch_max` fresh sequential client
    values plus a seeded fraction of duplicate re-submissions, deduped
    and sorted by the batcher before the op leaves.

    The assembly is numpy-columnar: the raw submission buffer is an
    int array and distillation is one `np.unique` — no per-value Python
    dict churn — and one generator poll (one host-loop iteration, one
    pending-table entry, one wire message) now covers a whole batch of
    client values instead of one. At `--fleet` scale this is the host
    bookkeeping lever ROADMAP flags: per-cluster generator cost scales
    with batches, not ops.

    Like Stagger/MixG, successor states share the mutable RNG; draws
    happen only on actual emission (PENDING polls are rng-neutral), so
    the scan-ahead and per-round paths see identical op streams."""

    def __init__(self, f: str = "broadcast-batch", batch_max: int = 16,
                 dup_rate: float = 0.25, seed: int = 0,
                 next_value: int = 0, rng=None):
        import numpy as np
        self.f = f
        self.batch_max = max(1, int(batch_max))
        self.dup_rate = float(dup_rate)
        self.next_value = next_value
        self.rng = rng if rng is not None else np.random.RandomState(
            seed & 0x7FFFFFFF)

    def op(self, ctx):
        import numpy as np
        free = free_clients(ctx)
        if not free:
            return PENDING, self
        b = int(self.rng.randint(1, self.batch_max + 1))
        fresh = np.arange(self.next_value, self.next_value + b,
                          dtype=np.int64)
        # seeded duplicate submissions FROM THIS batch: the raw stream a
        # real client fleet offers is at-least-once, and distillation is
        # what collapses it (Chop Chop's dedup half)
        n_dup = int(self.rng.binomial(b, self.dup_rate))
        raw = fresh if not n_dup else np.concatenate(
            [fresh, self.rng.choice(fresh, size=n_dup)])
        distilled = np.unique(raw)          # dedup + sort, one pass
        op_map = {"f": self.f, "value": [int(v) for v in distilled],
                  "raw-count": int(raw.size)}
        nxt = BatchCounting(self.f, self.batch_max, self.dup_rate,
                            next_value=self.next_value + b, rng=self.rng)
        return fill_op(op_map, ctx, free[0]), nxt


class Repeat(Gen):
    def __init__(self, op_map: dict):
        self.op_map = op_map

    def op(self, ctx):
        free = free_clients(ctx)
        if not free:
            return PENDING, self
        return fill_op(self.op_map, ctx, free[0]), self


class Filter(Gen):
    """Keeps only ops matching pred (jepsen gen/filter; used by g-counter
    to drop negative deltas, reference `g_counter.clj:30-40`)."""

    def __init__(self, pred, gen):
        self.pred = pred
        self.gen = to_gen(gen)

    def op(self, ctx):
        g = self.gen
        for _ in range(10000):
            res, g = g.op(ctx)
            if res is None or res == PENDING:
                return res, Filter(self.pred, g)
            if self.pred(res):
                return res, Filter(self.pred, g)
        raise RuntimeError("gen/filter: no matching op in 10000 tries")

    def update(self, ctx, event):
        return Filter(self.pred, self.gen.update(ctx, event))

    def next_interesting_time(self, ctx) -> float:
        return self.gen.next_interesting_time(ctx)


class EachThread(Gen):
    """Emits the op once on every client process
    (jepsen gen/each-thread; used for final reads,
    reference `broadcast.clj:239`). Successor states share one `done`
    set, as Stagger/MixG successors share their RNG: a state is never
    polled again once it has emitted, and copying the set for every op
    was quadratic in the worker count."""

    def __init__(self, op_map: dict, done: set | None = None):
        self.op_map = op_map
        self.done = set() if done is None else done

    def op(self, ctx):
        done = self.done
        p = next((q for q in free_clients(ctx) if q not in done), None)
        if p is None:
            if all(q in done for q in client_processes(ctx)):
                return None, self
            return PENDING, self
        done.add(p)
        return fill_op(self.op_map, ctx, p), EachThread(self.op_map, done)


class TimeLimit(Gen):
    """Stops emitting after dt_ns of ctx time (jepsen gen/time-limit,
    reference `core.clj:62`)."""

    def __init__(self, dt_ns: int, gen, t0: int | None = None):
        self.dt_ns = dt_ns
        self.gen = to_gen(gen)
        self.t0 = t0

    def op(self, ctx):
        t0 = ctx["time"] if self.t0 is None else self.t0
        if ctx["time"] - t0 >= self.dt_ns:
            return None, self
        res, g2 = self.gen.op(ctx)
        return res, TimeLimit(self.dt_ns, g2, t0)

    def update(self, ctx, event):
        return TimeLimit(self.dt_ns, self.gen.update(ctx, event), self.t0)

    def next_interesting_time(self, ctx) -> float:
        t0 = ctx["time"] if self.t0 is None else self.t0
        if ctx["time"] - t0 >= self.dt_ns:
            return math.inf     # already exhausted: nothing more, ever
        # expiry matters: it exhausts this gen, which can advance Phases
        return min(self.gen.next_interesting_time(ctx), t0 + self.dt_ns)


class Stagger(Gen):
    """Rate limiting: introduces random delays averaging dt between ops
    (jepsen gen/stagger; reference `core.clj:59` uses (stagger (/ rate)))."""

    def __init__(self, dt_ns: float, gen, next_time: float | None = None,
                 rng: random.Random | None = None):
        self.dt_ns = dt_ns
        self.gen = to_gen(gen)
        self.next_time = next_time
        self.rng = rng or random.Random(1)

    def op(self, ctx):
        t = ctx["time"]
        nt = t if self.next_time is None else self.next_time
        if t < nt:
            return PENDING, self
        res, g2 = self.gen.op(ctx)
        if res is None or res == PENDING:
            return res, Stagger(self.dt_ns, g2, nt, self.rng)
        # schedule next emission: uniform in [0, 2*dt] after this one
        nt2 = nt + self.rng.uniform(0, 2 * self.dt_ns)
        return res, Stagger(self.dt_ns, g2, nt2, self.rng)

    def update(self, ctx, event):
        return Stagger(self.dt_ns, self.gen.update(ctx, event),
                       self.next_time, self.rng)

    def next_interesting_time(self, ctx) -> float:
        if self.next_time is not None and ctx["time"] < self.next_time:
            return self.next_time
        return self.gen.next_interesting_time(ctx)


class Sleep(Gen):
    """Emits nothing for dt, then is exhausted (jepsen gen/sleep,
    reference `core.clj:69`)."""

    def __init__(self, dt_ns: int, t0: int | None = None):
        self.dt_ns = dt_ns
        self.t0 = t0

    def op(self, ctx):
        t0 = ctx["time"] if self.t0 is None else self.t0
        if self.t0 is None:
            return PENDING, Sleep(self.dt_ns, ctx["time"])
        if ctx["time"] - t0 >= self.dt_ns:
            return None, self
        return PENDING, self

    def next_interesting_time(self, ctx) -> float:
        t0 = ctx["time"] if self.t0 is None else self.t0
        return t0 + self.dt_ns


class Log(Gen):
    """Logs a message once, emits no ops (jepsen gen/log,
    reference `core.clj:68`)."""

    def __init__(self, message: str, done: bool = False):
        self.message = message
        self.done = done

    def op(self, ctx):
        if not self.done:
            import logging
            logging.getLogger("maelstrom").info(self.message)
            self.done = True    # mutate: callers may re-poll the same node
        return None, Log(self.message, True)


class Phases(Gen):
    """Runs generators in sequence; a phase must be exhausted AND all its
    ops completed (every process free) before the next phase starts
    (jepsen gen/phases, reference `core.clj:66-71`)."""

    def __init__(self, *gens):
        self.gens = [to_gen(g) for g in gens if g is not None]

    def op(self, ctx):
        if not self.gens:
            return None, self
        res, g2 = self.gens[0].op(ctx)
        if res is None:
            # phase exhausted; wait for quiescence before advancing
            if set(ctx["free"]) >= set(ctx["processes"]):
                nxt = Phases(*self.gens[1:])
                if not nxt.gens:
                    return None, nxt
                return nxt.op(ctx)
            rest = Phases()
            rest.gens = [g2] + self.gens[1:]
            return PENDING, rest
        p = Phases()
        p.gens = [g2] + self.gens[1:]
        return res, p

    def update(self, ctx, event):
        if not self.gens:
            return self
        p = Phases()
        p.gens = [self.gens[0].update(ctx, event)] + self.gens[1:]
        return p

    def next_interesting_time(self, ctx) -> float:
        # Advancement past an exhausted phase requires quiescence (a
        # completion event), so the current phase alone bounds the time.
        if not self.gens:
            return math.inf
        return self.gens[0].next_interesting_time(ctx)


class OnProcesses(Gen):
    """Restricts a generator to a subset of processes. The basis for
    gen/clients (client processes only) and gen/nemesis (the nemesis
    process), reference `core.clj:60,67,70`."""

    def __init__(self, pred, gen):
        self.pred = pred
        self.gen = to_gen(gen)

    def op(self, ctx):
        sub = dict(ctx)
        sub["free"] = Procs(ctx["free"], self.pred)
        sub["processes"] = Procs(ctx["processes"], self.pred)
        if not sub["processes"]:
            return None, self
        res, g2 = self.gen.op(sub)
        return res, OnProcesses(self.pred, g2)

    def update(self, ctx, event):
        return OnProcesses(self.pred, self.gen.update(ctx, event))

    def next_interesting_time(self, ctx) -> float:
        return self.gen.next_interesting_time(ctx)


class _NotNemesis:
    """Picklable predicate: client processes only."""

    def __call__(self, p):
        return p != NEMESIS


class _IsNemesis:
    def __call__(self, p):
        return p == NEMESIS


def clients(gen):
    return OnProcesses(_NotNemesis(), gen)


def nemesis_gen(gen):
    return OnProcesses(_IsNemesis(), gen)


class Any2(Gen):
    """Interleaves two generators: each request tries both, preferring
    whichever has an op ready (used to run nemesis alongside clients,
    like jepsen's `gen/nemesis` wrapping in `core.clj:60-61`)."""

    def __init__(self, a, b):
        self.a = to_gen(a)
        self.b = to_gen(b)

    def op(self, ctx):
        res_a, a2 = self.a.op(ctx) if self.a else (None, None)
        if res_a not in (None, PENDING):
            return res_a, Any2(a2, self.b)
        res_b, b2 = self.b.op(ctx) if self.b else (None, None)
        if res_b not in (None, PENDING):
            return res_b, Any2(a2 if self.a else None, b2)
        if res_a is None and res_b is None:
            return None, self
        return PENDING, Any2(a2 if self.a else None, b2 if self.b else None)

    def update(self, ctx, event):
        return Any2(self.a.update(ctx, event) if self.a else None,
                    self.b.update(ctx, event) if self.b else None)

    def next_interesting_time(self, ctx) -> float:
        return min(self.a.next_interesting_time(ctx) if self.a else math.inf,
                   self.b.next_interesting_time(ctx) if self.b else math.inf)


def nemesis_wrap(nemesis_g, client_g):
    """Clients run client_g; the nemesis process runs nemesis_g
    (jepsen gen/nemesis with two args)."""
    if nemesis_g is None:
        return clients(client_g)
    return Any2(nemesis_gen(nemesis_g), clients(client_g))


class MixG(Gen):
    """Random mixture of generators (clean implementation)."""

    def __init__(self, gens, rng: random.Random | None = None):
        self.gens = [to_gen(g) for g in gens]
        self.rng = rng or random.Random(0)

    def op(self, ctx):
        # Fruitless polls must be rng-neutral: the scan-ahead fast path
        # polls once per *dispatch* while the per-round path polls once per
        # *round*, and any draw consumed on a PENDING poll would make their
        # op streams diverge (breaking scan/per-round equivalence and
        # deterministic resume). Child successor states from fruitless
        # polls are already discarded below for the same reason.
        st = self.rng.getstate()
        live = list(range(len(self.gens)))
        pending = False
        while live:
            j = self.rng.randrange(len(live))
            i = live[j]
            res, g2 = self.gens[i].op(ctx)
            if res is None:
                live.pop(j)
                continue
            if res == PENDING:
                pending = True
                live.pop(j)
                continue
            gens2 = list(self.gens)
            gens2[i] = g2
            return res, MixG(gens2, self.rng)
        self.rng.setstate(st)
        return (PENDING if pending else None), self

    def next_interesting_time(self, ctx) -> float:
        return min((gen.next_interesting_time(ctx) for gen in self.gens),
                   default=math.inf)


def mix(gens, rng=None):
    return MixG(gens, rng)


def stagger(dt_seconds: float, gen, rng=None):
    return Stagger(dt_seconds * 1e9, gen, rng=rng)


def time_limit(seconds: float, gen):
    return TimeLimit(int(seconds * 1e9), gen)


def sleep(seconds: float):
    return Sleep(int(seconds * 1e9))


def each_thread(op_map: dict):
    return EachThread(op_map)


def phases(*gens):
    return Phases(*gens)


def sched_columns(rows, r0: int, q: int, n_nodes: int) -> dict:
    """The numpy-columnar encode of pre-scheduled injection rows: `rows`
    is the continuous loop's list of (round, process, op, node_idx, t,
    a, b, c) and the result the [q] columns the sched-inject scan takes:
    `at` (window offsets from r0, -1 on padding), `valid` and the wire
    fields src / dest / type / a / b / c."""
    import numpy as np
    m = len(rows)
    if m > q:
        raise ValueError(f"{m} scheduled rows exceed the {q}-row "
                         f"inject batch")
    at = np.full(q, -1, np.int32)
    valid = np.zeros(q, bool)
    src, dest, typ, a, b, c = (np.zeros(q, np.int32) for _ in range(6))
    if m:
        cols = np.asarray([(rw[0], rw[1], rw[3], rw[4], rw[5], rw[6],
                            rw[7]) for rw in rows], np.int64).T
        at[:m] = cols[0] - r0
        valid[:m] = True
        src[:m] = cols[1] + n_nodes
        dest[:m] = cols[2]
        typ[:m] = cols[3]
        a[:m] = cols[4]
        b[:m] = cols[5]
        c[:m] = cols[6]
    return {"at": at, "valid": valid, "src": src, "dest": dest,
            "type": typ, "a": a, "b": b, "c": c}


def schedule_ahead(gen, processes, free, r0: int, horizon_r: int,
                   ns_per_round: float, dispatch_count: int):
    """The continuous mode's pre-scheduler: polls `gen` forward through
    virtual time (no round runs) and collects the client ops it emits,
    each stamped with the round it is due, so that one scan can inject
    them at their rounds inside the window [r0, horizon_r).

    Time follows the generator's `next_interesting_time`: PENDING with a
    finite next time jumps the virtual clock there (at least one round),
    PENDING with +inf ends the window ("starved": only a completion can
    unblock it). An emitted op reserves its worker for the rest of the
    window. A NEMESIS op ends the window at its round (returned for
    immediate execution when it is due at r0 before any client op).
    Generators share mutable RNGs between successor states, so the
    caller executes or carries everything returned.

    Returns (gen', events [(round, op)] in round order, nem (round, op)
    or None, end_r, end_kind: "horizon" | "starved" | "exhausted" |
    "nemesis")."""
    free = free.copy()
    events: list = []
    r_v = r0
    while True:
        ctx = {"time": int(r_v * ns_per_round),
               "free": rotate_free(free, dispatch_count),
               "processes": processes}
        res, gen = gen.op(ctx)
        if res is None:
            return gen, events, None, horizon_r, "exhausted"
        if res == PENDING:
            nt = gen.next_interesting_time(ctx)
            if nt == math.inf:
                return gen, events, None, horizon_r, "starved"
            nr = int(math.ceil(nt / ns_per_round))
            if nr <= r_v:
                nr = r_v + 1
            if nr >= horizon_r:
                return gen, events, None, horizon_r, "horizon"
            r_v = nr
            continue
        if res["process"] == NEMESIS:
            return gen, events, (r_v, res), max(r_v, r0), "nemesis"
        free.discard(res["process"])
        dispatch_count += 1
        events.append((r_v, res))
