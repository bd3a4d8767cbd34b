"""Linearizability checking over pluggable models (the Knossos role).

A copy of `maelstrom_tpu/checkers/linearizable.py` (numpy only) without
the overlapped analysis pipeline's prebuilt partitions, which the port
does not run.

The reference checks lin-kv with jepsen.tests.linearizable-register —
per-key Knossos linearizability over independent keys
(`workload/lin_kv.clj:95-102`). Knossos itself checks *arbitrary*
models (knossos.model: register, cas-register, mutex, set, queue...);
this module implements the Wing & Gong / Lowe (WGL) algorithm with
memoization over (linearized-set, model-state) pairs, parameterized the
same way: a `Model` maps (state, op, outcome) to the possible successor
states.

  - ok ops must linearize with their observed results
  - info (indeterminate) ops may take effect at any point after their
    invocation, or never
  - fail ops definitely didn't happen and are excluded

The register model carries the production lin-kv path (histories are
partitioned by key — values are [k, v] tuples, mirroring
jepsen.independent — which keeps each search small); the other models
prove the engine's generality, pinned by the adversarial corpus.

At production scale the per-key search is P-compositional: the history
partitions by key with numpy group-bys over the columnar history
(`partition_register`), each partition runs a vectorized *screen*
(`screen_register_arrays`) — sound, never claims validity wrongly —
and only partitions the screen cannot decide fall back to the full WGL
search. Verdicts are bit-identical to the sequential path by
construction: the screen only ever emits the same `{"valid": True}`
the search would, and fallback partitions carry identical op lists.
"""

from __future__ import annotations

import numpy as np

from . import Checker
from ..history import FAIL, OK, TYPE_CODES, coerce_history

INF = float("inf")


class Model:
    """A sequential specification. States must be hashable (they key
    the WGL memo). `apply` returns every state the object could be in
    after linearizing op (f, value) with the given outcome — empty list
    means the op cannot linearize here. For ok ops `value` carries the
    observed result where the op has one (knossos.model/step's ops)."""

    initial = None

    def apply(self, state, f, value, ok: bool) -> list:
        raise NotImplementedError


class RegisterModel(Model):
    """read / write / cas register — jepsen's cas-register model."""

    initial = None

    def apply(self, state, f, value, ok):
        if f == "read":
            if ok:
                return [state] if state == value else []
            return [state]          # indeterminate read: no effect
        if f == "write":
            if ok:
                return [value]
            return [value, state]   # may or may not have happened
        if f == "cas":
            frm, to = value
            if ok:
                return [to] if state == frm else []
            if state == frm:
                return [to, state]
            return [state]
        raise ValueError(f"unknown register op {f!r}")


class MutexModel(Model):
    """acquire / release lock — knossos.model/mutex, holder-aware.
    State: None (free) or the holder id (`value`).

    Anonymous ops (value None) all share the sentinel holder True: in an
    ALL-anonymous history that reduces to knossos's holder-blind mutex
    (held/free), a documented degradation — any anonymous release can
    linearize against any anonymous acquire. What it must NOT do is let
    an anonymous release match a NAMED holder's acquire (that would
    "verify" a lock-stealing history), so mixing the two styles in one
    history raises instead of silently degrading."""

    initial = None

    def apply(self, state, f, value, ok):
        if value is None and state not in (None, True):
            raise ValueError(
                f"mutex history mixes anonymous ops (value None) with "
                f"named holders (current holder {state!r}): anonymous "
                f"identity cannot be checked against named acquires — "
                f"stamp every op's value with its holder (lin_mutex "
                f"does) or none of them")
        h = value if value is not None else True
        if f == "acquire":
            if ok:
                return [h] if state is None else []
            return [h, None] if state is None else [state]
        if f == "release":
            if ok:
                return [None] if state == h else []
            return [None, state] if state == h else [state]
        raise ValueError(f"unknown mutex op {f!r}")


class SetModel(Model):
    """Linearizable add / read set — knossos.model/set (NOT the CRDT
    g-set checker: a read must observe exactly the linearized set)."""

    initial = frozenset()

    def apply(self, state, f, value, ok):
        if f == "add":
            s2 = state | frozenset((value,))
            return [s2] if ok else [s2, state]
        if f == "read":
            if ok:
                return [state] if state == frozenset(value) else []
            return [state]
        raise ValueError(f"unknown set op {f!r}")


class QueueModel(Model):
    """FIFO enqueue / dequeue — knossos.model/unordered-queue's ordered
    sibling. State: tuple of pending values; a dequeue's observed value
    must be the head."""

    initial = ()

    def apply(self, state, f, value, ok):
        if f == "enqueue":
            s2 = state + (value,)
            return [s2] if ok else [s2, state]
        if f == "dequeue":
            if ok:
                return ([state[1:]] if state and state[0] == value
                        else [])
            return [state[1:], state] if state else [state]
        raise ValueError(f"unknown queue op {f!r}")


MODELS = {"register": RegisterModel, "mutex": MutexModel,
          "set": SetModel, "queue": QueueModel}


def check_history(ops, model: Model | None = None,
                  max_states: int = 5_000_000):
    """ops: [{f, value, inv, ret, ok}] with ret=INF for indeterminate ops.
    Returns {"valid": bool|"unknown", ...}.

    Just-in-time linearization (Lowe's WGL refinement, the Knossos-scale
    optimization): a configuration is (i, extra, state) where `i` is the
    invocation-order frontier (every op before it linearized) and
    `extra` the small set of ops linearized ahead of the frontier. The
    naive bitmask form keys its memo on an n-bit mask and scans all n
    ops per expansion — at n=600 it was already at its practical limit;
    this form's memo key and candidate scan are O(concurrent window)
    (bounded by worker count + open indeterminate ops), so histories of
    many thousands of ops check definitively in seconds."""
    model = model or RegisterModel()
    n = len(ops)
    if n == 0:
        return {"valid": True}
    order = sorted(range(n), key=lambda j: (ops[j]["inv"], ops[j]["ret"]))
    ops = [ops[j] for j in order]
    inv = [o["inv"] for o in ops]
    ret = [o["ret"] for o in ops]

    def norm(i, extra):
        while i < n and i in extra:
            extra = extra - frozenset((i,))
            i += 1
        return i, extra

    def candidates(i, extra):
        """Ops that may linearize next: scan forward from the frontier;
        op j is eligible unless some still-unlinearized op completed
        before j's invocation. Ops are invocation-sorted, so the running
        min-return gate is exact and the scan stops at the first op
        invoked after it (every later op is invoked later still)."""
        out = []
        m = INF
        j = i
        while j < n:
            if j in extra:
                j += 1
                continue
            if inv[j] > m:
                break
            out.append(j)
            if ret[j] < m:
                m = ret[j]
            j += 1
        return out

    seen = set()
    s0 = model.initial
    best = (0, frozenset(), s0)      # deepest configuration reached
    best_n = -1
    stack = [((0, frozenset(), s0), None)]
    while stack:
        (i, extra, state), it = stack.pop()
        if it is None:
            if i == n:
                return {"valid": True}
            key = (i, extra, state)
            if key in seen:
                continue
            seen.add(key)
            if i + len(extra) > best_n:
                best_n, best = i + len(extra), key
            if len(seen) > max_states:
                # structured "undecided": the search ran out of state
                # budget, it did NOT find a violation. Overlapped
                # screens and composed checkers defer on this shape
                # instead of special-casing an error string.
                return {"valid": "unknown",
                        "undecided": True,
                        "reason": "max-states",
                        "max-states": max_states,
                        "explored-configurations": len(seen),
                        "op-count": n,
                        "error": "WGL configuration cap exceeded"}
            it = iter([(j, s2) for j in candidates(i, extra)
                       for s2 in model.apply(state, ops[j]["f"],
                                             ops[j]["value"],
                                             ops[j]["ok"])])
        nxt = next(it, None)
        if nxt is None:
            continue
        j, s2 = nxt
        stack.append(((i, extra, state), it))
        stack.append((norm(i, extra | frozenset((j,))) + (s2,), None))
    # witness: the deepest frontier any linearization reached, and the
    # op stuck there (the Knossos-style "this op cannot linearize" line)
    bi, bextra, bstate = best
    stuck = next((ops[j] for j in range(bi, n) if j not in bextra), None)
    return {"valid": False,
            "explored-configurations": len(seen),
            "op-count": n,
            "linearized-prefix": best_n,
            "final-state": bstate,
            "stuck-op": None if stuck is None else
            {"f": stuck["f"], "value": stuck["value"],
             "ok": stuck["ok"], "inv": stuck["inv"],
             "ret": None if stuck["ret"] == INF else stuck["ret"]}}


# --- the vectorized register fast path ---

# f codes inside a register partition's arrays
F_READ, F_WRITE, F_CAS = 0, 1, 2
_F_NAMES = ("read", "write", "cas")


def screen_register_arrays(f, value, inv, ret, ok):
    """The P-composition fast screen for one key's partition, fully
    vectorized. Returns True when the partition is DEFINITELY
    linearizable, None when undecided (the caller falls back to WGL).

    The decidable class: every op ok, only reads and writes, and the
    ops totally ordered in real time (sorted by invocation, no op
    overlaps the next). Real time then admits exactly one linearization
    order — the sorted order — so the partition is linearizable iff a
    sequential replay succeeds: each read observes the latest earlier
    write (or the initial None). The replay is a forward-fill of write
    indices plus one elementwise compare. Sound by construction (a pass
    exhibits a witness order); ties or replay mismatches return None,
    never False, so WGL keeps sole authority over invalid verdicts."""
    n = len(inv)
    if n == 0:
        return True
    f = np.asarray(f)
    ok = np.asarray(ok)
    if not ok.all() or (f == F_CAS).any():
        return None
    order = np.argsort(inv, kind="stable")
    invs = np.asarray(inv, np.float64)[order]
    rets = np.asarray(ret, np.float64)[order]
    if n > 1 and (rets[:-1] > invs[1:]).any():
        return None                      # concurrency: needs the search
    fo = f[order]
    vo = np.asarray(value, object)[order]
    w = fo == F_WRITE
    last_w = np.maximum.accumulate(np.where(w, np.arange(n), -1))
    rpos = np.flatnonzero(~w)
    if rpos.size == 0:
        return True
    prev = last_w[rpos]
    expected = np.empty(rpos.size, object)
    has_w = prev >= 0
    expected[has_w] = vo[prev[has_w]]
    expected[~has_w] = None
    mismatch = vo[rpos] != expected      # object elementwise ==
    if np.any(mismatch):
        return None
    return True


def _screen_ops(ops):
    """Screen adapter for the stable dict-shaped entry point."""
    n = len(ops)
    fmap = {"read": F_READ, "write": F_WRITE, "cas": F_CAS}
    try:
        f = np.fromiter((fmap[o["f"]] for o in ops), np.int8, n)
    except KeyError:
        return None                      # unknown f: let WGL raise
    value = np.empty(n, object)
    value[:] = [o["value"] for o in ops]
    inv = np.fromiter((o["inv"] for o in ops), np.float64, n)
    ret = np.fromiter((o["ret"] for o in ops), np.float64, n)
    ok = np.fromiter((o["ok"] for o in ops), bool, n)
    return screen_register_arrays(f, value, inv, ret, ok)


def check_register_history(ops, max_states: int = 5_000_000,
                           screen: bool = True):
    """The register instance of `check_history` (production lin-kv
    path; kept as the stable entry point). Tries the vectorized screen
    first; only undecided histories pay for the search."""
    if screen and _screen_ops(ops) is True:
        return {"valid": True}
    return check_history(ops, RegisterModel(), max_states)


_is_kv_pair = np.frompyfunc(
    lambda v: isinstance(v, (list, tuple)) and len(v) == 2, 1, 1)
_kv_key = np.frompyfunc(lambda v: v[0], 1, 1)
_completed_value = np.frompyfunc(
    lambda iv, cv, ok: cv[1] if ok and cv is not None else iv[1], 3, 1)


def partition_register(history):
    """Columnar P-composition: partitions a history's register ops by
    key with numpy group-bys. Returns [(key, arrays)] sorted by
    repr(key), where arrays is {"f", "value", "inv", "ret", "ok"} numpy
    columns in invoke order — exactly the per-key op list the
    sequential path builds (fail completions dropped, indeterminate
    rets at +inf, observed read values substituted), without
    materializing one dict per op."""
    history = coerce_history(history)
    soa = history.soa()
    pi = history.pairs_index()
    if len(pi) == 0:
        return []
    inv_rows, comp_rows = pi[:, 0], pi[:, 1]

    # register invokes with well-formed [k, v] values
    fmap = np.full(len(soa.f_table), -1, np.int8)
    for code, name in enumerate(soa.f_table):
        if name in _F_NAMES:
            fmap[code] = _F_NAMES.index(name)
    f = fmap[soa.f[inv_rows]]
    ivals = soa.value[inv_rows]
    keep = (f >= 0) & _is_kv_pair(ivals).astype(bool)
    if not keep.any():
        return []
    inv_rows, comp_rows, f = inv_rows[keep], comp_rows[keep], f[keep]
    ivals = ivals[keep]

    # completion columns (sentinel row -1 reads row 0 then gets masked)
    has_comp = comp_rows >= 0
    safe = np.where(has_comp, comp_rows, 0)
    ctype = np.where(has_comp, soa.type[safe], -1)
    ok = ctype == TYPE_CODES[OK]
    cvals = np.where(has_comp, soa.value[safe], None)
    ret = np.where(ok, soa.time[safe].astype(np.float64), INF)
    inv = soa.time[inv_rows]
    value = _completed_value(ivals, cvals, ok)
    not_fail = ctype != TYPE_CODES[FAIL]

    # group by key (first-appearance interning keeps repr-ties in the
    # sequential path's insertion order)
    codes = {}
    kc = np.fromiter((codes.setdefault(k, len(codes))
                      for k in _kv_key(ivals)), np.int64, len(ivals))
    keys = list(codes)
    order = np.argsort(kc, kind="stable")     # stable: invoke order kept
    bounds = np.searchsorted(kc[order], np.arange(len(keys) + 1))
    parts = []
    for ki in range(len(keys)):
        rows = order[bounds[ki]:bounds[ki + 1]]
        rows = rows[not_fail[rows]]           # fail ops definitely absent
        parts.append((keys[ki], {
            "f": f[rows], "value": value[rows],
            "inv": inv[rows], "ret": ret[rows], "ok": ok[rows]}))
    parts.sort(key=lambda kv: repr(kv[0]))
    return parts


def ops_from_arrays(arrs) -> list[dict]:
    """Materializes one partition's dict-shaped op list for the WGL
    fallback — identical to what the sequential path would have built
    (ints for definite rets, so witnesses render identically)."""
    return [{"f": _F_NAMES[arrs["f"][i]], "value": arrs["value"][i],
             "inv": int(arrs["inv"][i]),
             "ret": int(arrs["ret"][i]) if arrs["ok"][i] else INF,
             "ok": bool(arrs["ok"][i])}
            for i in range(len(arrs["inv"]))]


class LinearizableRegisterChecker(Checker):
    """Per-key independent linearizable register checking
    (the jepsen.tests.linearizable-register equivalent). The default
    path partitions columnarly and screens each partition; pass
    opts={"no_fast": True} for the sequential pure-Python baseline
    (bench/verification use)."""

    name = "linear"

    def check(self, test, history, opts=None):
        opts = opts or {}
        history = coerce_history(history)
        if opts.get("no_fast"):
            return self._check_sequential(test, history, opts)
        parts = partition_register(history)
        results = {}
        failures = []
        for k, arrs in parts:
            screened = screen_register_arrays(
                arrs["f"], arrs["value"], arrs["inv"], arrs["ret"],
                arrs["ok"])
            r = ({"valid": True} if screened is True else
                 check_history(ops_from_arrays(arrs), RegisterModel()))
            results[str(k)] = r
            if r["valid"] is False:
                failures.append(k)
        return self._render(results, failures, len(parts))

    def _render(self, results, failures, key_count):
        valid = (False if failures else
                 ("unknown" if any(r["valid"] == "unknown"
                                   for r in results.values()) else True))
        out = {"valid": valid,
               "key-count": key_count,
               "failures": failures or None}
        if failures:
            # surface each failed key's witness (deepest linearizable
            # prefix + the op that cannot linearize) in the results file
            out["witnesses"] = {
                str(k): {kk: results[str(k)][kk]
                         for kk in ("linearized-prefix", "op-count",
                                    "final-state", "stuck-op")
                         if kk in results[str(k)]}
                for k in failures}
        return out

    def _check_sequential(self, test, history, opts=None):
        """The pre-columnar path: per-op Python partitioning + WGL on
        every key. Kept as the equivalence/bench baseline."""
        by_key: dict = {}
        for invoke, complete in history.pairs():
            if invoke.f not in ("read", "write", "cas"):
                continue
            if not isinstance(invoke.value, (list, tuple)) or \
                    len(invoke.value) != 2:
                continue
            k, v = invoke.value
            by_key.setdefault(k, []).append((invoke, complete))

        results = {}
        failures = []
        for k, kpairs in sorted(by_key.items(), key=lambda kv: repr(kv[0])):
            ops = []
            for invoke, complete in kpairs:
                if complete is not None and complete.is_fail():
                    continue
                ok = complete is not None and complete.is_ok()
                val = (complete.value[1] if ok and complete.value is not None
                       else invoke.value[1])
                ops.append({"f": invoke.f, "value": val,
                            "inv": invoke.time,
                            "ret": complete.time if ok else INF,
                            "ok": ok})
            r = check_history(ops, RegisterModel())
            results[str(k)] = r
            if r["valid"] is False:
                failures.append(k)
        return self._render(results, failures, len(by_key))
