"""Transactional read/write-register checker — the *observable subset*
of Elle's rw-register analysis, honestly scoped.

A copy of `maelstrom_tpu/checkers/txn_rw_register.py`.

List-append reveals the full version order of every key (an observed
list names all its predecessors), which is why `checkers/elle.py` can
build ww/wr/rw edges and classify the whole anomaly zoo. A bare
register read reveals only WHICH write it observed — not where that
write sits among the others — so this checker proves exactly what the
observations support and documents what they cannot:

Detected (each with a witness):
  - **internal**: within one transaction, a read of k after the
    transaction's own write of k must observe its latest own write;
  - **G1a** (aborted read): a read observing a value whose writing
    transaction definitely failed;
  - **G1b** (intermediate read): a read observing a value the writer
    overwrote within its own transaction (visible because the workload
    generator never reuses a (key, value) pair);
  - **cyclic information flow**: cycles in wr ∪ realtime edges — a
    transaction chain where each link either read the previous link's
    write or started after it completed, closing on itself. This is
    the G1c-with-realtime family restated over observable edges.

NOT detected (requires version-order inference a register read cannot
provide): pure write-write cycles (G0) and anti-dependency cycles
(G-single/G2, e.g. write skew). Runs needing those guarantees should
use the list-append workload, whose checker sees them.

Assumes the workload's generator contract: every ok/indeterminate
write of a key carries a value never written to that key by any other
transaction (`workloads/txn_rw_register.py` uses per-key counters). A
violation of the contract itself is reported as `duplicate-writes`.
"""

from __future__ import annotations

from . import Checker
from ..history import coerce_history


class RWRegisterChecker(Checker):
    name = "txn-rw-register"

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        txns = []      # (idx, invoke_time, complete_time, micro_ops, ok)
        failed_writes = {}      # (k, v) -> txn index (definite fails)
        writer_of = {}          # (k, v) -> txn index (ok/info writers)
        duplicate_writes = []
        internal = []
        g1a = []
        g1b = []

        for invoke, complete in history.pairs():
            if invoke.f != "txn":
                continue
            if complete is not None and complete.is_fail():
                for f, k, v in invoke.value or ():
                    if f == "w":
                        failed_writes[(str(k), repr(v))] = (k, v)
                continue
            ok = complete is not None and complete.is_ok()
            value = complete.value if ok else invoke.value
            idx = len(txns)
            txns.append((idx, invoke.time,
                         complete.time if ok else None,
                         [list(m) for m in (value or ())], ok))
            for f, k, v in value or ():
                if f == "w":
                    key = (str(k), repr(v))
                    if key in writer_of:
                        duplicate_writes.append(
                            {"key": k, "value": v,
                             "txns": [writer_of[key], idx]})
                    writer_of[key] = idx

        # a (key, value) written by both a definitely-failed txn and an
        # ok/info txn is the generator contract broken, not an aborted
        # read — report it as duplicate-writes so a read of that value
        # isn't mislabeled G1a
        for key in sorted(set(failed_writes) & set(writer_of)):
            k, v = failed_writes[key]
            duplicate_writes.append(
                {"key": k, "value": v,
                 "txns": [writer_of[key]],
                 "also-failed-writer": True})
            del failed_writes[key]

        # last own write per key per txn (for internal + G1b)
        final_write = {}        # txn idx -> {k: v}
        for idx, _i, _c, mops, _ok in txns:
            own: dict = {}
            for f, k, v in mops:
                if f == "w":
                    own[str(k)] = v
            final_write[idx] = own

        wr_edges = set()
        for idx, _i, _c, mops, ok in txns:
            if not ok:
                continue
            own_so_far: dict = {}
            for f, k, v in mops:
                k = str(k)
                if f == "w":
                    own_so_far[k] = v
                    continue
                if k in own_so_far:
                    if repr(v) != repr(own_so_far[k]):
                        internal.append({"txn": idx, "key": k,
                                         "expected": own_so_far[k],
                                         "observed": v})
                    continue
                if v is None:
                    continue                     # initial state
                key = (k, repr(v))
                if key in failed_writes:
                    g1a.append({"txn": idx, "key": k, "value": v})
                    continue
                w = writer_of.get(key)
                if w is None:
                    continue   # written by an unobserved (pending) txn
                if repr(final_write[w].get(k)) != repr(v):
                    g1b.append({"txn": idx, "key": k, "value": v,
                                "writer": w})
                if w != idx:
                    wr_edges.add((w, idx))

        # realtime edges via barrier chaining (the same closure-
        # preserving compression elle.py uses): each ok txn points at
        # the barrier for its completion time, barriers chain forward,
        # and the latest barrier before a txn's invocation points at
        # it — t1 reaches t2 through barriers iff ret(t1) < inv(t2)
        import bisect
        ok_txns = sorted((t for t in txns if t[4] and t[2] is not None),
                         key=lambda t: t[2])
        barrier_times = [t[2] for t in ok_txns]
        rt_edges = set()
        for i in range(len(ok_txns) - 1):
            rt_edges.add((("b", i), ("b", i + 1)))
        for i, t in enumerate(ok_txns):
            rt_edges.add((t[0], ("b", i)))
        for t in ok_txns:
            j = bisect.bisect_left(barrier_times, t[1]) - 1
            if j >= 0:
                rt_edges.add((("b", j), t[0]))

        # Tarjan over wr + realtime
        edges = wr_edges | rt_edges
        adj: dict = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
        index = {}
        low = {}
        stack = []
        on_stack = set()
        sccs = []
        counter = [0]

        def strongconnect(v):
            work = [(v, 0)]
            while work:
                node, pi = work.pop()
                if pi == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                recurse = False
                for j in range(pi, len(adj.get(node, []))):
                    w = adj[node][j]
                    if w not in index:
                        work.append((node, j + 1))
                        work.append((w, 0))
                        recurse = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if recurse:
                    continue
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        sccs.append(scc)     # mixed txn/barrier nodes
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])

        for node in list(adj):
            if node not in index:
                strongconnect(node)

        # report only the transaction members of each cycle (barrier
        # nodes are plumbing); an SCC of barriers alone is impossible
        # (the barrier chain is acyclic)
        cycles = []
        for scc in sccs:
            members = [x for x in scc if not isinstance(x, tuple)]
            if len(members) < 2:
                continue      # a lone txn cycling through barriers
                #               would mean ret(t) < inv(t): impossible
            sset = set(scc)
            cycles.append({
                "txns": sorted(members),
                "wr-edges": sorted((a, b) for a, b in wr_edges
                                   if a in sset and b in sset),
                "via-realtime": any(isinstance(x, tuple) for x in scc)})

        problems = {}
        if internal:
            problems["internal"] = internal[:16]
        if g1a:
            problems["G1a"] = g1a[:16]
        if g1b:
            problems["G1b"] = g1b[:16]
        if cycles:
            problems["cycles"] = cycles[:8]
        if duplicate_writes:
            problems["duplicate-writes"] = duplicate_writes[:16]
        out = {
            "valid": not problems,
            "txn-count": len(txns),
            "ok-count": sum(1 for t in txns if t[4]),
            "wr-edge-count": len(wr_edges),
            "not-checked": ["G0", "G-single", "G2 (write skew)"],
        }
        out.update(problems)
        if not any(t[4] for t in txns):
            if problems:
                pass                      # anomalies dominate
            else:
                out["valid"] = "unknown"
                out["error"] = "no transaction ever completed ok"
        return out
