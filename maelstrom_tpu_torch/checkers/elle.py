"""Elle-lite: transactional consistency checking for list-append workloads.

A copy of `maelstrom_tpu/checkers/elle.py` without the overlapped
analysis pipeline's stream observer (`ElleStreamObserver`,
`make_stream_observer`), which the port does not run: the checker grades
post hoc. Its device path (`elle_device`) runs on the test's device
(`test["device"]`): kernels K16 and K17 on the card, their plain
versions on the CPU.

The reference delegates txn-list-append checking to Elle via
jepsen.tests.cycle.append (`workload/txn_list_append.clj:112-124`), checking
up to strict serializability. This is a from-scratch implementation of the
core of Elle's list-append analysis:

1. Per key, infer the version order from the longest observed list; every
   read must be a *prefix* of it (list semantics), else `incompatible-order`.
2. Direct anomalies: G1a (aborted read: observing a value whose append
   failed), G1b (intermediate read: observing a state mid-transaction),
   duplicate elements; cyclic-version-order (the union of all observed
   adjacencies for a key contains a cycle — reads imply contradictory
   version orders, beyond a mere prefix fork); lost-update (two
   transactions load the same version of a key — a read in the same
   transaction, own appends stripped — and both append to it; flagged
   even when no later read ever observes the colliding appends, the
   case the dependency graph alone cannot see); internal (a read
   disagreeing with the transaction's own earlier appends); fuzzy-read
   (Adya P2: two reads in one transaction revealing different
   pre-states — legal at read-committed, fatal at serializable).
3. Dependency graph over transactions: ww (version succession), wr (read
   observes a version), rw (anti-dependency: read of v precedes writer of
   v+1), plus rt (real-time) edges for strict serializability.
4. Cycle detection via Tarjan SCC; cycles are classified G0 (write cycle),
   G1c (ww/wr cycle), G-single (one rw edge), G2 (multiple rw edges,
   some pair adjacent in the witness cycle), G-nonadjacent (multiple rw
   edges, no two adjacent — the shape that additionally violates
   snapshot isolation, per Cerone-Gotsman's adjacent-rw criterion).

Consistency models map to which anomalies are violations:
  read-uncommitted:    G0, dirty reads of aborted state (G1a)
  read-committed:      + G1b, G1c
  serializable:        + G-single, G2 (ignoring rt edges)
  strict-serializable: + the same over the graph including rt edges
"""

from __future__ import annotations

import numpy as np

from . import Checker
from ..history import coerce_history

MODELS = ["read-uncommitted", "read-committed", "serializable",
          "strict-serializable"]


def _txn_ops(history):
    """Extracts transactions: [{id, txn (completed micro-ops), ok, invoke,
    complete}]. fail txns definitely didn't execute; info txns may have."""
    txns = []
    for invoke, complete in history.pairs():
        if invoke.f != "txn":
            continue
        if complete is not None and complete.is_fail():
            continue
        ok = complete is not None and complete.is_ok()
        micro = (complete.value if ok else invoke.value) or []
        txns.append({"id": len(txns), "micro": micro, "ok": ok,
                     "inv": invoke.time,
                     "ret": complete.time if ok else float("inf")})
    return txns


def _fail_appends(history):
    out = set()
    for invoke, complete in history.pairs():
        if invoke.f != "txn" or complete is None or not complete.is_fail():
            continue
        for f, k, v in invoke.value or []:
            if f == "append":
                out.add((_hk(k), _hv(v)))
    return out


def _digraph_cycle(g: dict):
    """One cycle in {node: set(succ)} as a closed node list, or None.
    Iterative coloring DFS (histories can be deep)."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in g}
    for root in sorted(g):
        if color[root] != WHITE:
            continue
        path = []
        stack = [(root, iter(sorted(g.get(root, ()))))]
        color[root] = GRAY
        path.append(root)
        while stack:
            node, it = stack[-1]
            for w in it:
                c = color.get(w, WHITE)
                if c == GRAY:
                    return path[path.index(w):] + [w]
                if c == WHITE:
                    color[w] = GRAY
                    path.append(w)
                    stack.append((w, iter(sorted(g.get(w, ())))))
                    break
            else:
                color[node] = BLACK
                path.pop()
                stack.pop()
    return None


def _hk(k):
    return repr(k)


def _hv(v):
    return repr(v)


def _edges_python(txns, longest, appender):
    """Reference (pre-vectorization) dependency-edge construction:
    nested Python loops over every read. Kept as the equivalence oracle
    and the checker-throughput bench baseline."""
    edges: set = set()

    def version_writer(kk, idx):
        if idx <= 0 or idx > len(longest.get(kk, [])):
            return None
        return appender.get((kk, longest[kk][idx - 1]))

    for kk, order in longest.items():
        for i in range(1, len(order)):
            a, b = appender.get((kk, order[i - 1])), \
                appender.get((kk, order[i]))
            if a is not None and b is not None and a != b:
                # same-txn multi-appends don't create edges
                edges.add((a, b, "ww"))

    for t in txns:
        if not t["ok"]:
            continue
        for f, k, v in t["micro"]:
            if f != "r" or not isinstance(v, list):
                continue
            kk = _hk(k)
            n = len(v)
            if n > 0:
                w = version_writer(kk, n)
                if w is not None and w != t["id"]:
                    edges.add((w, t["id"], "wr"))
            nxt = version_writer(kk, n + 1)
            if nxt is not None and nxt != t["id"]:
                edges.add((t["id"], nxt, "rw"))
    return edges


def _edges_vectorized(txns, longest, appender):
    """ww/wr/rw dependency edges from sorted index arrays: per-key
    version orders concatenate into one writer table (offsets +
    gathers), ww edges are the consecutive-writer pairs inside each
    key's span, and each read's wr/rw edges are two table gathers at
    positions offset+n-1 / offset+n. One Python pass flattens reads to
    arrays; everything after is numpy. Produces the identical edge set
    to `_edges_python` (pinned by tests)."""
    edges: set = set()
    keys = list(longest)
    key_idx = {kk: i for i, kk in enumerate(keys)}
    nk = len(keys)
    lens = np.fromiter((len(longest[kk]) for kk in keys), np.int64, nk)
    offsets = np.zeros(nk + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    writers = np.fromiter(
        (appender.get((kk, v), -1)
         for kk in keys for v in longest[kk]),
        np.int64, int(offsets[-1]))

    if len(writers) > 1:
        a, b = writers[:-1], writers[1:]
        same_key = np.ones(len(writers) - 1, bool)
        same_key[offsets[1:-1] - 1] = False     # pairs spanning two keys
        m = same_key & (a >= 0) & (b >= 0) & (a != b)
        edges.update(zip(a[m].tolist(), b[m].tolist(),
                         ("ww",) * int(m.sum())))

    r_tid, r_key, r_n = [], [], []
    for t in txns:
        if not t["ok"]:
            continue
        for f, k, v in t["micro"]:
            if f == "r" and isinstance(v, list):
                r_tid.append(t["id"])
                r_key.append(key_idx.get(_hk(k), -1))
                r_n.append(len(v))
    if r_tid and nk:        # no keyed versions -> no read edges exist
        tid = np.asarray(r_tid, np.int64)
        ki = np.asarray(r_key, np.int64)
        n_ = np.asarray(r_n, np.int64)
        ks = np.maximum(ki, 0)
        # wr: the writer of the version this read observed (its length)
        has = (ki >= 0) & (n_ > 0)
        w = np.full(len(tid), -1, np.int64)
        w[has] = writers[offsets[ks[has]] + n_[has] - 1]
        m = (w >= 0) & (w != tid)
        edges.update(zip(w[m].tolist(), tid[m].tolist(),
                         ("wr",) * int(m.sum())))
        # rw anti-dependency: the writer of the NEXT version
        can = (ki >= 0) & (n_ < lens[ks])
        nxt = np.full(len(tid), -1, np.int64)
        nxt[can] = writers[offsets[ks[can]] + n_[can]]
        m = (nxt >= 0) & (nxt != tid)
        edges.update(zip(tid[m].tolist(), nxt[m].tolist(),
                         ("rw",) * int(m.sum())))
    return edges


def analyze(history, *, edges_impl=None, device=None,
            torch_device="cuda") -> dict:
    history = coerce_history(history)
    return analyze_txns(_txn_ops(history), _fail_appends(history),
                        edges_impl=edges_impl, device=device,
                        torch_device=torch_device)


def analyze_txns(txns, failed_appends, *, edges_impl=None, device=None,
                 columns=None, transfer=None, report=None,
                 torch_device="cuda") -> dict:
    """The anomaly analysis over a pre-extracted transaction set
    (`_txn_ops`-shaped dicts + the failed-append set). `analyze` wraps
    it for plain histories.

    `device` selects the device-resident path: "on"/"off"/"auto" (None
    = auto). When it engages, ww/wr/rw edge construction runs on
    `torch_device` (`checkers/elle_device.py`, K16, bit-equal to
    `_edges_vectorized`) and a cycle screen there (K17) certifies
    acyclic dependency graphs: a definite pass that skips Tarjan
    entirely; any undecided graph falls back to the host
    Tarjan/classification path on the identical edge set, so verdicts
    are bit-equal by construction. `columns` optionally carries a
    prebuilt read table; `transfer` books device wall time and reads
    into the runner's TransferStats; `report` (a dict) receives the
    deterministic device stats block."""
    anomalies: dict[str, list] = {}

    def add_anom(kind, item):
        anomalies.setdefault(kind, []).append(item)

    # appender[(k, v)] = txn id; per-txn appends per key (order within txn)
    appender: dict = {}
    txn_appends: dict = {}      # txn id -> {key: [values]}
    for t in txns:
        per_key = {}
        for f, k, v in t["micro"]:
            if f == "append":
                kk, vv = _hk(k), _hv(v)
                if (kk, vv) in appender:
                    add_anom("duplicate-appends", {"key": k, "value": v})
                appender[(kk, vv)] = t["id"]
                per_key.setdefault(kk, []).append(vv)
        txn_appends[t["id"]] = per_key

    # Longest observed list per key = version order; reads must be prefixes.
    longest: dict = {}
    for t in txns:
        if not t["ok"]:
            continue
        for f, k, v in t["micro"]:
            if f == "r" and isinstance(v, list):
                kk = _hk(k)
                vv = [_hv(x) for x in v]
                if len(vv) > len(longest.get(kk, [])):
                    longest[kk] = vv

    for t in txns:
        if not t["ok"]:
            continue
        for f, k, v in t["micro"]:
            if f != "r" or not isinstance(v, list):
                continue
            kk = _hk(k)
            vv = [_hv(x) for x in v]
            if longest.get(kk, [])[:len(vv)] != vv:
                add_anom("incompatible-order",
                         {"key": k, "read": v, "longest": longest.get(kk)})
            for x, xv in zip(v, vv):
                if (kk, xv) in failed_appends:
                    add_anom("G1a", {"key": k, "value": x,
                                     "txn": t["micro"]})
                elif (kk, xv) not in appender:
                    add_anom("phantom-element", {"key": k, "value": x})
            # G1b: observed the middle of another txn's appends to this key
            writers_in_order = [appender.get((kk, xv)) for xv in vv]
            if writers_in_order:
                last_writer = writers_in_order[-1]
                if last_writer is not None and last_writer != t["id"]:
                    w_appends = txn_appends[last_writer].get(kk, [])
                    if w_appends and vv[-1] != w_appends[-1]:
                        add_anom("G1b", {"key": k, "read": v,
                                         "writer-appends": w_appends})

    # --- internal consistency: within one transaction, a read of k
    # after the transaction's own appends to k must observe those
    # appends, in order, as the list's suffix (the txn is one atomic
    # point: it sees the pre-state plus its own writes so far). Elle's
    # :internal anomaly class.
    # Two rules: (a) own appends so far must be the read's suffix; (b)
    # the pre-state a read reveals (the read minus that suffix) must
    # match what the txn's FIRST read of the key revealed — a txn whose
    # later read shows a different pre-state watched other commits move
    # underneath it mid-transaction.
    for t in txns:
        if not t["ok"]:
            continue
        own_sofar: dict = {}
        pre_seen: dict = {}            # kk -> pre-state from first read
        for f, k, v in t["micro"]:
            kk = _hk(k)
            if f == "append":
                own_sofar.setdefault(kk, []).append(_hv(v))
            elif f == "r" and isinstance(v, list):
                mine = own_sofar.get(kk, [])
                vv = [_hv(x) for x in v]
                if mine and vv[-len(mine):] != mine:
                    add_anom("internal",
                             {"txn": t["id"], "key": k, "read": v,
                              "own-appends": list(mine)})
                    continue
                # a later read revealing a DIFFERENT pre-state than the
                # first is Adya's P2 (fuzzy / non-repeatable read) — a
                # distinct anomaly, legal at read-committed and below,
                # NOT an internal-atomicity break
                pre = vv[:len(vv) - len(mine)] if mine else vv
                if kk in pre_seen and pre_seen[kk] != pre:
                    add_anom("fuzzy-read",
                             {"txn": t["id"], "key": k, "read": v,
                              "first-pre-state": pre_seen[kk],
                              "later-pre-state": pre})
                pre_seen.setdefault(kk, pre)

    # --- cyclic version order: union the adjacencies every observed
    # read asserts for a key; a cycle means no version order can satisfy
    # all reads (a fork is merely incompatible-order; this is stronger)
    vgraph: dict = {}                 # kk -> {a: set of b with a < b}
    raw_key: dict = {}                # kk -> original key object
    raw_val: dict = {}                # (kk, vv) -> original value
    for t in txns:
        if not t["ok"]:
            continue
        for f, k, v in t["micro"]:
            if f == "r" and isinstance(v, list):
                kk = _hk(k)
                raw_key[kk] = k
                vv = [_hv(x) for x in v]
                for x, xv in zip(v, vv):
                    raw_val[(kk, xv)] = x
                g = vgraph.setdefault(kk, {})
                for a, b in zip(vv, vv[1:]):
                    g.setdefault(a, set()).add(b)
    for kk, g in vgraph.items():
        cyc = _digraph_cycle(g)
        if cyc is not None:
            add_anom("cyclic-version-order",
                     {"key": raw_key[kk],
                      "cycle": [raw_val.get((kk, n), n) for n in cyc]})

    # --- lost update: transactions that loaded the SAME version of a
    # key (a read in the same txn; the txn's own tail appends stripped,
    # so a post-append read still reveals the loaded state) and both
    # appended to it. Both cannot serialize after the state they read,
    # so one update is lost. Detected directly from the loads because
    # the colliding appends may never be observed by any later read —
    # the one anomaly here the dependency graph cannot express.
    lu_groups: dict = {}   # (kk, loaded-tuple) -> [txn ids], raw witness
    for t in txns:
        if not t["ok"]:
            continue
        own: dict = {}                # kk -> own values appended so far
        loaded: dict = {}             # kk -> first loaded version
        for f, k, v in t["micro"]:
            kk = _hk(k)
            if f == "append":
                own.setdefault(kk, []).append(_hv(v))
            elif f == "r" and isinstance(v, list) and kk not in loaded:
                vv = [_hv(x) for x in v]
                raw = list(v)
                mine = own.get(kk, [])
                if mine and vv[-len(mine):] == mine:
                    vv, raw = vv[:len(vv) - len(mine)], \
                        raw[:len(raw) - len(mine)]
                loaded[kk] = (tuple(vv), k, raw)
        for kk in own:
            if kk in loaded:
                vv, k, raw = loaded[kk]
                ids, _k, _raw = lu_groups.setdefault(
                    (kk, vv), ([], k, raw))
                ids.append(t["id"])
    for (kk, _vv), (ids, k, raw) in sorted(lu_groups.items()):
        if len(ids) > 1:
            add_anom("lost-update",
                     {"key": k, "loaded": raw, "txns": ids})

    # --- dependency graph ---
    # Realtime structure first (shared by the device screen and the host
    # barrier construction): ok txns in completion order, plus each
    # txn's latest-completion-strictly-before-invocation index — one
    # batched searchsorted over the ret-sorted completion times.
    ok_txns = sorted((t for t in txns if t["ok"]), key=lambda t: t["ret"])
    m = len(ok_txns)
    rets = np.fromiter((t["ret"] for t in ok_txns), np.float64, m)
    invs = np.fromiter((t["inv"] for t in ok_txns), np.float64, m)
    before = np.searchsorted(rets, invs, side="left") - 1

    # Device path: edge construction (K16) + the on-device cycle screen
    # (K17). The screen is sound
    # one-way — "acyclic" is a definite pass that skips Tarjan; any
    # undecided graph falls through to the host walk over the IDENTICAL
    # edge set, so verdicts stay bit-equal by construction.
    from . import elle_device as _device
    dev = None
    if edges_impl is None and _device.resolve(device, len(txns)):
        ok_tids = np.fromiter((t["id"] for t in ok_txns), np.int64, m)
        dev = _device.run(txns, longest, appender, _hk, columns=columns,
                          rt=(ok_tids, before), transfer=transfer,
                          device=torch_device)
    if report is not None and dev is not None:
        report.update(dev.report())

    # edges: (src, dst, kind) with kind in ww/wr/rw, built from sorted
    # index arrays (`_edges_vectorized`) or fetched off the device
    # arrays; tests/benches inject `_edges_python` to pin equivalence /
    # measure the speedup. Materialized lazily: a screened-acyclic run
    # never builds the Python edge set at all.
    _edge_cache: list = []

    def edge_set() -> set:
        if not _edge_cache:
            if dev is not None:
                _edge_cache.append(dev.edge_set())
            else:
                _edge_cache.append((edges_impl or _edges_vectorized)(
                    txns, longest, appender))
        return _edge_cache[0]

    # Real-time edges via a barrier chain rather than the O(n^2) transitive
    # closure: each txn points at the barrier for its completion time;
    # barriers chain forward; each txn is pointed at by the latest barrier
    # before its invocation. t1 reaches t2 through barriers iff
    # ret(t1) < inv(t2), preserving exactly the realtime cycles. Built
    # only when the screen did not already certify the combined graph.
    def realtime_edges() -> set:
        rt_edges = set()
        for i in range(len(ok_txns) - 1):
            rt_edges.add((("b", i), ("b", i + 1), "rt"))
        for i, t in enumerate(ok_txns):
            rt_edges.add((t["id"], ("b", i), "rt"))
        for i in np.flatnonzero(before >= 0):
            rt_edges.add((("b", int(before[i])), ok_txns[i]["id"], "rt"))
        return rt_edges

    def cycles_with(edge_set):
        """Tarjan SCC; returns list of cycles (as lists of txn ids)."""
        adj: dict = {}
        for a, b, kind in edge_set:
            adj.setdefault(a, set()).add(b)
        index = {}
        low = {}
        onstack = set()
        stack = []
        sccs = []
        counter = [0]

        def strongconnect(v):
            work = [(v, iter(sorted(adj.get(v, ()), key=repr)))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            onstack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        onstack.add(w)
                        work.append((w, iter(sorted(adj.get(w, ()), key=repr))))
                        advanced = True
                        break
                    elif w in onstack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        onstack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        sccs.append(scc)

        for v in list(adj):
            if v not in index:
                strongconnect(v)
        return sccs

    def txn_ids(scc):
        return sorted(x for x in scc if not isinstance(x, tuple))

    txn_by_id = {t["id"]: t for t in txns}
    _KIND_PRIO = {"rw": 0, "wr": 1, "ww": 2, "rt": 3}

    def _scc_graph(scc, edge_set):
        ids = set(scc)
        adj: dict = {}
        kinds: dict = {}
        for a, b, k in edge_set:
            if a in ids and b in ids:
                adj.setdefault(a, []).append(b)
                # prefer data edges over rt when parallel edges exist
                if (a, b) not in kinds or _KIND_PRIO[k] < _KIND_PRIO[
                        kinds[(a, b)]]:
                    kinds[(a, b)] = k
        return adj, kinds

    def _render(cyc, kinds):
        """cyc is a closed node list (first == last). Rotates it to start
        at a transaction node, then collapses runs of realtime barrier
        hops into single '-[rt]->' steps. Returns (text, ops, kinds)."""
        body = cyc[:-1]
        start = next(i for i, x in enumerate(body)
                     if not isinstance(x, tuple))
        body = body[start:] + body[:start]
        cyc = body + [body[0]]
        steps = []
        last_txn = cyc[0]
        via_rt = False
        for u, v in zip(cyc, cyc[1:]):
            if isinstance(v, tuple):
                via_rt = True
                continue
            kind = "rt" if via_rt else kinds[(u, v)]
            steps.append((last_txn, v, kind))
            last_txn, via_rt = v, False
        text = "  ".join(f"T{a} -[{k}]-> T{b}" for a, b, k in steps)
        ops = {f"T{i}": txn_by_id[i]["micro"]
               for i in txn_ids(cyc) if i in txn_by_id}
        return text, ops, [k for _a, _b, k in steps]

    def explain(scc, edge_set):
        """Renders one concrete cycle through the SCC, Elle-style:
        'T1 -[ww]-> T2 -[rw]-> T1', plus each txn's micro-ops — the
        human-readable evidence for the anomaly. The walk prefers rw >
        wr > ww > rt edges so the rarest dependency kinds (the ones that
        drive the classification) appear in the witness. The caller
        classifies the *rendered* cycle, so the label always matches the
        evidence."""
        adj, kinds = _scc_graph(scc, edge_set)

        def choice_key(u):
            def key(v):
                return (_KIND_PRIO[kinds[(u, v)]], repr(v))
            return key

        # greedy walk until a node repeats: yields a simple cycle
        cur = next((x for x in scc if not isinstance(x, tuple)), scc[0])
        path, seen = [cur], {cur: 0}
        while True:
            cur = sorted(adj[cur], key=choice_key(cur))[0]
            if cur in seen:
                cyc = path[seen[cur]:] + [cur]
                break
            seen[cur] = len(path)
            path.append(cur)
        return _render(cyc, kinds)

    def explain_realtime(scc, edge_set):
        """A witness for a realtime anomaly must actually traverse an rt
        edge; the greedy walk can close a pure data subcycle instead (an
        SCC may contain both). Anchor on an rt edge inside the SCC and
        close the cycle with a BFS path back to its tail — guaranteed to
        exist since the SCC is strongly connected. Returns None when the
        SCC has no rt edge at all."""
        adj, kinds = _scc_graph(scc, edge_set)
        anchor = next(((a, b) for (a, b), k in kinds.items()
                       if k == "rt"), None)
        if anchor is None:
            return None
        a, b = anchor
        # BFS shortest path b -> a
        from collections import deque
        prev = {b: None}
        q = deque([b])
        while q:
            u = q.popleft()
            if u == a:
                break
            for v in sorted(adj.get(u, ()), key=repr):
                if v not in prev:
                    prev[v] = u
                    q.append(v)
        # reconstruct b..a then orient as a -> b -> ... -> a
        back = [a]
        u = a
        while u != b:
            u = prev[u]
            back.append(u)
        back.reverse()                      # b ... a
        cyc = [a] + back                    # a -> b -> ... -> a
        return _render(cyc, kinds)

    def classify_steps(kinds_used):
        inner = set(kinds_used) - {"rt"}
        if inner <= {"ww"}:
            return "G0"
        if inner <= {"ww", "wr"}:
            return "G1c"
        rw = sum(1 for k in kinds_used if k == "rw")
        if rw == 1:
            return "G-single"
        # the witness cycle's steps, cyclically: two rw edges in a row
        # is plain G2; none adjacent anywhere is the shape that also
        # breaks snapshot isolation (every SI-legal cycle has an
        # adjacent rw pair) — report the stronger label. Only claimed
        # for pure data cycles: a cycle that needs an rt hop to close
        # is not an SI-graph cycle, so the SI assertion would overstate
        # the evidence
        if "rt" not in kinds_used:
            n = len(kinds_used)
            adjacent = any(kinds_used[i] == "rw"
                           and kinds_used[(i + 1) % n] == "rw"
                           for i in range(n))
            if not adjacent:
                return "G-nonadjacent"
        return "G2"

    # The screen's "acyclic" is definite: a Tarjan pass over the same
    # graph would find zero multi-node SCCs, so skipping it preserves
    # bit-equal verdicts. An undecided screen (or no device) walks the
    # host path unchanged.
    if dev is not None and dev.data_acyclic:
        base_sccs = []
    else:
        base_sccs = cycles_with(edge_set())
    for scc in base_sccs:
        text, ops, kinds_used = explain(scc, edge_set())
        add_anom(classify_steps(kinds_used),
                 {"txns": txn_ids(scc), "cycle": text, "txn-ops": ops})
    base_cycle_ids = {frozenset(txn_ids(s)) for s in base_sccs}
    if not (dev is not None and dev.full_acyclic):
        combined = edge_set() | realtime_edges()
        for scc in cycles_with(combined):
            if frozenset(txn_ids(scc)) not in base_cycle_ids:
                rendered = explain_realtime(scc, combined)
                if rendered is None:
                    # no rt edge in the SCC: it's a data anomaly whose
                    # SCC boundary merely shifted; the base pass covers
                    # its cycles
                    continue
                text, ops, kinds_used = rendered
                add_anom(classify_steps(kinds_used) + "-realtime",
                         {"txns": txn_ids(scc), "cycle": text,
                          "txn-ops": ops})

    return anomalies


ILLEGAL = {
    # cyclic-version-order is a data-integrity contradiction (no version
    # order exists at all), illegal under every model, like
    # incompatible-order; lost-update is permitted at read-committed
    # (Adya P4 is only proscribed from cursor stability up), so it
    # gates the serializable models only
    "read-uncommitted": {"G0", "G1a", "duplicate-appends",
                         "incompatible-order", "phantom-element",
                         "cyclic-version-order", "internal"},
    "read-committed": {"G0", "G1a", "G1b", "G1c", "duplicate-appends",
                       "incompatible-order", "phantom-element",
                       "cyclic-version-order", "internal"},
    # fuzzy-read (Adya P2) is legal at read-committed and below
    "serializable": {"G0", "G1a", "G1b", "G1c", "G-single", "G2",
                     "G-nonadjacent", "lost-update", "fuzzy-read",
                     "duplicate-appends", "incompatible-order",
                     "phantom-element", "cyclic-version-order", "internal"},
    "strict-serializable": {"G0", "G1a", "G1b", "G1c", "G-single", "G2",
                            "G-nonadjacent", "lost-update", "fuzzy-read",
                            "G0-realtime", "G1c-realtime",
                            "G-single-realtime", "G2-realtime",
                            "G-nonadjacent-realtime",
                            "duplicate-appends", "incompatible-order",
                            "phantom-element", "cyclic-version-order", "internal"},
}


class ElleListAppendChecker(Checker):
    """Grades a txn-list-append history under the given consistency
    models. The device path (`--device-checker`) runs on the test's
    device (`test["device"]`, the card unless the run names the CPU)."""

    name = "elle"

    def __init__(self, consistency_models=("strict-serializable",),
                 device=None):
        self.models = list(consistency_models)
        self.device = device

    def _mode(self, test):
        if self.device is not None:
            return self.device
        return (test or {}).get("device_checker") \
            if isinstance(test, dict) else None

    def check(self, test, history, opts=None):
        opts = opts or {}
        mode = opts.get("device_checker", self._mode(test))
        test = test if isinstance(test, dict) else {}
        report: dict = {}
        history = coerce_history(history)
        anomalies = analyze_txns(_txn_ops(history), _fail_appends(history),
                                 device=mode, transfer=test.get("transfer"),
                                 report=report,
                                 torch_device=test.get("device") or "cuda")
        illegal = set()
        for m in self.models:
            illegal |= ILLEGAL.get(m, ILLEGAL["strict-serializable"])
        found = {k: v for k, v in anomalies.items() if k in illegal}
        out = {"valid": not found,
               "anomaly-types": sorted(anomalies),
               "anomalies": found or None,
               "models-checked": self.models}
        if report:
            out["device"] = report
        return out
