"""Kafka-style replicated-log checker (the kafka workload;
jepsen.tests.kafka's core invariants), for both protocol modes.

A copy of the post-hoc half of `maelstrom_tpu/checkers/kafka.py`
(`_commit_shape`, `extract_observation`, `grade`, `KafkaChecker.check`);
its incremental `KafkaStreamObserver` serves the overlapped analysis
pipeline, which the port does not run yet.

Classic (full-prefix polls, `kafka_groups` unset):
  send ok:   [key, msg, offset]
  poll ok:   {key: [[offset, msg], ...]}    (full prefix from offset 0)
  commit ok: {key: offset}
  list ok:   {key: offset}

Streaming (consumer groups, `kafka_groups` > 0):
  poll ok:   {key: [[offset, msg], ...]}    (cursor fetch: a contiguous
                                             run from the member's
                                             cursor, not a prefix)
  commit ok: {"group": g, "offsets": {key: offset}}
  list ok:   {"group": g, "offsets": {key: offset}}
  subscribe ok / rebalanced fails constrain nothing.

Checked invariants:
  1. **No divergence**: (key, offset) maps to one msg across every ok
     send and every poll observation, ever.
  2. **Order**: classic polls are strictly increasing full prefixes;
     streaming fetches are contiguous ascending runs.
  3. **No lost writes**: classic, a send acked at offset o must appear
     in every poll that begins after the ack completes and reads past a
     hole at o; streaming, an acked offset never observed while polls
     beginning after the ack observe later offsets of its key is lost.
  4. **Committed-offset monotonicity**, per (group, key): a `list` that
     begins after a commit (or an earlier list) completed must report at
     least that offset.

Indeterminate (`info`) ops constrain nothing; `fail` ops (misrouted,
fenced commits) definitely did not happen."""

from __future__ import annotations

from . import Checker
from ..history import coerce_history


def _commit_shape(v: dict):
    """(group_or_None, {key: offset}) from a commit/list ok value —
    streaming values are {"group": g, "offsets": {...}}, classic ones
    are the flat offsets map."""
    if "offsets" in v and "group" in v:
        # `keys` (banked wide-key lists, nodes/kafka.py key_count > 4)
        # declares which keys the observation covers: a committed key
        # OUTSIDE the declared scope is unobserved, not regressed.
        # None = the observation covers every key (all pre-bank values).
        scope = (frozenset(str(k) for k in v["keys"])
                 if "keys" in v else None)
        return (int(v["group"]),
                {str(k): int(o) for k, o in v["offsets"].items()},
                scope)
    return None, {str(k): int(o) for k, o in v.items()}, None


def extract_observation(invoke, complete):
    """One (invoke, completion-or-None) pair -> a compact observation
    tuple, or None when the pair constrains nothing (unpaired, info,
    fail, malformed). Pure; shared by the post-hoc and windowed paths.

      ("send", ack_time, key, offset, msg)
      ("poll", invoke_time, {key: [[offset, msg], ...]})
      ("commit", complete_time, group_or_None, {key: offset})
      ("list", invoke_time, complete_time, group_or_None, {key: offset},
       scope_or_None)

    `scope` (streaming lists only) is the frozenset of key names the
    observation covers — banked wide-key lists read one 4-key window
    per RPC (see `_commit_shape`); None covers every key.
    """
    if complete is None or not complete.is_ok():
        return None
    f = invoke.f
    v = complete.value
    if f == "send":
        k, m, o = v
        return ("send", complete.time, str(k), int(o), m)
    if f == "poll" and isinstance(v, dict):
        return ("poll", invoke.time, v)
    if f == "commit" and isinstance(v, dict):
        grp, offs, _scope = _commit_shape(v)
        return ("commit", complete.time, grp, offs)
    if f == "list" and isinstance(v, dict):
        grp, offs, scope = _commit_shape(v)
        return ("list", invoke.time, complete.time, grp, offs, scope)
    return None


def grade(observations, streaming: bool = False) -> dict:
    """Folds observation records IN INVOKE ORDER into the whole-history
    verdict — the single grading implementation behind both checker
    paths (bit-equality of the windowed path is by construction)."""
    assign: dict = {}        # (key, offset) -> msg (first observer)
    divergent = []
    order_violations = []
    lost = []
    commit_regressions = []

    def observe(k, o, m, where):
        cur = assign.get((k, o))
        if cur is None:
            assign[(k, o)] = m
        elif cur != m:
            divergent.append({"key": k, "offset": o,
                              "values": [cur, m], "in": where})

    acked_sends = []         # (ack_time, key, offset, msg)
    polls = []               # (invoke_time, {key: [[o, m], ...]})
    commits = []             # (complete_time, group, {key: offset})
    lists = []               # (inv_t, complete_t, group, {key: offset})

    for rec in observations:
        tag = rec[0]
        if tag == "send":
            _, t, k, o, m = rec
            observe(k, o, m, "send_ok")
            acked_sends.append((t, k, o, m))
        elif tag == "poll":
            _, inv_t, value = rec
            polls.append((inv_t, value))
            for k, pairs in value.items():
                if streaming:
                    # cursor-fetch contract: one CONTIGUOUS ascending
                    # run (the server slices [start, start+n))
                    last = None
                    for o, m in pairs:
                        if last is not None and int(o) != last + 1:
                            order_violations.append(
                                {"key": k, "offsets": [last, int(o)],
                                 "error": "fetch entries must be "
                                          "contiguous"})
                        last = int(o)
                        observe(str(k), int(o), m, "poll_ok")
                else:
                    if pairs and int(pairs[0][0]) != 0:
                        order_violations.append(
                            {"key": k, "head-offset": int(pairs[0][0]),
                             "error": "full-prefix poll must start "
                                      "at offset 0"})
                    last = -1
                    for o, m in pairs:
                        if int(o) <= last:
                            order_violations.append(
                                {"key": k, "offsets": [last, int(o)]})
                        last = int(o)
                        observe(str(k), int(o), m, "poll_ok")
        elif tag == "commit":
            _, t, grp, offs = rec
            commits.append((t, grp, offs))
        else:   # list
            _, inv_t, t, grp, offs, scope = rec
            lists.append((inv_t, t, grp, offs, scope))

    # 3. lost writes.
    if streaming:
        # Consumers advance contiguous per-group cursors from the log
        # head, so the union of observed offsets per key has no holes on
        # a correct server. An acked offset never observed while a poll
        # that BEGAN after the ack observed a later offset of the same
        # key marks a loss (the cursor stream read past it).
        union: dict = {}         # key -> set of observed offsets
        per_key_polls: dict = {}  # key -> [(inv_t, max observed o)]
        for inv_t, value in polls:
            for k, pairs in value.items():
                if not pairs:
                    continue
                offs = {int(p[0]) for p in pairs}
                union.setdefault(str(k), set()).update(offs)
                per_key_polls.setdefault(str(k), []).append(
                    (inv_t, max(offs)))
        for ack_t, k, o, m in acked_sends:
            if o in union.get(k, ()):
                continue
            later = [mx for t2, mx in per_key_polls.get(k, ())
                     if t2 > ack_t and mx > o]
            if later:
                lost.append({"key": k, "offset": o, "msg": m,
                             "poll-max-offset": max(later)})
    else:
        # Polls are full prefixes, so a poll's "holes" (offsets below
        # its max that it does NOT contain) are the only places a loss
        # can show — and a correct server has none, which makes this
        # sweep effectively linear.
        holes_by_key: dict = {}  # key -> [(poll_t, max_o, holes set)]
        for poll_t, value in polls:
            for k, pairs in value.items():
                if not pairs:
                    continue
                offsets = {int(p[0]) for p in pairs}
                max_o = max(offsets)
                holes = set(range(max_o + 1)) - offsets
                if holes:
                    holes_by_key.setdefault(str(k), []).append(
                        (poll_t, max_o, holes))
        for ack_t, k, o, m in acked_sends:
            for poll_t, max_o, holes in holes_by_key.get(k, ()):
                if poll_t > ack_t and o in holes:
                    lost.append({"key": k, "offset": o, "msg": m,
                                 "poll-max-offset": max_o})
                    break

    # 4. the stored committed mark only advances, per (group, key):
    # every list that BEGAN after a commit (or an earlier list)
    # COMPLETED must observe at least that offset. One time-sorted sweep
    # with running per-(group, key) floors; at equal timestamps checks
    # run before floor-raises (lenient toward concurrency).
    events = ([(c_t, 1, None, offs, grp, None)
               for c_t, grp, offs in commits]
              + [(c2, 1, None, offs, grp, None)
                 for _i, c2, grp, offs, _s in lists]
              + [(li_inv, 0, offs, None, grp, scope)
                 for li_inv, _c, grp, offs, scope in lists])
    floor: dict = {}             # (group, key) -> offset
    for _t, _kind, check_offs, raise_offs, grp, scope in sorted(
            events, key=lambda e: (e[0], e[1])):
        if check_offs is not None:
            for (g2, k), lo in floor.items():
                if g2 != grp:
                    continue
                if scope is not None and k not in scope:
                    continue    # banked list: key outside its window
                if check_offs.get(k, -1) < lo:
                    rec = {"key": k, "committed": lo,
                           "observed": check_offs.get(k, -1)}
                    if g2 is not None:
                        rec["group"] = g2
                    commit_regressions.append(rec)
        else:
            for k, o in raise_offs.items():
                key = (grp, k)
                floor[key] = max(floor.get(key, -1), o)

    problems = {}
    if divergent:
        problems["divergent"] = divergent[:16]
    if order_violations:
        problems["poll-order"] = order_violations[:16]
    if lost:
        problems["lost-writes"] = lost[:16]
    if commit_regressions:
        problems["commit-regressions"] = commit_regressions[:16]
    out = {
        "valid": not problems,
        "acked-sends": len(acked_sends),
        "polls": len(polls),
        "distinct-offsets": len(assign),
    }
    out.update(problems)
    # a run with no certifiable observations can't certify anything
    # — but found anomalies always dominate (false beats unknown)
    if not problems and not acked_sends and not polls and not lists:
        out["valid"] = "unknown"
        out["error"] = ("no certifiable kafka observation (send/poll/"
                        "list) ever succeeded")
    return out


class KafkaChecker(Checker):
    name = "kafka"

    def check(self, test, history, opts=None):
        streaming = bool(test.get("kafka_groups")) \
            if isinstance(test, dict) else False
        history = coerce_history(history)
        obs = [extract_observation(i, c) for i, c in history.pairs()]
        return grade([r for r in obs if r is not None], streaming)
