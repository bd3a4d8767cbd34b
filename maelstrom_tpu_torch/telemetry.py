"""The flight recorder: a device-resident metric ring folded inside every
round, host phase spans, and the streaming telemetry record.

Counterpart of `maelstrom_tpu/telemetry.py`, in three layers:

  1. **The metric ring** (`MetricRing`, `SimState.telemetry`): an int32
     block folded at the end of every round (`ring_update`): the
     round's message-flow deltas (sent / delivered / dropped /
     duplicated), flight-pool and edge-channel occupancy histograms and
     maxima, per-role node sends, and client-op latency in rounds (a
     log2 histogram, its count and sum). It rides the runner's existing
     packed fetch a dispatch, and never touches a key or a message, so
     a run's history is byte-identical with the ring on or off. The fold
     is kernel K19 (`csrc/telemetry.cu`) on the card, its plain version
     `ring_update_plain` on the CPU.

  2. **Host phase spans** (`TelemetrySession.span`): the runner's
     schedule-encode, dispatch and device-get phases as Chrome trace
     events, written to `trace.json`.

  3. **The stream** (`TelemetrySession.wave` / `flush`): one
     `telemetry.jsonl` record a window and a final one: windowed and
     cumulative exact latency quantiles (`Sketch`), offered and
     delivered rates, ring deltas; `render_top` is the `top` view.

Everything here is observational: nothing in it changes scheduling, a
random draw or the history."""

from __future__ import annotations

import json
import math
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import kernels as K
from .net.tpu import I32, wrap_i32
from .tree import Struct

# bucket counts are static (they size the ring): occupancy by eighths of
# capacity, latency by powers of two in rounds (bucket b covers
# (2^(b-1), 2^b] rounds; bucket 0 is <= 1)
OCC_BUCKETS = 8
LAT_BUCKETS = 16
# role slices the kernel keeps in shared memory
MAX_ROLES = 32


# --- layer 1: the device ring ------------------------------------------------

@dataclass
class MetricRing(Struct):
    """The int32 telemetry block (`SimState.telemetry`), cumulative over
    the rounds executed since the run started. `req_round` is the
    in-flight invoke round per client slot (-1 idle), the device half of
    the latency histogram."""
    rounds: torch.Tensor        # i32 [] rounds folded
    sent: torch.Tensor          # i32 [] messages sent
    delivered: torch.Tensor     # i32 [] messages delivered
    dropped: torch.Tensor       # i32 [] lost + partition + down + overflow
    duplicated: torch.Tensor    # i32 [] extra copies
    pool_hist: torch.Tensor     # i32 [OCC_BUCKETS] rounds by pool occupancy
    pool_max: torch.Tensor      # i32 [] peak pool occupancy
    chan_hist: torch.Tensor     # i32 [OCC_BUCKETS] rounds by channel occ.
    chan_max: torch.Tensor      # i32 [] peak channel occupancy
    role_sent: torch.Tensor     # i32 [R] node sends per role slice
    lat_hist: torch.Tensor      # i32 [LAT_BUCKETS] reply latency, rounds
    lat_count: torch.Tensor     # i32 [] replies measured
    lat_sum: torch.Tensor       # i32 [] summed latency rounds (wraps)
    req_round: torch.Tensor     # i32 [C] in-flight invoke round (-1 idle)


def role_bounds(program) -> tuple:
    """The static ((lo, hi), ...) node slices `role_sent` buckets by: a
    role partition's ranges, or one slice of the whole cluster."""
    bounds = getattr(program, "_bounds", None)
    if bounds:
        return tuple((int(lo), int(hi)) for lo, hi in bounds)
    return ((0, int(getattr(program, "n_nodes", 0))),)


def role_names(program) -> list:
    roles = getattr(program, "roles", None)
    if roles:
        return [name for name, _prog in roles]
    return ["nodes"]


def make_ring(cfg, device) -> MetricRing:
    def z(shape=()):
        return torch.zeros(shape, dtype=I32, device=device)
    return MetricRing(
        rounds=z(), sent=z(), delivered=z(), dropped=z(), duplicated=z(),
        pool_hist=z(OCC_BUCKETS), pool_max=z(), chan_hist=z(OCC_BUCKETS),
        chan_max=z(), role_sent=z(max(len(cfg.telemetry_roles), 1)),
        lat_hist=z(LAT_BUCKETS), lat_count=z(), lat_sum=z(),
        req_round=torch.full((max(cfg.n_clients, 1),), -1, dtype=I32,
                             device=device))


_DROP = ("lost", "dropped_partition", "dropped_down", "dropped_overflow")


def _lat_bucket(lat):
    """ceil(log2(max(lat, 1))) clipped to LAT_BUCKETS - 1, in integers:
    the bit length of lat - 1 (JAX takes the float32 log2, equal for
    every lat up to 2^20, and both clip past 2^15)."""
    pow2 = torch.tensor([1 << b for b in range(LAT_BUCKETS - 1)],
                        dtype=torch.int64, device=lat.device)
    x = lat.clamp(min=1).long() - 1
    return (x[:, None] >= pow2[None, :]).sum(dim=1)


def ring_update_plain(cfg, ring: MetricRing, st0, net, chan_valid, round_i,
                      send_planes, inject_sent, reply_msgs) -> MetricRing:
    """One round's fold (the JAX package's `ring_update`,
    `telemetry.py:130-216`). `st0` is the round-entry NetStats, `net` the
    post-round NetState, `chan_valid` the channels' valid plane or None,
    `round_i` the round-entry counter, `send_planes` bool planes [N, W]
    whose row sums are the per-node sends (JAX's `node_sent`),
    `inject_sent` the id-stamped client inject view, `reply_msgs` a Msgs
    view whose valid rows to clients (dest >= N) are the round's reply
    deliveries. int32 throughout: sums wrap as XLA's do."""
    st1 = net.stats

    def delta(fields):
        return sum(getattr(st1, f).long() - getattr(st0, f).long()
                   for f in fields)

    def occ_bucket(occ, cap):
        b = torch.div(wrap_i32(occ * OCC_BUCKETS).long(), max(cap, 1),
                      rounding_mode="floor")
        return b.clamp(0, OCC_BUCKETS - 1)

    def add_one(hist, b):
        return hist.index_add(0, b.reshape(1),
                              torch.ones(1, dtype=I32, device=b.device))

    pool_occ = net.pool.valid.sum()
    pool_hist = add_one(ring.pool_hist, occ_bucket(pool_occ, cfg.pool_cap))
    pool_max = torch.maximum(ring.pool_max, wrap_i32(pool_occ))
    chan_hist, chan_max = ring.chan_hist, ring.chan_max
    if chan_valid is not None:
        chan_occ = chan_valid.sum()
        chan_hist = add_one(chan_hist,
                            occ_bucket(chan_occ, chan_valid.numel()))
        chan_max = torch.maximum(chan_max, wrap_i32(chan_occ))

    bounds = cfg.telemetry_roles or ((0, cfg.n_nodes),)
    role_add = torch.stack([
        sum(p[lo:hi].sum() for p in send_planes) for lo, hi in bounds])
    role_sent = wrap_i32(ring.role_sent.long() + role_add)

    C, N = ring.req_round.shape[0], cfg.n_nodes
    req0 = ring.req_round
    dest = reply_msgs.dest.reshape(-1)
    rv = reply_msgs.valid.reshape(-1) & (dest >= N)
    hit = torch.zeros(C, dtype=torch.bool, device=req0.device)
    hit[(dest[rv] - N).clamp(0, C - 1).long()] = True
    lat = torch.where(hit & (req0 >= 0), round_i - req0, -1)
    measured = lat >= 0
    lat_hist = ring.lat_hist.index_add(
        0, _lat_bucket(lat[measured]),
        torch.ones(int(measured.sum()), dtype=I32, device=req0.device))

    src = inject_sent.src.reshape(-1)
    iv = inject_sent.valid.reshape(-1) & (src >= N)
    armed = wrap_i32(torch.zeros(C, dtype=torch.int64,
                                 device=req0.device).index_add(
        0, (src[iv] - N).clamp(0, C - 1).long(),
        (round_i.long() + 1).expand(int(iv.sum()))))
    req = torch.where(armed > 0, armed - 1, req0)
    req = torch.where(hit & ~(armed > 0), -1, req)

    def acc(old, d):
        return wrap_i32(old.long() + d)

    return MetricRing(
        rounds=acc(ring.rounds, 1),
        sent=acc(ring.sent, delta(("sent_all",))),
        delivered=acc(ring.delivered, delta(("recv_all",))),
        dropped=acc(ring.dropped, delta(_DROP)),
        duplicated=acc(ring.duplicated, delta(("duplicated",))),
        pool_hist=pool_hist, pool_max=pool_max,
        chan_hist=chan_hist, chan_max=chan_max, role_sent=role_sent,
        lat_hist=lat_hist,
        lat_count=acc(ring.lat_count, measured.sum()),
        lat_sum=acc(ring.lat_sum, lat[measured].long().sum()),
        req_round=req)


_STATS = ("sent_all", "recv_all", "lost", "dropped_partition",
          "dropped_down", "dropped_overflow", "duplicated")


def ring_update(cfg, ring: MetricRing, st0, net, chan_valid, round_i,
                send_planes, inject_sent, reply_msgs) -> MetricRing:
    """One round's telemetry fold (see `ring_update_plain`); the kernel
    is K19 `ring_update` in `csrc/telemetry.cu`: two launches, the
    reductions and client marks, then the per-client latency pass."""
    if not K.use_kernel(ring.req_round):
        return ring_update_plain(cfg, ring, st0, net, chan_valid, round_i,
                                 send_planes, inject_sent, reply_msgs)
    dev = ring.req_round.device
    N, C = cfg.n_nodes, ring.req_round.shape[0]
    bounds = cfg.telemetry_roles or ((0, N),)
    R = len(bounds)
    if R > MAX_ROLES or ring.role_sent.shape != (R,):
        raise ValueError(f"ring_update: {R} role slices (at most "
                         f"{MAX_ROLES}), role_sent {tuple(ring.role_sent.shape)}")
    if not 1 <= len(send_planes) <= 2:
        raise ValueError("ring_update: one or two send planes")
    planes = []
    for p in send_planes:
        if p.dtype != torch.bool or p.dim() != 2 or p.shape[0] != N:
            raise ValueError(f"ring_update: send plane {tuple(p.shape)} "
                             f"{p.dtype}, want bool [N, W]")
        planes.append(p.contiguous())
    planes += [None] * (2 - len(planes))
    widths = [0 if p is None else p.shape[1] for p in planes]
    rep_valid = reply_msgs.valid.reshape(-1).contiguous()
    rep_dest = reply_msgs.dest.reshape(-1).contiguous()
    inj_valid = inject_sent.valid.reshape(-1).contiguous()
    inj_src = inject_sent.src.reshape(-1).contiguous()
    for name, t, want in (("round", round_i, I32),
                          ("pool", net.pool.valid, torch.bool),
                          ("reply dest", rep_dest, I32),
                          ("inject src", inj_src, I32)):
        if t.dtype != want:
            raise ValueError(f"ring_update: {name} is {t.dtype}")
    if chan_valid is not None and chan_valid.dtype != torch.bool:
        raise ValueError("ring_update: channel valid must be bool")
    st1 = net.stats
    out = MetricRing(**{f: torch.empty_like(getattr(ring, f))
                        for f in MetricRing.__dataclass_fields__})
    # scratch, zeroed: pool and channel counts, the per-role sums, reply
    # hits and inject arms per client
    scratch = torch.zeros(2 + R + 2 * C, dtype=I32, device=dev)
    ring_in = [getattr(ring, f) for f in MetricRing.__dataclass_fields__]
    outs = [getattr(out, f) for f in MetricRing.__dataclass_fields__]
    K.RING_UPDATE.launch(
        [net.pool.valid,
         None if chan_valid is None else chan_valid.contiguous(),
         planes[0], planes[1], rep_valid, rep_dest, inj_valid, inj_src,
         round_i, scratch]
        + [getattr(st0, f) for f in _STATS]
        + [getattr(st1, f) for f in _STATS]
        + ring_in + outs,
        [net.pool.valid.numel(),
         0 if chan_valid is None else chan_valid.numel(),
         widths[0], widths[1], rep_valid.numel(), inj_valid.numel(), N, C,
         cfg.pool_cap, R] + [v for b in bounds for v in b], dev)
    return out


def ring_dict(ring, role_labels=None) -> dict:
    """The drained ring as a plain JSON-shaped dict (numpy or host
    tensors in, ints out): the results' `net.telemetry` block and the
    stream's ring records."""
    def arr(a):
        return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)

    def g(a):
        return int(arr(a).sum())
    labels = list(role_labels or [])
    role = arr(ring.role_sent).reshape(-1, arr(ring.role_sent).shape[-1]
                                       ).sum(axis=0)
    out = {
        "rounds": g(ring.rounds),
        "sent": g(ring.sent),
        "delivered": g(ring.delivered),
        "dropped": g(ring.dropped),
        "duplicated": g(ring.duplicated),
        "pool-occupancy-hist": arr(ring.pool_hist).reshape(
            -1, OCC_BUCKETS).sum(axis=0).tolist(),
        "pool-occupancy-max": int(arr(ring.pool_max).max()),
        "latency-rounds-hist": arr(ring.lat_hist).reshape(
            -1, LAT_BUCKETS).sum(axis=0).tolist(),
        "latency-count": g(ring.lat_count),
        "latency-rounds-sum": g(ring.lat_sum),
    }
    if int(arr(ring.chan_hist).sum()):
        out["chan-occupancy-hist"] = arr(ring.chan_hist).reshape(
            -1, OCC_BUCKETS).sum(axis=0).tolist()
        out["chan-occupancy-max"] = int(arr(ring.chan_max).max())
    out["role-sent"] = {
        (labels[i] if i < len(labels) else f"role-{i}"): int(v)
        for i, v in enumerate(role.tolist())}
    return out


# --- exact streaming quantiles --------------------------------------------------

class Sketch:
    """Exact quantiles over a small discrete domain: a counting histogram
    keyed by value. Virtual time makes op latencies multiples of
    ms_per_round, so nothing is approximated, and `quantiles()` follows
    `checkers.perf`'s rule (sorted values, index min(n-1, int(p*n)),
    rounded to 3 places): the final cumulative record equals the
    PerfChecker's latency block."""

    __slots__ = ("counts", "n")

    def __init__(self):
        self.counts: dict = {}
        self.n = 0

    def add(self, v: float):
        self.counts[v] = self.counts.get(v, 0) + 1
        self.n += 1

    def merge(self, other: "Sketch"):
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c
        self.n += other.n

    def quantiles(self) -> dict:
        if not self.n:
            return {}
        items = sorted(self.counts.items())
        n = self.n

        def q(p):
            target = min(n - 1, int(p * n))
            seen = 0
            for v, c in items:
                seen += c
                if target < seen:
                    return v
            return items[-1][0]
        return {"count": n, "p50": round(q(0.5), 3),
                "p95": round(q(0.95), 3), "p99": round(q(0.99), 3),
                "max": round(items[-1][0], 3)}


# --- layers 2 and 3: the host session --------------------------------------------

class _Cursor:
    """Incremental history scan state: the open-invoke pairing walk (an
    invoke pairs with the next completion of its process), a windowed
    and a cumulative sketch, window op counters, the last ring drained
    (for deltas) and the longest gap between ok replies."""

    __slots__ = ("row", "open", "win", "cum", "invokes", "oks", "fails",
                 "infos", "last_round", "last_ring", "windows",
                 "last_ok_ns", "max_gap_ns")

    def __init__(self):
        self.row = 0
        self.open: dict = {}
        self.win = Sketch()
        self.cum = Sketch()
        self.invokes = self.oks = self.fails = self.infos = 0
        self.last_round = 0
        self.last_ring: dict | None = None
        self.windows = 0
        self.last_ok_ns = 0
        self.max_gap_ns = 0


class TelemetrySession:
    """One run's flight recorder, opened by `run_tpu_test` when
    `--telemetry` names a directory. Its methods only observe."""

    # spans are held until close (trace.json is one JSON document):
    # past the cap the later spans are counted as dropped
    TRACE_EVENT_CAP = 200_000

    def __init__(self, out_dir: str, ms_per_round: float = 1.0):
        os.makedirs(out_dir, exist_ok=True)
        self.dir = out_dir
        self.ms_per_round = float(ms_per_round)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: list = []
        self._events_dropped = 0
        self._cursors: dict = {}
        self._seq = 0
        self._closed = False
        self._jsonl = open(os.path.join(out_dir, "telemetry.jsonl"), "w")

    def span(self, name: str, t0: float, t1: float, tid="runner",
             args: dict | None = None):
        """One completed phase span, perf_counter() endpoints."""
        ev = {"name": name, "ph": "X", "pid": "maelstrom",
              "tid": str(tid),
              "ts": round((t0 - self._t0) * 1e6, 1),
              "dur": round(max(t1 - t0, 0.0) * 1e6, 1)}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) < self.TRACE_EVENT_CAP:
                self._events.append(ev)
            else:
                self._events_dropped += 1

    def _cursor(self, cluster) -> _Cursor:
        c = self._cursors.get(cluster)
        if c is None:
            c = self._cursors[cluster] = _Cursor()
        return c

    def _ingest(self, cur: _Cursor, history):
        """Walks the history rows appended since the last call: each
        invoke opens its process, the next completion closes it (an ok
        adds its latency to both sketches); nemesis rows are skipped."""
        hi = len(history)
        if hi <= cur.row:
            return
        soa = history.soa()
        try:
            nem = soa.process_table.index("nemesis")
        except ValueError:
            nem = -1
        types, procs, times = soa.type, soa.process, soa.time
        for i in range(cur.row, hi):
            p = int(procs[i])
            if p == nem:
                continue
            if types[i] == 0:               # invoke
                cur.open[p] = int(times[i])
                cur.invokes += 1
                continue
            t0 = cur.open.pop(p, None)
            if types[i] == 1:               # ok
                cur.oks += 1
                t_ok = int(times[i])
                cur.max_gap_ns = max(cur.max_gap_ns, t_ok - cur.last_ok_ns)
                cur.last_ok_ns = max(cur.last_ok_ns, t_ok)
                if t0 is not None:
                    lat_ms = (t_ok - t0) / 1e6
                    cur.win.add(lat_ms)
                    cur.cum.add(lat_ms)
            elif types[i] == 2:
                cur.fails += 1
            else:
                cur.infos += 1
        cur.row = hi

    def wave(self, history, r: int, cluster=None, ring=None,
             transfer=None):
        """Appends one window record: the window's ops, windowed and
        cumulative latency quantiles, offered and delivered rates over
        the window's virtual span, the availability gaps and the ring's
        deltas."""
        cur = self._cursor(cluster)
        inv0, ok0 = cur.invokes, cur.oks
        fail0, info0 = cur.fails, cur.infos
        cur.win = Sketch()
        self._ingest(cur, history)
        span_r = max(int(r) - cur.last_round, 0)
        span_s = span_r * self.ms_per_round / 1e3
        rec = {
            "type": "window", "seq": self._seq, "window": cur.windows,
            "round": int(r),
            "t_s": round(time.perf_counter() - self._t0, 6),
            "ops": cur.invokes - inv0,
            "oks": cur.oks - ok0,
            "fails": cur.fails - fail0,
            "infos": cur.infos - info0,
            "lat_ms": cur.win.quantiles(),
            "cum_lat_ms": cur.cum.quantiles(),
        }
        if cluster is not None:
            rec["cluster"] = cluster
        if span_s > 0:
            rec["offered_rate"] = round((cur.invokes - inv0) / span_s, 3)
            rec["delivered_rate"] = round((cur.oks - ok0) / span_s, 3)
        ns_pr = self.ms_per_round * 1e6
        rec["availability"] = {
            "max_ok_gap_rounds": int(cur.max_gap_ns / ns_pr),
            "rounds_since_ok": max(int(r) - int(cur.last_ok_ns / ns_pr), 0),
        }
        if ring is not None:
            rec["ring"] = self._ring_delta(cur, ring)
        if transfer is not None:
            rec["drains"] = transfer.drains
        cur.last_round = int(r)
        cur.windows += 1
        self._write(rec)

    def _ring_delta(self, cur: _Cursor, ring_now: dict) -> dict:
        prev = cur.last_ring or {}
        cur.last_ring = ring_now
        out = {}
        for k, v in ring_now.items():
            if isinstance(v, int):
                out[k] = v - int(prev.get(k, 0))
            elif isinstance(v, list):
                pv = prev.get(k) or [0] * len(v)
                out[k] = [a - b for a, b in zip(v, pv)]
        return out

    def flush(self, history, r: int, cluster=None, ring=None):
        """The run's final record: the tail rows ingested, the cumulative
        quantiles (`lat_ms` equals the PerfChecker's latency block) and
        the cumulative ring."""
        cur = self._cursor(cluster)
        cur.win = Sketch()
        self._ingest(cur, history)
        rec = {
            "type": "final", "seq": self._seq, "round": int(r),
            "t_s": round(time.perf_counter() - self._t0, 6),
            "ops": cur.invokes, "oks": cur.oks,
            "fails": cur.fails, "infos": cur.infos,
            "windows": cur.windows,
            "lat_ms": cur.cum.quantiles(),
        }
        if cluster is not None:
            rec["cluster"] = cluster
        if ring is not None:
            rec["ring"] = ring
        self._write(rec)

    def _write(self, rec: dict):
        # straight to disk and flushed: `top` tails the live file
        with self._lock:
            if self._closed:
                return
            self._seq += 1
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def close(self):
        """Writes trace.json (Chrome trace events). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._jsonl.close()
            events = self._events
            self._events = []
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if self._events_dropped:
            trace["otherData"] = {
                "spans-dropped-past-cap": self._events_dropped}
        with open(os.path.join(self.dir, "trace.json"), "w") as f:
            json.dump(trace, f)


def resolve_dir(spec, store_dir: str) -> str:
    """`--telemetry` value -> output directory: a path is used as it is;
    the bare flag ("auto") puts telemetry/ in the run's store dir."""
    if spec in (None, "", "off"):
        raise ValueError("telemetry disabled")
    if spec in ("auto", "on", True):
        return os.path.join(store_dir, "telemetry")
    return str(spec)


def enabled(test: dict) -> bool:
    v = test.get("telemetry")
    return bool(v) and str(v) != "off"


# --- `top`: the tail view --------------------------------------------------------

def read_records(path: str) -> list:
    """telemetry.jsonl records from a file, a telemetry dir, or a store
    test dir (<dir>/telemetry/telemetry.jsonl)."""
    if os.path.isdir(path):
        for cand in (os.path.join(path, "telemetry.jsonl"),
                     os.path.join(path, "telemetry", "telemetry.jsonl")):
            if os.path.exists(cand):
                path = cand
                break
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue            # a live run's torn last line
    return out


def render_top(records: list) -> str:
    """A `top`-style snapshot: the freshest window per cluster and a
    totals line, from the parsed records alone."""
    if not records:
        return "telemetry: no records yet"
    latest: dict = {}
    last_win: dict = {}
    for r in records:
        if r.get("type") in ("window", "final"):
            latest[r.get("cluster")] = r
        if r.get("type") == "window":
            last_win[r.get("cluster")] = r
    rows = []
    header = (f"{'cluster':>8} {'round':>9} {'win':>5} {'ops':>7} "
              f"{'ok/s':>9} {'p50ms':>8} {'p95ms':>8} {'p99ms':>8} "
              f"{'lag':>6}")
    rows.append(header)
    rows.append("-" * len(header))
    for cl in sorted(latest, key=lambda c: (c is None, c)):
        r = latest[cl]
        lat = r.get("lat_ms") or r.get("cum_lat_ms") or {}
        cum = r.get("cum_lat_ms") or lat
        # the rate column reads the freshest window record (a final
        # carries cumulative counts, not a windowed rate)
        rate = (r.get("delivered_rate")
                or last_win.get(cl, {}).get("delivered_rate", "-"))
        rows.append(
            f"{('-' if cl is None else cl):>8} "
            f"{r.get('round', 0):>9} "
            f"{r.get('window', r.get('windows', 0)):>5} "
            f"{r.get('ops', 0):>7} "
            f"{rate:>9} "
            f"{lat.get('p50', cum.get('p50', '-')):>8} "
            f"{lat.get('p95', cum.get('p95', '-')):>8} "
            f"{lat.get('p99', cum.get('p99', '-')):>8} "
            f"{r.get('checker_lag_rounds', '-'):>6}")
    finals = [r for r in records if r.get("type") == "final"]
    rows.append("")
    rows.append(f"clusters: {len(latest)}  records: {len(records)}  "
                f"final: {len(finals)}")
    return "\n".join(rows)


def top_main(path: str, follow: bool = False, interval: float = 1.0) -> int:
    """`top PATH [--follow]`: renders the freshest telemetry snapshot;
    with --follow, again every `interval` seconds until interrupted."""
    try:
        while True:
            try:
                records = read_records(path)
            except FileNotFoundError:
                print(f"top: no telemetry at {path!r} (run with "
                      f"--telemetry DIR)")
                return 1
            out = render_top(records)
            if follow:
                print("\x1b[2J\x1b[H" + out, flush=True)
                time.sleep(max(interval, 0.1))
            else:
                print(out)
                return 0
    except KeyboardInterrupt:
        return 0


# --- helpers shared by tests and docs ----------------------------------------------

def lat_bucket_bounds() -> list:
    """[(lo, hi)] inclusive latency-in-rounds range of each lat_hist
    bucket."""
    out = [(0, 1)]
    for b in range(1, LAT_BUCKETS):
        out.append((2 ** (b - 1) + 1, 2 ** b))
    return out


def validate_record(rec: dict) -> list:
    """Schema check of one telemetry.jsonl record: the problems found,
    empty when it is valid."""
    problems = []
    t = rec.get("type")
    if t not in ("window", "final"):
        problems.append(f"unknown record type {t!r}")
        return problems
    for k in ("seq", "round", "ops", "oks"):
        if not isinstance(rec.get(k), int):
            problems.append(f"{k}: expected int, got {rec.get(k)!r}")
    for k in ("lat_ms",) + (("cum_lat_ms",) if t == "window" else ()):
        v = rec.get(k)
        if not isinstance(v, dict):
            problems.append(f"{k}: expected dict, got {v!r}")
        elif v and not {"count", "p50", "p95", "p99", "max"} <= set(v):
            problems.append(f"{k}: incomplete quantile block {v!r}")
    if math.isnan(rec.get("t_s", 0.0)):
        problems.append("t_s: NaN")
    return problems
