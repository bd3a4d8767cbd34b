"""The port's flight recorder against the JAX package's
(`maelstrom_tpu/telemetry.py`).

- `ring_update_plain` (the plain version of kernel K19) against JAX's
  `ring_update` on numpy-seeded inputs, with and without channels and
  with two role slices, including the cases that hit each int32 parity
  hazard: duplicated replies, a reply and a re-invoke of one client in
  one round, two invokes of one client, latencies at and beside every
  power of two to 2^16, `lat_sum` wrapping past 2^31, stat deltas that
  wrap, and occupancy 0 and at capacity. Tolerance: exact, every leaf.
- The host half: `Sketch`, `render_top`, `validate_record`,
  `lat_bucket_bounds` and `ring_dict` as JAX's.
- A run with the ring on and off: byte-identical histories, equal
  drains, the ring equal to the NetStats counters, the stream's final
  quantiles equal to the PerfChecker's, and the three span names in
  trace.json; `top` renders the stream."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu import telemetry as JTM
from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import core as pcore
from maelstrom_tpu_torch import telemetry as PTM
from maelstrom_tpu_torch.net import tpu as PT
from test_torch_support import assert_trees_equal, jax_tree_to_numpy

N = 5
ROLES = ((0, 2), (2, 5))
STATS = ("sent_all", "sent_servers", "recv_all", "recv_servers", "lost",
         "dropped_partition", "dropped_overflow", "sent_units", "recv_units",
         "dropped_down", "duplicated")
RING = tuple(PTM.MetricRing.__dataclass_fields__)
CHAN_SHAPE = (N, 4, 2, 3)
I32_MAX = 2**31 - 1


def _base(rng, C, P=64, Q=None, RP=12):
    """Random inputs of one round: the ring, the round-entry and -exit
    stats, the pool and channel valid planes, per-node sends, the inject
    and reply rows (numpy)."""
    Q = C if Q is None else Q
    rnd = 1000
    ring = {f: rng.integers(0, 50, dtype=np.int32) for f in
            ("rounds", "sent", "delivered", "dropped", "duplicated",
             "pool_max", "chan_max", "lat_count", "lat_sum")}
    ring.update(
        pool_hist=rng.integers(0, 9, 8, dtype=np.int32),
        chan_hist=rng.integers(0, 9, 8, dtype=np.int32),
        role_sent=rng.integers(0, 99, len(ROLES), dtype=np.int32),
        lat_hist=rng.integers(0, 9, 16, dtype=np.int32),
        req_round=np.where(rng.random(C) < 0.3, -1,
                           rng.integers(rnd - 40, rnd, C)).astype(np.int32))
    st0 = {f: rng.integers(0, 10_000, dtype=np.int32) for f in STATS}
    st1 = {f: np.int32(v + rng.integers(0, 20)) for f, v in st0.items()}
    return {
        "C": C, "P": P, "round": np.int32(rnd), "ring": ring,
        "st0": st0, "st1": st1,
        "pool": rng.random(P) < 0.4,
        "chan": rng.random(CHAN_SHAPE) < 0.3,
        "node_sent": rng.integers(0, 7, N).astype(np.int32),
        "inj_valid": rng.random(Q) < 0.6,
        "inj_src": rng.integers(0, N + C + 2, Q).astype(np.int32),
        "rep_valid": rng.random(RP) < 0.6,
        "rep_dest": rng.integers(0, N + C + 2, RP).astype(np.int32),
    }


def _hazard(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    c = _base(rng, 8)
    ring = c["ring"]
    if name == "duplicated-replies":
        ring["req_round"][:] = 990
        c["rep_valid"][:] = True
        c["rep_dest"][:] = N + np.array([1, 1, 1, 2, 2, 3, 3, 3, 3, 7, 7, 1])
    elif name == "reply-and-reinvoke":
        ring["req_round"][:] = 990
        c["rep_valid"][:] = False
        c["rep_valid"][:3] = True
        c["rep_dest"][:3] = N + np.array([2, 4, 6])
        c["inj_valid"][:] = False
        c["inj_valid"][:2] = True
        c["inj_src"][:2] = N + np.array([2, 4])
    elif name == "two-invokes":
        c["inj_valid"][:] = True
        c["inj_src"][:] = N + np.array([0, 0, 3, 3, 3, 5, 9, 2])
    elif name == "lat-powers":
        lats = sorted({x for k in range(17) for x in (2**k - 1, 2**k,
                                                      2**k + 1) if x >= 0})
        C = len(lats)
        c = _base(rng, C, RP=C)
        c["round"] = np.int32(1 << 17)
        c["ring"]["req_round"] = (c["round"] - np.array(lats)).astype(
            np.int32)
        c["rep_valid"][:] = True
        c["rep_dest"] = (N + np.arange(C)).astype(np.int32)
    elif name == "lat-sum-wrap":
        ring["lat_sum"] = np.int32(I32_MAX - 10)
        ring["lat_count"] = np.int32(I32_MAX)
        ring["req_round"][:] = 900
        c["rep_valid"][:] = True
        c["rep_dest"] = (N + np.arange(12) % 8).astype(np.int32)
    elif name == "stats-wrap":
        for f in c["st0"]:
            c["st0"][f] = np.int32(I32_MAX - 3)
            c["st1"][f] = np.int32(-(2**31) + 5)
        ring["sent"] = np.int32(I32_MAX)
    elif name == "occupancy-empty":
        c["pool"][:] = False
        c["chan"][:] = False
        c["node_sent"][:] = 0
    elif name == "occupancy-full":
        c["pool"][:] = True
        c["chan"][:] = True
        ring["pool_max"] = np.int32(3)
    elif name.startswith("random"):
        c = _base(np.random.default_rng(int(name[6:])), 8)
    return c


CASES = ["duplicated-replies", "reply-and-reinvoke", "two-invokes",
         "lat-powers", "lat-sum-wrap", "stats-wrap", "occupancy-empty",
         "occupancy-full", "random1", "random2", "random3"]


def _send_planes(node_sent, split):
    """Bool planes [N, W] whose row sums are node_sent (split across two
    planes, as the edge round passes edge sends and reply rows)."""
    W = int(node_sent.max()) + 1
    cols = np.arange(W)[None, :]
    plane = cols < node_sent[:, None]
    if not split:
        return (torch.from_numpy(plane),)
    first = np.minimum(node_sent, 2)
    return (torch.from_numpy(cols[:, :2] < first[:, None]),
            torch.from_numpy(cols < (node_sent - first)[:, None]))


def _jax_ring_update(c, chan):
    cfg = JT.NetConfig(n_nodes=N, n_clients=c["C"], pool_cap=c["P"],
                       telemetry=True, telemetry_roles=ROLES)
    stats0 = JT.make_net(cfg).stats
    st0 = stats0.replace(**{f: jnp.int32(v) for f, v in c["st0"].items()})
    st1 = stats0.replace(**{f: jnp.int32(v) for f, v in c["st1"].items()})
    net = JT.make_net(cfg)
    net = net.replace(pool=net.pool.replace(valid=jnp.asarray(c["pool"])),
                      stats=st1)
    ring = JTM.MetricRing(**{f: jnp.asarray(v)
                             for f, v in c["ring"].items()})
    Q, RP = len(c["inj_valid"]), len(c["rep_valid"])
    inj = JT.Msgs.empty(Q).replace(valid=jnp.asarray(c["inj_valid"]),
                                   src=jnp.asarray(c["inj_src"]))
    rep = JT.Msgs.empty(RP).replace(valid=jnp.asarray(c["rep_valid"]),
                                    dest=jnp.asarray(c["rep_dest"]))
    channels = (SimpleNamespace(valid=jnp.asarray(c["chan"])) if chan
                else None)
    return JTM.ring_update(cfg, ring, st0, net, channels,
                           jnp.int32(c["round"]),
                           jnp.asarray(c["node_sent"]), inj, rep)


def _port_ring_update(c, chan, split):
    cfg = PT.NetConfig(n_nodes=N, n_clients=c["C"], pool_cap=c["P"],
                       telemetry=True, telemetry_roles=ROLES)

    def stats(d):
        z = PT.NetStats.zeros("cpu")
        return z.replace(**{f: torch.tensor(v, dtype=torch.int32)
                            for f, v in d.items()})
    net = SimpleNamespace(stats=stats(c["st1"]), pool=SimpleNamespace(
        valid=torch.from_numpy(c["pool"])))
    ring = PTM.MetricRing(**{f: torch.from_numpy(np.asarray(v))
                             for f, v in c["ring"].items()})
    Q, RP = len(c["inj_valid"]), len(c["rep_valid"])
    inj = PT.Msgs.empty(Q, "cpu").replace(
        valid=torch.from_numpy(c["inj_valid"]),
        src=torch.from_numpy(c["inj_src"]))
    rep = PT.Msgs.empty(RP, "cpu").replace(
        valid=torch.from_numpy(c["rep_valid"]),
        dest=torch.from_numpy(c["rep_dest"]))
    return PTM.ring_update(
        cfg, ring, stats(c["st0"]), net,
        torch.from_numpy(c["chan"]) if chan else None,
        torch.tensor(c["round"], dtype=torch.int32),
        _send_planes(c["node_sent"], split), inj, rep)


@pytest.mark.parametrize("chan", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_ring_update_plain_matches_jax(case, chan):
    c = _hazard(case)
    ref = jax_tree_to_numpy(_jax_ring_update(c, chan))
    got = _port_ring_update(c, chan, split=chan)
    for f in RING:
        t = getattr(got, f)
        assert t.dtype == torch.int32, f
        assert_trees_equal(ref[f], t.numpy(), path=f)
    if case == "lat-powers":
        assert int(got.lat_count) - int(c["ring"]["lat_count"]) == \
            len(c["rep_valid"])
    if case == "lat-sum-wrap":
        assert int(got.lat_sum) < 0 and int(got.lat_count) < 0
    if case == "occupancy-full":
        assert int(got.pool_hist[7]) == int(c["ring"]["pool_hist"][7]) + 1


def test_lat_buckets_match_jax_up_to_2_17():
    """Every latency 1..2^17 in one fold: JAX's float32 ceil(log2) and
    the port's integer bit length give one histogram."""
    C = 1 << 17
    rnd = np.int32(C + 5)
    c = _base(np.random.default_rng(0), C, Q=4, RP=C)
    c["round"] = rnd
    c["ring"]["req_round"] = (rnd - np.arange(1, C + 1)).astype(np.int32)
    c["ring"]["lat_hist"][:] = 0
    c["rep_valid"][:] = True
    c["rep_dest"] = (N + np.arange(C)).astype(np.int32)
    ref = jax_tree_to_numpy(_jax_ring_update(c, False))
    got = _port_ring_update(c, False, split=False)
    assert got.lat_hist.tolist() == ref["lat_hist"].tolist()
    assert got.lat_hist.tolist()[:3] == [1, 1, 2]


def test_host_half_matches_jax():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 40, 500).astype(float).tolist()
    js, ps = JTM.Sketch(), PTM.Sketch()
    for v in vals:
        js.add(v)
        ps.add(v)
    assert ps.quantiles() == js.quantiles()
    assert PTM.Sketch().quantiles() == {}
    assert PTM.lat_bucket_bounds() == JTM.lat_bucket_bounds()
    assert (PTM.OCC_BUCKETS, PTM.LAT_BUCKETS) == (JTM.OCC_BUCKETS,
                                                  JTM.LAT_BUCKETS)
    c = _hazard("random2")
    ring = _jax_ring_update(c, True)
    pring = _port_ring_update(c, True, split=True)
    labels = ["a", "b"]
    assert PTM.ring_dict(pring, labels) == JTM.ring_dict(
        jax_tree_to_numpy_ring(ring), labels)
    recs = [
        {"type": "window", "seq": 0, "window": 0, "round": 250, "t_s": 0.1,
         "ops": 5, "oks": 4, "fails": 0, "infos": 0,
         "lat_ms": {"count": 4, "p50": 3.0, "p95": 4.0, "p99": 4.0,
                    "max": 4.0},
         "cum_lat_ms": {"count": 4, "p50": 3.0, "p95": 4.0, "p99": 4.0,
                        "max": 4.0}, "delivered_rate": 16.0},
        {"type": "final", "seq": 1, "round": 400, "t_s": 0.2, "ops": 5,
         "oks": 4, "fails": 0, "infos": 1, "windows": 1,
         "lat_ms": {"count": 4, "p50": 3.0, "p95": 4.0, "p99": 4.0,
                    "max": 4.0}}]
    for r in recs:
        assert PTM.validate_record(r) == JTM.validate_record(r) == []
    assert PTM.render_top(recs) == JTM.render_top(recs)
    assert PTM.render_top([]) == JTM.render_top([])
    for bad in ({"type": "bogus"}, {"type": "window", "seq": "x",
                                    "round": 0, "ops": 0, "oks": 0}):
        assert PTM.validate_record(bad) == JTM.validate_record(bad) != []


def jax_tree_to_numpy_ring(ring):
    return SimpleNamespace(**jax_tree_to_numpy(ring))


# --- a run with the ring on and off ------------------------------------------

def _run(tmp, tel=None, **kw):
    opts = dict(store_root=str(tmp), seed=23, workload="lin-kv",
                node="tpu:lin-kv", node_count=5, rate=15.0,
                time_limit=0.5, recovery_s=0.3, device="cpu")
    if tel:
        opts["telemetry"] = tel
    opts.update(kw)
    res = pcore.run(opts)
    d = os.path.realpath(os.path.join(str(tmp), "latest"))
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        hist = f.read()
    with open(os.path.join(d, "timing.json")) as f:
        timing = json.load(f)
    return res, hist, timing


def _ring_is_netstats(res):
    ring, net = res["net"]["telemetry"], res["net"]
    assert ring["sent"] == net["all"]["send-count"]
    assert ring["delivered"] == net["all"]["recv-count"]
    assert ring["dropped"] == (net["lost"] + net["dropped-partition"]
                               + net["dropped-down"]
                               + net["dropped-overflow"])
    assert ring["duplicated"] == net["duplicated"]
    assert ring["rounds"] > 0
    assert sum(ring["pool-occupancy-hist"]) == ring["rounds"]
    assert ring["latency-count"] > 0 and "nodes" in ring["role-sent"]


def _stream_checks(res, tel_dir, continuous=False):
    recs = PTM.read_records(tel_dir)
    assert recs
    for rec in recs:
        assert PTM.validate_record(rec) == [], rec
    final = [r for r in recs if r["type"] == "final"][-1]
    perf = {k: v for k, v in res["perf"]["latency-ms"].items()
            if k != "by-f"}
    assert final["lat_ms"] == perf
    assert final["ring"] == res["net"]["telemetry"]
    wins = [r for r in recs if r["type"] == "window"]
    assert final["ops"] == sum(r["ops"] for r in wins)
    assert 0 < sum(r.get("ring", {}).get("sent", 0) for r in wins) <= \
        final["ring"]["sent"]
    with open(os.path.join(tel_dir, "trace.json")) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"schedule-encode", "dispatch", "device-get"} <= names
    for e in trace["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0 and "ts" in e
    if continuous:
        assert len(wins) >= 2


@pytest.mark.parametrize("continuous", [False, True])
def test_ring_on_off_byte_identity(continuous, tmp_path, capsys):
    """The ring never changes the run: the histories are byte-identical,
    the drains equal, and the ring counts what NetStats counts."""
    r_off, h_off, t_off = _run(tmp_path / "off", continuous=continuous)
    tel_dir = str(tmp_path / "teldir")
    r_on, h_on, t_on = _run(tmp_path / "on", tel=tel_dir,
                            continuous=continuous)
    assert h_on == h_off
    assert r_on["net"]["drains"] == r_off["net"]["drains"]
    assert t_on["drains"] == t_off["drains"]
    assert t_on["rounds-executed"] == t_off["rounds-executed"]
    assert "telemetry" not in r_off["net"]
    _ring_is_netstats(r_on)
    _stream_checks(r_on, tel_dir, continuous)
    # `top` renders the stream, from the dir or the store's test dir
    capsys.readouterr()
    assert pcli.main(["top", tel_dir]) == 0
    out = capsys.readouterr().out
    assert "p99ms" in out and "final: 1" in out
    assert pcli.main(["top", str(tmp_path / "nothing")]) == 1


def test_bare_telemetry_flag_lands_in_store(tmp_path):
    """Bare --telemetry puts telemetry/ in the run's store dir; "off"
    leaves the ring out."""
    args = ["test", "-w", "echo", "--node", "tpu:echo", "--node-count",
            "3", "--time-limit", "0.3", "--rate", "20", "--device", "cpu",
            "--store", str(tmp_path)]
    assert pcli.main(args + ["--telemetry"]) == 0
    d = os.path.realpath(os.path.join(str(tmp_path), "latest"))
    assert os.path.exists(os.path.join(d, "telemetry", "telemetry.jsonl"))
    with open(os.path.join(d, "results.json")) as f:
        assert "telemetry" in json.load(f)["net"]
    assert pcli.main(args + ["--telemetry", "off"]) == 0
    d = os.path.realpath(os.path.join(str(tmp_path), "latest"))
    with open(os.path.join(d, "results.json")) as f:
        assert "telemetry" not in json.load(f)["net"]
