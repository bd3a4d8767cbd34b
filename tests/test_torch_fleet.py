"""The port's fleet runner (`--fleet N`, `maelstrom_tpu_torch/runner/
fleet_runner.py`) against the JAX package's `FleetRunner` and against the
port's own standalone runs.

The contract is the JAX package's: every cluster of a fleet replays the
standalone run of its own option set (`FleetSpec.cluster_opts`: seed,
nemesis schedule or offered load) byte for byte. Each run below goes
through both packages' `run_fleet_test` on the CPU (JAX with the audit
off and `no_overlap`: the port has no overlap pipeline) and must give,
cluster by cluster:

  - history.jsonl, byte for byte, equal to JAX's fleet cluster and to the
    port's standalone run of that cluster's options;
  - results.json equal to JAX's, except the host-transfer and wall-clock
    keys of `WALL_KEYS` (the port counts its own host reads), and equal
    to the standalone run's but for the fleet's `cluster` / `seed` /
    `nemesis-seed` / `rate` stamps.

The configurations are `tests/test_fleet_runner.py`'s, cut short so the
port's CPU run (some 15 ms a lockstep round) stays within the tier-1
budget: here the broadcast seed sweep and capacity sweep and both session
backends, which must give the same bytes; the runs under faults are in
`tests/test_torch_fleet_faults.py`."""

from __future__ import annotations

import json
import os

import pytest

from maelstrom_tpu import core as jcore
from maelstrom_tpu.runner.fleet_runner import run_fleet_test as j_run_fleet
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import core as pcore
from maelstrom_tpu_torch.runner.fleet_runner import FleetRunner
from maelstrom_tpu_torch.runner.fleet_runner import \
    run_fleet_test as p_run_fleet
from maelstrom_tpu_torch.runner.tpu_runner import run_tpu_test

WALL_KEYS = ("drains", "host-bytes", "host-blocked-s", "host-overlapped-s",
             "host-polls", "host-poll-s", "host-wall-per-wave")
STAMPS = ("cluster", "seed", "nemesis-seed", "rate")

BROADCAST = {"workload": "broadcast", "node": "tpu:broadcast",
             "topology": "grid", "node_count": 5, "rate": 10.0,
             "time_limit": 0.4, "recovery_s": 0.3, "seed": 7,
             "audit": False, "no_overlap": True}
UNIFORM = {"latency": {"mean": 2, "dist": "uniform"}}
LIN_KV = {"workload": "lin-kv", "node": "tpu:lin-kv", "node_count": 3,
          "rate": 10.0, "time_limit": 0.5, "recovery_s": 0.2, "seed": 11,
          "audit": False, "no_overlap": True}
_CACHE: dict = {}


def _key(kind, opts):
    return (kind, repr(sorted(opts.items())))


def _read(d):
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        hist = f.read()
    with open(os.path.join(d, "results.json")) as f:
        res = json.load(f)
    return hist, res


def _strip(res):
    """results.json without the wall-clock and host-read keys."""
    res = json.loads(json.dumps(res))
    for block in [res, res.get("net", {})] + [
            c.get("net", {}) for c in res.get("clusters", [])]:
        for k in WALL_KEYS:
            block.pop(k, None)
    for block in [res] + res.get("clusters", []):
        block.get("availability", {}).pop("check-wall-s", None)
    return res


def _fleet(pkg, opts, tmp_root):
    """(per-cluster [(history bytes, results)], fleet results) of one
    fleet run through `pkg`'s run_fleet_test, memoized a module."""
    key = _key(pkg, opts)
    if key not in _CACHE:
        d = os.path.join(tmp_root, f"{pkg}-{len(_CACHE)}")
        os.makedirs(d)
        if pkg == "jax":
            res = j_run_fleet(jcore.build_test(dict(opts)), d)
        else:
            res = p_run_fleet(pcore.build_test({**opts, "device": "cpu"}), d)
        clusters = [_read(os.path.join(d, f"cluster-{i:04d}"))
                    for i in range(int(opts["fleet"]))]
        _CACHE[key] = (clusters, res)
    return _CACHE[key]


def _solo(opts, tmp_root):
    """The port's standalone run of one cluster's options."""
    key = _key("solo", opts)
    if key not in _CACHE:
        d = os.path.join(tmp_root, f"solo-{len(_CACHE)}")
        os.makedirs(d)
        test = pcore.build_test({**opts, "device": "cpu"})
        run_tpu_test(test, d)
        _CACHE[key] = _read(d)
    return _CACHE[key]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("fleet"))


def _check(opts, tmp_root, jax=True, solos=True, valid=True):
    """Every cluster of the port's fleet against JAX's fleet cluster and
    the port's standalone run; returns the port's clusters."""
    port, pres = _fleet("port", opts, tmp_root)
    if jax:
        ref, jres = _fleet("jax", opts, tmp_root)
        assert _strip(pres) == _strip(jres)
        for i, ((ph, pr), (jh, jr)) in enumerate(zip(port, ref)):
            assert ph == jh, f"cluster {i}: history differs from JAX's"
            assert _strip(pr) == _strip(jr), f"cluster {i}: results"
    if solos:
        spec = pcore.FleetSpec.from_test(opts)
        for i, (ph, pr) in enumerate(port):
            sh, sr = _solo(spec.cluster_opts(opts, i), tmp_root)
            assert ph == sh, f"cluster {i}: history differs from its solo"
            pr = {k: v for k, v in _strip(pr).items() if k not in STAMPS}
            assert pr == _strip(sr), f"cluster {i}: results vs its solo"
    if valid:
        assert pres["valid"] is True
    return port


# --- FleetSpec ---------------------------------------------------------------

def test_fleet_spec_matches_jax():
    for test in ({}, {"fleet": 8, "fleet_sweep": "capacity"},
                 {"fleet": 3, "fleet_sweep": "nemesis"}):
        j, p = jcore.FleetSpec.from_test(test), pcore.FleetSpec.from_test(test)
        assert (p.fleet, p.sweep) == (j.fleet, j.sweep)
    for bad, what in (({"fleet": 0}, "--fleet must be >= 1"),
                      ({"fleet": 2, "fleet_sweep": "chaos"},
                       "--fleet-sweep")):
        with pytest.raises(ValueError, match=what):
            pcore.FleetSpec.from_test(bad)


@pytest.mark.parametrize("sweep", ["seed", "nemesis", "capacity"])
def test_cluster_opts_match_jax(sweep):
    """cluster_opts(i) is JAX's: the swept value set, the fleet-level
    mechanics stripped or forced off."""
    opts = {**LIN_KV, "fleet": 3, "fleet_sweep": sweep, "journal_rows": True}
    jt, pt = jcore.build_test(dict(opts)), pcore.build_test(dict(opts))
    js, ps = jcore.FleetSpec.from_test(jt), pcore.FleetSpec.from_test(pt)
    for i in range(3):
        jo, po = js.cluster_opts(jt, i), ps.cluster_opts(pt, i)
        assert po["fleet"] == 1 and po["mesh"] is None
        assert po["resume"] is None and po["journal_rows"] is False
        assert "generator" not in po and "checker" not in po
        for k in ("seed", "nemesis_seed", "rate", "fleet", "fleet_sweep",
                  "journal_rows", "audit"):
            assert po.get(k) == jo.get(k), (i, k)


# --- byte-equal fleets -------------------------------------------------------

def test_seed_sweep_matches_jax_and_solos(tmp_root):
    """The cheapest contract config: a 2-cluster broadcast fleet of seeds
    7 and 8, equal to JAX's fleet and to the standalone runs, with the
    fleet's host reads O(waves), not O(rounds). Uniform latency gives
    each cluster draws of its own seed (spill channels, K9's path); at
    this rate the two histories still come out the same."""
    opts = {**BROADCAST, **UNIFORM, "fleet": 2}
    port = _check(opts, tmp_root)
    assert len(port[0][0]) > 1000
    _clusters, res = _fleet("port", opts, tmp_root)
    assert max(res["final-rounds"]) > 400
    assert 0 < res["drains"] < max(res["final-rounds"]) // 4


def test_sessions_backends_give_the_same_bytes(tmp_root):
    """--sessions coroutine (one dict table a shell) and the default
    columnar table give the same fleet, byte for byte."""
    col = _fleet("port", {**BROADCAST, **UNIFORM, "fleet": 2}, tmp_root)
    cor = _fleet("port", {**BROADCAST, **UNIFORM, "fleet": 2,
                          "sessions": "coroutine"}, tmp_root)
    assert [h for h, _r in col[0]] == [h for h, _r in cor[0]]
    assert [_strip(r) for _h, r in col[0]] == [_strip(r) for _h, r in cor[0]]
    assert col[1]["sessions"] == "columnar"
    assert cor[1]["sessions"] == "coroutine"


def test_capacity_sweep_matches_jax_and_solos(tmp_root):
    """--fleet-sweep capacity: cluster i offers rate * (i + 1)."""
    port = _check({**BROADCAST, "fleet": 2, "fleet_sweep": "capacity"},
                  tmp_root)
    assert len(port[1][0]) > len(port[0][0])


# --- the CLI -----------------------------------------------------------------

def test_cli_fleet_writes_cluster_stores(tmp_path):
    """`test --fleet 2` through the port's CLI: per-cluster stores, the
    fleet results and timing.json with the fleet's counters."""
    rc = pcli.main(["test", "-w", "broadcast", "--node", "tpu:broadcast",
                    "--node-count", "5", "--rate", "10", "--time-limit",
                    "0.3", "--seed", "7", "--fleet", "2", "--device", "cpu",
                    "--store", str(tmp_path)])
    assert rc == 0
    d = os.path.realpath(os.path.join(tmp_path, "latest"))
    assert os.path.exists(os.path.join(d, "cluster-0001", "history.jsonl"))
    with open(os.path.join(d, "results.json")) as f:
        res = json.load(f)
    assert res["fleet"] == 2 and res["valid"] is True
    assert res["sessions"] == "columnar"
    with open(os.path.join(d, "timing.json")) as f:
        timing = json.load(f)
    assert timing["waves"] > 0 and timing["scan-rounds"] > 0
    assert timing["hold-row-bytes"] > 0


@pytest.mark.parametrize("extra,what", [
    (["--nemesis", "byzantine"], "does not compose with --fleet"),
    (["--continuous"], "continuous fleet"),
    (["--telemetry"], "continuous fleet"),
    (["--mesh", "2,1"], "multi-GPU"),
    (["--checkpoint-every", "1"], "checkpoint and resume"),
    (["-w", "kafka", "--node", "tpu:kafka"], "fleets of kafka"),
    (["-w", "echo", "--node", "tpu:echo"], "pool-path programs"),
    (["-w", "lin-kv", "--node", "tpu:compartment"], "role partitions"),
    (["-w", "broadcast-batched", "--node", "tpu:broadcast-batched"],
     "batched broadcast"),
    (["--node", "tpu:solo:broadcast"], "role partitions"),
    (["-w", "lin-kv", "--ordering", "raft", "--node", None],
     "fleets of kafka")])
def test_cli_refuses_fleet_combinations(extra, what, tmp_path, capsys):
    args = ["test", "-w", "broadcast", "--node", "tpu:broadcast",
            "--node-count", "3", "--fleet", "2", "--device", "cpu",
            "--store", str(tmp_path)]
    for flag, value in zip(extra[::2], extra[1::2]):
        if flag in args:
            i = args.index(flag)
            del args[i:i + 2]
        if value is not None:
            args += [flag, value]
    if extra == ["--continuous"] or extra == ["--telemetry"]:
        args += extra
    assert pcli.main(args) == 2
    err = capsys.readouterr().err
    assert what in err and "does not run it yet" in err
    assert not os.listdir(tmp_path)


def test_fleet_runner_refuses_what_the_cli_refuses():
    """The runner's own guard, for callers that skip the CLI: the
    byzantine adversary in the JAX package's words, the rest naming
    their slices."""
    base = {**BROADCAST, "fleet": 2, "device": "cpu"}
    with pytest.raises(ValueError, match="does not compose with --fleet"):
        FleetRunner(pcore.build_test({**base, "nemesis": ["byzantine"]}))
    for extra, what in (({"mesh": "2,1"}, "multi-GPU"),
                        ({"continuous": True}, "continuous fleet"),
                        ({"check_workers": 2}, "overlap pipeline")):
        with pytest.raises(NotImplementedError, match=what):
            FleetRunner(pcore.build_test({**base, **extra}))
