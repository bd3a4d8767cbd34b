"""The port's runner on the pool-path and CRDT programs against the JAX
package's, end to end: echo, unique-ids, g-set, pn-counter, g-counter.

Each run goes through both packages in this process: the CLI (`test -w
echo ...`, the JAX one with --no-audit) where the options are CLI
options, else `core.run`, whose options are the JAX CLI's plus those it
has no flag for (`gossip_fanout`, `recovery_s`), with `audit` off in
JAX. What must be equal, as in `tests/test_torch_runner.py`:
history.jsonl and the network journal byte for byte, and results.json
but for the transfer counters and wall seconds (`WALL_KEYS`).

Tier 1 keeps one short run a workload, at 5 ms a round so that a run is
a few hundred rounds. The runs of `tests/test_tpu_e2e.py` and
`tests/test_tpu_crdt.py` (echo at 5 nodes, g-set at 20 nodes with gossip
fanout 3 and 5% loss, pn-counter at 5 nodes under partitions, g-counter
at 5 nodes at 5 ms a round) and unique-ids at Gossip Glomers'
challenge-2 shape (3 nodes, rate 1000, partitions, cut to 1.25 s) take
minutes on the CPU and are marked slow: they also re-derive the history
hashes `chip_smoke.py` pins (`PINNED_POOL`, `PINNED_CRDT`)."""

from __future__ import annotations

import hashlib
import json
import os

import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu import core as jcore
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import core as pcore
from test_torch_runner import _strip, _tree_bytes

# tier 1: (CLI args) or {core.run options}
FAST = {
    "echo5": ["test", "-w", "echo", "--node", "tpu:echo", "--node-count",
              "5", "--rate", "20", "--time-limit", "1", "--ms-per-round",
              "5", "--seed", "7"],
    "unique-ids3-partition": {
        "workload": "unique-ids", "node": "tpu:unique-ids",
        "node_count": 3, "rate": 50.0, "nemesis": {"partition"},
        "nemesis_interval": 0.3, "time_limit": 1.0, "ms_per_round": 5.0,
        "seed": 7},
    "g-set8-fanout3-loss": {
        "workload": "g-set", "node": "tpu:g-set", "node_count": 8,
        "gossip_fanout": 3, "p_loss": 0.05, "max_values": 64, "rate": 20.0,
        "time_limit": 0.6, "recovery_s": 0.4, "ms_per_round": 5.0,
        "seed": 11},
    "pn-counter5-partition": {
        "workload": "pn-counter", "node": "tpu:pn-counter", "node_count": 5,
        "nemesis": {"partition"}, "nemesis_interval": 0.3, "rate": 20.0,
        "time_limit": 0.6, "recovery_s": 0.4, "ms_per_round": 5.0,
        "seed": 11},
    "g-counter5": {
        "workload": "g-counter", "node": "tpu:g-counter", "node_count": 5,
        "rate": 20.0, "time_limit": 0.6, "recovery_s": 0.4,
        "ms_per_round": 5.0, "seed": 11},
}


def _pinned():
    """The runs whose JAX history hashes `chip_smoke.py` pins, by name."""
    import chip_smoke
    return {**dict(chip_smoke.CLI_POOL), **dict(chip_smoke.CLI_CRDT)}


def _pins():
    import chip_smoke
    return {**chip_smoke.PINNED_POOL, **chip_smoke.PINNED_CRDT}


def _run_jax(run, store):
    if isinstance(run, list):
        assert jcli.main(run + ["--no-audit", "--store", store]) == 0
    else:
        res = jcore.run({**run, "store_root": store, "audit": False})
        assert res["valid"] is True
    return os.path.realpath(os.path.join(store, "latest"))


def _run_port(run, store):
    if isinstance(run, list):
        assert pcli.main(run + ["--device", "cpu", "--store", store]) == 0
    else:
        res = pcore.run({**run, "store_root": store, "device": "cpu"})
        assert res["valid"] is True
    return os.path.realpath(os.path.join(store, "latest"))


def _read(d, name, mode="rb"):
    with open(os.path.join(d, name), mode) as f:
        return f.read()


def _assert_runs_equal(jdir, pdir):
    assert _read(pdir, "history.jsonl") == _read(jdir, "history.jsonl")
    jj = _tree_bytes(os.path.join(jdir, "net-journal"))
    pj = _tree_bytes(os.path.join(pdir, "net-journal"))
    assert sorted(pj) == sorted(jj) and len(jj) > 1
    for k in jj:
        assert pj[k] == jj[k], k
    jr = json.loads(_read(jdir, "results.json", "r"))
    pr = json.loads(_read(pdir, "results.json", "r"))
    assert jr["valid"] is True and jr["workload"]["valid"] is True
    assert _strip(pr) == _strip(jr)
    return pr


@pytest.mark.parametrize("name", list(FAST))
def test_runs_match_jax(name, tmp_path):
    run = FAST[name]
    pdir = _run_port(run, str(tmp_path / "port"))
    pr = _assert_runs_equal(_run_jax(run, str(tmp_path / "jax")), pdir)
    assert pr["stats"]["count"] > 5
    if name.startswith(("echo", "unique")):
        # the pool path: client replies only, no node-to-node traffic
        assert pr["net"]["servers"]["send-count"] == 0
    else:
        assert pr["net"]["servers"]["send-count"] > 0
    if "partition" in name:
        assert b'"start-partition"' in _read(pdir, "history.jsonl")


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_pinned()))
def test_pinned_runs_match_jax(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_POOL and PINNED_CRDT (the sha256
    of the JAX runner's history.jsonl for each run) and holds the port's
    run on the CPU to the JAX run byte for byte."""
    run = _pinned()[name]
    jdir = _run_jax(run, str(tmp_path / "jax"))
    digest = hashlib.sha256(_read(jdir, "history.jsonl")).hexdigest()
    assert digest == _pins()[name]
    _assert_runs_equal(jdir, _run_port(run, str(tmp_path / "port")))
