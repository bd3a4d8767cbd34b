"""The port's runner on the kafka program against the JAX package's, end
to end: `test -w kafka`, classic and with consumer groups.

Each run goes through both packages in this process: the CLI (`test -w
kafka ...`, the JAX one with --no-audit and --no-overlap, since the port
has no overlapped analysis pipeline and the kafka checker's verdict is
the same either way) where the options are CLI options, else
`core.run` (`audit` off and `no_overlap` on in JAX). What must be
equal, as in `tests/test_torch_runner.py`: history.jsonl and the network
journal byte for byte, and results.json but for the transfer counters
and wall seconds (`WALL_KEYS`). The port's runner reads node state at
the host for polls and fetches (`_read_state`), routes sends to the
key's owner and commits to the coordinator (`node_for_op`), and crosses
reply-bearing stretches because kafka's state reads are final.

Tier 1 keeps three short runs at 5 ms a round: classic, groups 2, and 8
keys in two groups of 8 members under the kill nemesis (evictions,
fenced commits, rebalances). The runs whose JAX history hashes
`chip_smoke.py` pins (`PINNED_KAFKA`: the JAX package's kafka e2e
configs and Gossip Glomers' challenge 5b, cut to 1.5 s) take minutes on
the CPU and are marked slow."""

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

BASE = ["test", "-w", "kafka", "--node", "tpu:kafka", "--node-count", "5",
        "--ms-per-round", "5"]
FAST = {
    "classic5": BASE + ["--rate", "20", "--time-limit", "1", "--seed", "7"],
    "groups2": BASE + ["--rate", "20", "--time-limit", "1", "--seed", "11",
                       "--kafka-groups", "2"],
    "wide8-groups2-kill": BASE + [
        "--rate", "60", "--time-limit", "1", "--seed", "5",
        "--concurrency", "8", "--key-count", "8", "--kafka-groups", "2",
        "--session-timeout-ms", "400", "--timeout-ms", "800",
        "--nemesis", "kill", "--nemesis-interval", "0.3"],
}


def _run_jax(run, store):
    if isinstance(run, list):
        assert jcli.main(run + ["--no-audit", "--no-overlap", "--store",
                                store]) == 0
    else:
        res = jcore.run({**run, "store_root": store, "audit": False,
                         "no_overlap": True})
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


def _assert_runs_equal(jdir, pdir, journal=True):
    assert _read(pdir, "history.jsonl") == _read(jdir, "history.jsonl")
    if journal:
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
def test_kafka_runs_match_jax(name, tmp_path):
    run = FAST[name]
    pdir = _run_port(run, str(tmp_path / "port"))
    pr = _assert_runs_equal(_run_jax(run, str(tmp_path / "jax")), pdir)
    w = pr["workload"]
    assert w["acked-sends"] > 0 and w["polls"] > 0
    assert pr["net"]["servers"]["send-count"] > 0
    assert pr["net"]["log-overflow"] == 0
    hist = [json.loads(line) for line in
            _read(pdir, "history.jsonl", "r").splitlines()]
    if "groups" in name:
        assert any(o.get("f") == "subscribe" and o["type"] == "ok"
                   for o in hist)
    if "kill" in name:
        fenced = [o for o in hist if o.get("f") == "commit"
                  and o["type"] == "fail"
                  and (o.get("error") or [None])[0] == "rebalanced"]
        assert fenced


def _pinned():
    """The runs whose JAX history hashes `chip_smoke.py` pins, by name."""
    import chip_smoke
    return dict(chip_smoke.CLI_KAFKA)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_pinned()))
def test_pinned_kafka_runs_match_jax(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_KAFKA (the sha256 of the JAX
    runner's history.jsonl for each run) and holds the port's run on the
    CPU to the JAX run byte for byte."""
    import chip_smoke
    run = _pinned()[name]
    jdir = _run_jax(run, str(tmp_path / "jax"))
    digest = hashlib.sha256(_read(jdir, "history.jsonl")).hexdigest()
    assert digest == chip_smoke.PINNED_KAFKA[name]
    _assert_runs_equal(jdir, _run_port(run, str(tmp_path / "port")),
                       journal=isinstance(run, list))
