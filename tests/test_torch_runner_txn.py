"""The port's runner on the Raft transaction programs and lin-mutex
against the JAX package's, end to end: `test -w txn-list-append` (graded
by Elle, with the device path on and off), `-w txn-rw-register`, `-w
lin-mutex --node tpu:lin-kv` and `-w txn-list-append --ordering raft`.

Each run goes through both packages in this process, the JAX one with
--no-audit and --no-overlap (the port has no overlapped analysis
pipeline, whose windows would otherwise sit in the workload block).
What must be equal, as in `tests/test_torch_runner.py`: history.jsonl
and the network journal byte for byte, and results.json but for the
transfer counters and wall seconds (`WALL_KEYS`, and the device
checker's wall seconds). The port runs Elle's device path (K16, K17)
through their plain versions on the CPU; its `device` block (screen
verdicts and iteration counts) must equal JAX's.

Tier 1 keeps five short runs at 5 ms a round. The runs whose JAX history
hashes and device blocks `chip_smoke.py` pins (`PINNED_TXN`), and the
JAX package's own e2e configs at full depth (`tests/test_tpu_txn.py`,
`tests/test_elle_device.py`, `tests/test_txn_rw_register.py`), take
minutes on the CPU and are marked slow."""

from __future__ import annotations

import hashlib
import json
import os

import pytest

from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import core as pcore
from test_torch_runner import WALL_KEYS
from test_torch_runner_kafka import _read, _run_jax, _run_port

# the device checker's wall seconds ride the net block beside the
# transfer counters
TXN_WALL_KEYS = {**WALL_KEYS,
                 "net": WALL_KEYS["net"] + ("checker-device-s",)}

BASE = ["--node-count", "5", "--ms-per-round", "5"]
TXN = ["test", "-w", "txn-list-append", "--node", "tpu:txn-list-append",
       "--rate", "25", "--time-limit", "1", "--seed", "11"] + BASE
FAST = {
    "txn5-device-on": TXN + ["--device-checker", "on"],
    "txn5-device-off": TXN + ["--device-checker", "off"],
    "rw-register3": ["test", "-w", "txn-rw-register", "--node",
                     "tpu:txn-rw-register", "--node-count", "3", "--rate",
                     "15", "--time-limit", "1", "--seed", "7",
                     "--ms-per-round", "5"],
    "lin-mutex5": ["test", "-w", "lin-mutex", "--node", "tpu:lin-kv",
                   "--rate", "30", "--time-limit", "1.5", "--seed", "7"]
    + BASE,
    "txn5-ordered-raft": ["test", "-w", "txn-list-append", "--ordering",
                          "raft", "--rate", "25", "--time-limit", "1",
                          "--seed", "11"] + BASE,
}

# the JAX package's e2e configs of these programs at full depth, beyond
# the smoke's pinned runs: tests/test_tpu_txn.py's two raft runs
JAX_E2E = {
    "txn5-tpu-raft": {"workload": "txn-list-append",
                      "node": "tpu:txn-list-append", "node_count": 5,
                      "rate": 10.0, "time_limit": 3.0, "seed": 9,
                      "journal_rows": False},
    "txn5-tpu-raft-partition": {
        "workload": "txn-list-append", "node": "tpu:txn-list-append",
        "node_count": 5, "rate": 10.0, "time_limit": 4.0,
        "nemesis": {"partition"}, "nemesis_interval": 1.0, "seed": 9,
        "journal_rows": False},
}


def _strip(results):
    for block, keys in TXN_WALL_KEYS.items():
        for k in keys:
            results.get(block, {}).pop(k, None)
    return results


def _assert_runs_equal(jdir, pdir, journal=True):
    assert _read(pdir, "history.jsonl") == _read(jdir, "history.jsonl")
    if journal:
        from test_torch_runner import _tree_bytes
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


def _ok_count(pdir, f):
    hist = [json.loads(line) for line in
            _read(pdir, "history.jsonl", "r").splitlines()]
    return sum(1 for o in hist if o["type"] == "ok" and o.get("f") == f)


@pytest.mark.parametrize("name", list(FAST))
def test_txn_runs_match_jax(name, tmp_path):
    run = FAST[name]
    pdir = _run_port(run, str(tmp_path / "port"))
    pr = _assert_runs_equal(_run_jax(run, str(tmp_path / "jax")), pdir)
    w = pr["workload"]
    assert pr["net"]["servers"]["send-count"] > 0
    assert pr["net"]["log-overflow"] == 0
    if name == "txn5-device-on":
        # the device path engaged on the CPU (plain K16, K17) and
        # certified the run
        assert w["device"]["screen"]["realtime"] == "acyclic"
        assert pr["net"]["checker-device-calls"] == 1
    if name in ("txn5-device-off", "txn5-ordered-raft"):
        assert "device" not in w and "checker-device-calls" not in pr["net"]
    if name.startswith("txn5"):
        assert _ok_count(pdir, "txn") > 5
    if name == "rw-register3":
        assert w["ok-count"] > 5 and w["wr-edge-count"] > 0
    if name == "lin-mutex5":
        assert w["acquire-release-ops"] > 1 and w["mutex"]["valid"] is True


def test_device_on_and_off_grade_alike(tmp_path):
    """The device path changes nothing but the `device` block: the
    workload verdict, anomaly types and models equal the host path's."""
    on = _run_port(FAST["txn5-device-on"], str(tmp_path / "on"))
    off = _run_port(FAST["txn5-device-off"], str(tmp_path / "off"))
    assert _read(on, "history.jsonl") == _read(off, "history.jsonl")
    won = json.loads(_read(on, "results.json", "r"))["workload"]
    woff = json.loads(_read(off, "results.json", "r"))["workload"]
    assert won.pop("device")["edges-on-device"] is True
    assert won == woff


def test_check_workers_still_refused(tmp_path, capsys):
    """The overlap pipeline (`--check-workers`) is not ported: the txn
    workloads run post hoc, and a positive worker count is refused."""
    args = FAST["txn5-device-on"] + ["--device", "cpu", "--store",
                                     str(tmp_path), "--check-workers", "1"]
    assert pcli.main(args) == 2
    err = capsys.readouterr().err
    assert "the overlap pipeline" in err and "does not run it yet" in err
    assert not os.listdir(tmp_path)


def test_txn_workloads_build_on_their_programs():
    for w, node in (("txn-list-append", "tpu:txn-list-append"),
                    ("txn-rw-register", "tpu:txn-rw-register"),
                    ("lin-mutex", "tpu:lin-kv")):
        test = pcore.build_test({"workload": w, "node": node})
        assert test["node"] == node
        assert test["checker"].checkers["workload"] is not None
    test = pcore.build_test({"workload": "txn-list-append",
                             "ordering": "batched"})
    assert test["node"] == "tpu:ordered"


def _pinned():
    """The runs whose JAX history hashes `chip_smoke.py` pins, by name."""
    import chip_smoke
    return dict(chip_smoke.CLI_TXN)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_pinned()))
def test_pinned_txn_runs_match_jax(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_TXN (the sha256 of the JAX
    runner's history.jsonl and its Elle `device` block for each run)
    and holds the port's run on the CPU to the JAX run byte for byte."""
    import chip_smoke
    run = _pinned()[name]
    jdir = _run_jax(run, str(tmp_path / "jax"))
    digest = hashlib.sha256(_read(jdir, "history.jsonl")).hexdigest()
    device = json.loads(_read(jdir, "results.json", "r"))["workload"].get(
        "device")
    assert (digest, device) == chip_smoke.PINNED_TXN[name]
    _assert_runs_equal(jdir, _run_port(run, str(tmp_path / "port")),
                       journal=run.get("journal_rows", True))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(JAX_E2E))
def test_jax_e2e_txn_runs_match(name, tmp_path):
    run = JAX_E2E[name]
    _assert_runs_equal(_run_jax(run, str(tmp_path / "jax")),
                       _run_port(run, str(tmp_path / "port")),
                       journal=False)
