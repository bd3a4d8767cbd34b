"""The port's CLI runner under faults against the JAX package's, end to end.

The same `test -w broadcast` command with a nemesis runs in both packages
in this process (the JAX CLI on the CPU with --no-audit, the port's with
--device cpu), and must give the same history.jsonl and network journal
byte for byte and the same results.json but for the wall-clock and
host-read keys (`WALL_KEYS` of `tests/test_torch_runner.py`). The two
runs:

  - the README's 25-node tree4 run with its partition nemesis, every
    half second of a 2 s test;
  - a 5-node grid storm: exponential latency of mean 3 ms, 2% loss, and
    the partition, kill, pause, duplicate and weather nemeses every half
    second of a 4 s test, seed 23.

Both at the e2e tests' rate 20 with a 64-value table, and journaled
(clusters of 64 nodes or fewer). `chip_smoke.py` pins the JAX runner's
history hashes of these runs and of a 1,024-node grid run under faults
(`CLI_FAULTS_SMALL`, `PINNED_FAULTS`); the slow test here re-derives
them."""

from __future__ import annotations

import hashlib
import json
import os

import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu_torch import cli as pcli
from test_torch_runner import _run, _strip, _tree_bytes


def _fault_runs():
    """[(name, args)] of chip_smoke.py's pinned fault runs."""
    import chip_smoke
    return [(name, list(args)) for name, args in chip_smoke.CLI_FAULTS_SMALL]


@pytest.mark.parametrize("name", ["tree4-25-partition", "grid5-storm"])
def test_cli_under_faults_matches_jax(name, tmp_path):
    args = dict(_fault_runs())[name]
    jdir = _run(jcli.main, args + ["--no-audit"], str(tmp_path / "jax"))
    pdir = _run(pcli.main, args + ["--device", "cpu"],
                str(tmp_path / "port"))
    with open(os.path.join(jdir, "history.jsonl"), "rb") as f:
        jh = f.read()
    with open(os.path.join(pdir, "history.jsonl"), "rb") as f:
        ph = f.read()
    assert ph == jh
    jj = _tree_bytes(os.path.join(jdir, "net-journal"))
    pj = _tree_bytes(os.path.join(pdir, "net-journal"))
    assert sorted(pj) == sorted(jj) and len(jj) > 1
    for k in jj:
        assert pj[k] == jj[k], k
    with open(os.path.join(jdir, "results.json")) as f:
        jr = json.load(f)
    with open(os.path.join(pdir, "results.json")) as f:
        pr = json.load(f)
    assert jr["valid"] is True
    assert _strip(pr) == _strip(jr)
    # the faults happened: nemesis ops in the history, drops counted
    nem = [json.loads(line) for line in ph.decode().splitlines()
           if '"nemesis"' in line]
    fs = {op["f"] for op in nem}
    assert "start-partition" in fs and "stop-partition" in fs
    assert pr["net"]["dropped-partition"] > 0
    if name == "grid5-storm":
        assert {"start-kill", "start-pause", "start-duplicate",
                "start-weather"} <= fs
        for key in ("lost", "dropped-down", "duplicated"):
            assert pr["net"][key] > 0, key
        assert "failover-recovery-rounds" in pr["availability"]


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n, _a in _fault_runs()])
def test_pinned_fault_cli_hashes(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_FAULTS: the sha256 of the JAX
    runner's history.jsonl for each of its cli_faults_small runs (the
    1,024-node run takes minutes on the CPU)."""
    import chip_smoke
    args = dict(_fault_runs())[name]
    jdir = _run(jcli.main, args + ["--no-audit"], str(tmp_path))
    with open(os.path.join(jdir, "history.jsonl"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    assert digest == chip_smoke.PINNED_FAULTS[name]
