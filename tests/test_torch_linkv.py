"""The port's lin-kv test on Raft against the JAX package's, end to end.

The same `test -w lin-kv --node tpu:lin-kv` command runs in both packages
in this process: the JAX CLI on the CPU (with --no-audit) and the port's
with --device cpu. history.jsonl and the network journal must be byte
for byte equal, and results.json equal but for the wall-clock and
host-transfer keys (`test_torch_runner.WALL_KEYS`) and the JAX runner's
overlapped-analysis block, which the port does not run. The runs are
`chip_smoke.py`'s `CLI_LINKV`, whose JAX history hashes it pins
(`PINNED_LINKV`): the fault-free one here, the faulted one (5,295
rounds, a few minutes on the CPU) under `slow`. The copied WGL checker
gives the JAX checker's verdict on the recorded history and on histories
that cannot linearize, and a log capacity too small for the run makes
the run invalid through `log-overflow`."""

from __future__ import annotations

import hashlib
import json
import os

import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu.checkers.linearizable import \
    LinearizableRegisterChecker as JChecker
from maelstrom_tpu.checkers.linearizable import check_history as j_check
from maelstrom_tpu.history import History as JHistory
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import core
from maelstrom_tpu_torch.checkers.linearizable import \
    LinearizableRegisterChecker as PChecker
from maelstrom_tpu_torch.checkers.linearizable import check_history, \
    MutexModel, QueueModel, SetModel
from maelstrom_tpu_torch.history import History as PHistory
from test_torch_runner import _run, _strip, _tree_bytes


def _linkv_runs():
    import chip_smoke
    return dict(chip_smoke.CLI_LINKV)


def _read(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return f.read()


def _history(cls, raw: bytes):
    h = cls()
    for line in raw.decode().splitlines():
        op = json.loads(line)
        h.append_row(op["type"], op.get("f"), op.get("value"),
                     op.get("process"), op["time"], op.get("error"),
                     op.get("final", False))
    return h


def _both(name, tmp_path):
    """Runs one of the pinned lin-kv commands in both packages and holds
    history, journal and results equal. Returns (history bytes, the
    port's results)."""
    import chip_smoke
    args = _linkv_runs()[name]
    jdir = _run(jcli.main, args + ["--no-audit"], str(tmp_path / "jax"))
    pdir = _run(pcli.main, args + ["--device", "cpu"],
                str(tmp_path / "port"))
    jh, ph = _read(jdir, "history.jsonl"), _read(pdir, "history.jsonl")
    assert ph == jh
    assert hashlib.sha256(jh).hexdigest() == chip_smoke.PINNED_LINKV[name]
    jj = _tree_bytes(os.path.join(jdir, "net-journal"))
    pj = _tree_bytes(os.path.join(pdir, "net-journal"))
    assert sorted(pj) == sorted(jj) and len(jj) > 1
    for k in jj:
        assert pj[k] == jj[k], k
    jr = json.loads(_read(jdir, "results.json"))
    pr = json.loads(_read(pdir, "results.json"))
    jr.pop("analysis-pipeline", None)
    assert _strip(dict(pr)) == _strip(jr)
    assert pr["valid"] is True and pr["workload"]["valid"] is True
    assert pr["net"]["log-overflow"] == 0
    return jh, pr


def test_cli_linkv_matches_jax(tmp_path):
    raw, res = _both("linkv5", tmp_path)
    assert res["stats"]["by-f"]["read"]["ok-count"] > 0
    assert res["stats"]["by-f"]["write"]["ok-count"] > 0
    # the copied checker grades the recorded history as JAX's does
    assert (PChecker().check({}, _history(PHistory, raw))
            == JChecker().check({}, _history(JHistory, raw)))


@pytest.mark.slow
def test_cli_linkv_faults_matches_jax(tmp_path):
    """The faulted run: exponential latency, 2% loss, and the kill, pause,
    partition and duplicate nemeses every 0.5 s; its faults show."""
    raw, res = _both("linkv5-faults", tmp_path)
    for k in ("lost", "dropped-partition", "dropped-down", "duplicated"):
        assert res["net"][k] > 0, k
    fs = {json.loads(line)["f"] for line in raw.decode().splitlines()
          if '"nemesis"' in line}
    assert {"start-kill", "start-pause", "start-partition"} <= fs


# histories built by hand: one whose read of key 0 sees 3 after a
# completed write of 1 and no write of 3, and one whose CAS from 0 never
# applied (key 1 was never 0) yet a read sees its value, cannot
# linearize; a read concurrent with the write it sees can
BAD = [("invoke", "write", [0, 1], 0, 10), ("ok", "write", [0, 1], 0, 20),
       ("invoke", "read", [0, None], 1, 30), ("ok", "read", [0, 3], 1, 40)]
BAD_CAS = [("invoke", "cas", [1, [0, 2]], 2, 15),
           ("info", "cas", [1, [0, 2]], 2, 50),
           ("invoke", "read", [1, None], 3, 60), ("ok", "read", [1, 2], 3, 70)]
GOOD = [("invoke", "write", [0, 1], 0, 10), ("invoke", "read", [0, None], 1,
                                              20),
        ("ok", "read", [0, 1], 1, 30), ("ok", "write", [0, 1], 0, 50)]


def _built(cls, rows):
    h = cls()
    for typ, f, value, proc, t in rows:
        h.append_row(typ, f, value, proc, t)
    return h


@pytest.mark.parametrize("rows,valid", [(BAD, False), (BAD_CAS, False),
                                        (GOOD, True), (BAD + GOOD, False)])
def test_checker_matches_jax_on_built_histories(rows, valid):
    got = PChecker().check({}, _built(PHistory, rows))
    ref = JChecker().check({}, _built(JHistory, rows))
    assert got == ref
    assert got["valid"] is valid


def test_other_models_match_jax():
    """The WGL engine's other models, on small histories of each."""
    from maelstrom_tpu.checkers import linearizable as JL
    cases = [
        (MutexModel, JL.MutexModel, [
            {"f": "acquire", "value": "a", "inv": 0, "ret": 5, "ok": True},
            {"f": "acquire", "value": "b", "inv": 1, "ret": 6, "ok": True}]),
        (SetModel, JL.SetModel, [
            {"f": "add", "value": 1, "inv": 0, "ret": 2, "ok": True},
            {"f": "read", "value": [1], "inv": 3, "ret": 4, "ok": True}]),
        (QueueModel, JL.QueueModel, [
            {"f": "enqueue", "value": 1, "inv": 0, "ret": 2, "ok": True},
            {"f": "enqueue", "value": 2, "inv": 1, "ret": 3, "ok": True},
            {"f": "dequeue", "value": 2, "inv": 4, "ret": 5, "ok": True}])]
    for pm, jm, ops in cases:
        assert check_history(ops, pm()) == j_check(ops, jm())


def test_log_overflow_invalidates_run(tmp_path):
    """A run that overruns `log_cap` is flagged, not silently degraded
    (the JAX package's tests/test_tpu_raft.py at a shorter time limit)."""
    res = core.run({"workload": "lin-kv", "node": "tpu:lin-kv",
                    "node_count": 3, "log_cap": 4, "rate": 40.0,
                    "time_limit": 0.3, "timeout_ms": 200, "seed": 3,
                    "journal_rows": False, "device": "cpu",
                    "store_root": str(tmp_path)})
    assert res["net"]["log-overflow"] > 0
    assert res["net"]["valid"] is False
    assert res["valid"] is False
