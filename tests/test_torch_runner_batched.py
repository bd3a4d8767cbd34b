"""The port's runner on batched atomic broadcast and on the ordering axis
against the JAX package's, end to end.

Each run goes through both packages in this process (`core.run`, the JAX
one with `audit` off and `no_overlap` on, or the CLI, the JAX one with
--no-audit --no-overlap). What must be equal, as in
`tests/test_torch_runner.py`: history.jsonl and the network journal byte
for byte, and results.json but for the transfer counters and wall
seconds; the batched checker's `proof-errors` and verdict with it, and
the net block's `sent-units`, `recv-units` and `units-per-msg`.

Tier 1 keeps the JAX package's pinned batched-broadcast run
(tests/test_ordering.py's legacy pin, md5 8a5297c4...), a short lin-kv
run over the raft engine under the CLI (its completions read the
replicas in turn, `read_state(i)`) and the CLI's ordering refusals. The
runs whose JAX history hashes `chip_smoke.py` pins (`PINNED_BATCHED`),
the other ordering combinations and the batched-vs-eager bench counts
(`PINNED_BATCHED_BENCH`) take minutes on the CPU and are marked slow."""

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

# tests/test_ordering.py's legacy batched run, with the journal's rows
# on (the history is the same either way)
LEGACY = {"workload": "broadcast-batched", "node": "tpu:broadcast-batched",
          "name": "legacy-batched", "seed": 7, "rate": 12.0,
          "time_limit": 1.6, "journal_rows": True}
LEGACY_MD5 = "8a5297c46f38c492b8f3525d55ad3af5"
ORDERED_RAFT_CLI = ["test", "-w", "lin-kv", "--ordering", "raft",
                    "--node-count", "3", "--rate", "20", "--time-limit", "1",
                    "--ms-per-round", "5", "--seed", "3"]


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


def _assert_runs_equal(jdir, pdir, journal=False):
    """`journal`: the run journals its messages (rows on)."""
    assert _read(pdir, "history.jsonl") == _read(jdir, "history.jsonl")
    jj = _tree_bytes(os.path.join(jdir, "net-journal"))
    pj = _tree_bytes(os.path.join(pdir, "net-journal"))
    assert sorted(pj) == sorted(jj)
    assert not journal or len(jj) > 1
    for k in jj:
        assert pj[k] == jj[k], k
    jr = json.loads(_read(jdir, "results.json", "r"))
    pr = json.loads(_read(pdir, "results.json", "r"))
    assert jr["valid"] is True and jr["workload"]["valid"] is True
    assert _strip(pr) == _strip(jr)
    return pr


def test_legacy_batched_run_matches_jax(tmp_path):
    """The JAX package's legacy batched-broadcast pin: the same history
    (md5 pinned by tests/test_ordering.py), journal and results, proofs
    all holding and more than one client op a message."""
    jdir = _run_jax(LEGACY, str(tmp_path / "jax"))
    pdir = _run_port(LEGACY, str(tmp_path / "port"))
    assert hashlib.md5(_read(pdir, "history.jsonl")).hexdigest() == \
        LEGACY_MD5
    pr = _assert_runs_equal(jdir, pdir, journal=True)
    w, net = pr["workload"], pr["net"]
    assert w["proof-errors"] == [] and w["lost-count"] == 0
    assert w["stable-count"] == w["batched-op-count"] > 0
    assert net["recv-units"] > net["all"]["recv-count"] > 0
    assert net["units-per-msg"] > 1.0


def test_ordered_raft_cli_matches_jax(tmp_path):
    """lin-kv over the raft engine: each completion replays the
    committed prefix from the first replica whose commit covers it,
    reading replicas in turn (`read_state(i)`)."""
    pdir = _run_port(ORDERED_RAFT_CLI, str(tmp_path / "port"))
    pr = _assert_runs_equal(_run_jax(ORDERED_RAFT_CLI,
                                     str(tmp_path / "jax")), pdir,
                            journal=True)
    assert pr["net"]["servers"]["send-count"] > 0
    hist = [json.loads(line) for line in
            _read(pdir, "history.jsonl", "r").splitlines()]
    assert any(o["type"] == "ok" and o["f"] == "read" for o in hist)


@pytest.mark.parametrize("extra,message", [
    # the compartment engine's slice, named "the role-partitioned
    # programs" until the partition landed (the id kept); the engine runs
    # since the compartment's slice and sizes its cluster from --roles
    pytest.param(["-w", "lin-kv", "--ordering", "compartment"],
                 "needs 9 nodes",
                 id="extra0-the role-partitioned programs"),
    # refused the txn-list-append applier before it was ported (the
    # id kept); the JAX package has no txn-rw-register applier either
    pytest.param(["-w", "txn-rw-register", "--ordering", "raft"],
                 "no applier serves workload 'txn-rw-register'",
                 id="extra1-the Raft transaction programs and their Elle "
                    "checkers"),
    (["-w", "lin-kv", "--node", "tpu:lin-kv", "--ordering", "raft"],
     "selects the composed program tpu:ordered"),
    (["-w", "broadcast", "--ordering", "raft"],
     "no applier serves workload 'broadcast'"),
])
def test_cli_ordering_refusals(extra, message, tmp_path, capsys):
    args = ["test", "--node-count", "3", "--device", "cpu", "--store",
            str(tmp_path)] + extra
    assert pcli.main(args) == 2
    assert message in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def _pinned():
    import chip_smoke
    return dict(chip_smoke.CLI_BATCHED + chip_smoke.CLI_ORDERED)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_pinned()))
def test_pinned_batched_runs_match_jax(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_BATCHED (the sha256 of the JAX
    runner's history.jsonl for each run) and holds the port's run on the
    CPU to the JAX run byte for byte."""
    import chip_smoke
    run = _pinned()[name]
    jdir = _run_jax(run, str(tmp_path / "jax"))
    digest = hashlib.sha256(_read(jdir, "history.jsonl")).hexdigest()
    assert digest == chip_smoke.PINNED_BATCHED[name]
    pr = _assert_runs_equal(jdir, _run_port(run, str(tmp_path / "port")))
    if run["workload"] == "broadcast-batched":
        assert pr["workload"]["proof-errors"] == []
        assert pr["workload"]["lost-count"] == 0


@pytest.mark.slow
@pytest.mark.parametrize("workload", ["lin-kv", "kafka"])
@pytest.mark.parametrize("ordering", ["raft", "batched"])
def test_ordering_combinations_match_jax(workload, ordering, tmp_path):
    """Every (engine x applier) pair at tests/test_ordering.py's base
    options (seed 7, rate 12, 1.6 s)."""
    run = {"workload": workload, "ordering": ordering, "seed": 7,
           "rate": 12.0, "time_limit": 1.6, "journal_rows": False}
    _assert_runs_equal(_run_jax(run, str(tmp_path / "jax")),
                       _run_port(run, str(tmp_path / "port")))


BENCH_KEYS = ("rounds_to_convergence", "converged", "messages_delivered",
              "units_delivered", "units_per_msg", "dropped_overflow")


def _jax_bench(monkeypatch, n, v, b=32, chunk=64):
    import bench
    for k, x in (("NODES", n), ("VALUES", v), ("BATCH", b),
                 ("CHUNK", chunk)):
        monkeypatch.setenv(f"BENCH_BB_{k}", str(x))
    return bench.bench_broadcast_batched_record()


@pytest.mark.slow
def test_batched_bench_counts_match_jax(monkeypatch):
    """The batched-vs-eager record at bench.py's CPU-fallback size
    (1,024 nodes, 256 values): each side's rounds to converge and
    delivered messages and units equal the JAX package's."""
    from maelstrom_tpu_torch.bench import run_broadcast_batched_bench
    ref = _jax_bench(monkeypatch, 1024, 256)
    got = run_broadcast_batched_bench(1024, 256, device="cpu")
    assert got["valid"] and ref["valid"]
    for r, g in zip(ref["protocols"], got["protocols"]):
        assert {k: g[k] for k in BENCH_KEYS} == {k: r[k] for k in BENCH_KEYS}
    assert got["msg_reduction"] == ref["msg_reduction"]


@pytest.mark.slow
def test_pinned_bench_counts(monkeypatch):
    """Re-derives chip_smoke.py's PINNED_BATCHED_BENCH: the JAX record
    at its defaults (4,096 nodes, 512 values; some forty minutes on the
    CPU)."""
    import chip_smoke
    ref = _jax_bench(monkeypatch, **{
        "n": chip_smoke.BATCHED_BENCH["n_nodes"],
        "v": chip_smoke.BATCHED_BENCH["values"],
        "b": chip_smoke.BATCHED_BENCH["batch"],
        "chunk": chip_smoke.BATCHED_BENCH["chunk"]})
    assert ref["valid"]
    for r in ref["protocols"]:
        assert {k: r[k] for k in chip_smoke.BENCH_PIN_KEYS} == \
            chip_smoke.PINNED_BATCHED_BENCH[r["protocol"]]
