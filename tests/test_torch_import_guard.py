"""The port stands alone: every module of `maelstrom_tpu_torch` imports
with `jax`, `flax` and `maelstrom_tpu` blocked, and its entry points run
on the CUDA device unless the caller names the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from maelstrom_tpu_torch import cli, core
from maelstrom_tpu_torch.bench import (bench_byzantine_record,
                                       bench_checkers_record,
                                       bench_compartment_record,
                                       bench_fleet_record,
                                       run_broadcast_batched_bench,
                                       run_broadcast_bench, run_raft_bench)
from maelstrom_tpu_torch.checkers.elle import analyze
from maelstrom_tpu_torch.testing.histories import random_append_history
from maelstrom_tpu_torch.fuzz import fuzz_broadcast, fuzz_kafka
from maelstrom_tpu_torch.net.tpu import NetConfig
from maelstrom_tpu_torch.nodes import get_program
from maelstrom_tpu_torch.parallel import make_cluster_round_fn, \
    make_cluster_sims, make_fleet_sims
from maelstrom_tpu_torch.runner.fleet_runner import FleetRunner, \
    run_fleet_test
from maelstrom_tpu_torch.runner.sessions import ColumnarSessions, \
    SessionView
from maelstrom_tpu_torch.runner.tpu_runner import run_tpu_test
from maelstrom_tpu_torch.sim import make_fleet_scan_fn, make_run_fn, \
    make_scan_fn, make_sim
from maelstrom_tpu_torch.telemetry import TelemetrySession, make_ring, \
    render_top

ROOT = os.path.join(os.path.dirname(__file__), "..")

GUARD = """
import ast, pkgutil, sys
for name in ("jax", "flax", "maelstrom_tpu"):
    sys.modules[name] = None
import maelstrom_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(maelstrom_tpu_torch.__path__,
                                              "maelstrom_tpu_torch.")]
for m in mods:
    __import__(m)
# the chip smoke imports inside its phases: import it, then every module
# any of its import statements names
import chip_smoke
with open(chip_smoke.__file__) as f:
    tree = ast.parse(f.read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for alias in node.names:
            __import__(alias.name)
    elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
        __import__(node.module)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax",
       "jaxlib", "maelstrom_tpu") and sys.modules[m] is not None]
assert not bad, bad
print(len(mods))
"""


def test_port_imports_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 72    # every module was imported


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    # decided inside the test: on a machine with a card this check is
    # about the default, not about its absence
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes = [f"n{i}" for i in range(4)]
    opts = {"max_values": 8}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_program("broadcast", opts, nodes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_program("lin-kv", {}, nodes)
    for name in ("echo", "unique-ids", "g-set", "pn-counter", "g-counter",
                 "kafka", "broadcast-batched", "txn-list-append",
                 "txn-rw-register", "services", "solo:echo", "solo:lin-kv"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_program(name, {}, nodes)
    for engine in ("raft", "batched"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_program("ordered", {"workload": "lin-kv",
                                    "ordering": engine}, nodes)
    nine = [f"n{i}" for i in range(9)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_program("compartment", {}, nine)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_program("ordered", {"workload": "kafka",
                                "ordering": "compartment"}, nine)
    raft = get_program("lin-kv", {}, nodes, device="cpu")
    prog = get_program("broadcast", opts, nodes, device="cpu")
    cfg = NetConfig(n_nodes=4, n_clients=1)
    args = ["test", "-w", "broadcast", "--node", "tpu:broadcast",
            "--node-count", "4", "--store", str(tmp_path)]
    for call in (lambda: make_sim(prog, cfg), lambda: make_run_fn(prog, cfg),
                 lambda: make_scan_fn(prog, cfg),
                 lambda: run_broadcast_bench(n_nodes=4, values=2,
                                             rounds=4),
                 lambda: run_tpu_test(core.build_test({
                     "workload": "broadcast", "node": "tpu:broadcast",
                     "node_count": 4}), str(tmp_path)),
                 lambda: make_cluster_sims(raft, cfg, 3),
                 lambda: make_cluster_round_fn(raft, cfg),
                 lambda: run_raft_bench(clusters=2, rounds=2),
                 lambda: cli.main(args),
                 lambda: cli.main(["test", "-w", "lin-kv", "--node",
                                   "tpu:lin-kv", "--node-count", "3",
                                   "--store", str(tmp_path)]),
                 lambda: cli.main(["test", "-w", "echo", "--node",
                                   "tpu:echo", "--node-count", "3",
                                   "--store", str(tmp_path)]),
                 lambda: core.run({"workload": "pn-counter",
                                   "node": "tpu:pn-counter",
                                   "node_count": 3,
                                   "store_root": str(tmp_path)}),
                 lambda: cli.main(["test", "-w", "kafka", "--node",
                                   "tpu:kafka", "--node-count", "3",
                                   "--store", str(tmp_path)]),
                 lambda: cli.main(["test", "-w", "broadcast-batched",
                                   "--node", "tpu:broadcast-batched",
                                   "--node-count", "3", "--store",
                                   str(tmp_path)]),
                 lambda: cli.main(["test", "-w", "kafka", "--ordering",
                                   "batched", "--node-count", "3",
                                   "--store", str(tmp_path)]),
                 lambda: run_broadcast_batched_bench(n_nodes=4, values=8,
                                                     batch=4, chunk=4),
                 lambda: cli.main(["test", "-w", "txn-list-append",
                                   "--node", "tpu:txn-list-append",
                                   "--node-count", "3", "--store",
                                   str(tmp_path)]),
                 lambda: cli.main(["test", "-w", "lin-mutex", "--node",
                                   "tpu:lin-kv", "--node-count", "3",
                                   "--store", str(tmp_path)]),
                 lambda: analyze(random_append_history(1, n_txn=20),
                                 device="on"),
                 lambda: bench_checkers_record(n_rows=40, elle_ops=40),
                 lambda: fuzz_broadcast(n_nodes=4, values=2),
                 lambda: fuzz_kafka(n_nodes=3, store_root=str(tmp_path)),
                 lambda: make_scan_fn(prog, cfg, sched_inject=True),
                 lambda: cli.main(["test", "-w", "kafka", "--node",
                                   "tpu:kafka", "--node-count", "3",
                                   "--continuous", "--kafka-groups", "2",
                                   "--telemetry", str(tmp_path / "tel"),
                                   "--store", str(tmp_path)]),
                 lambda: cli.main(["test", "-w", "lin-tso", "--node",
                                   "tpu:services", "--nemesis", "kill",
                                   "--nemesis-targets", "kill=lww-kv",
                                   "--store", str(tmp_path)]),
                 lambda: cli.main(["test", "-w", "lin-kv", "--node",
                                   "tpu:solo:lin-kv", "--node-count", "3",
                                   "--store", str(tmp_path)]),
                 lambda: cli.main(["test", "-w", "lin-kv", "--node",
                                   "tpu:compartment", "--store",
                                   str(tmp_path)]),
                 lambda: bench_compartment_record(proxies=[1]),
                 lambda: cli.main(["test", "-w", "lin-kv", "--node",
                                   "tpu:compartment", "--nemesis",
                                   "byzantine", "--byz-attacks",
                                   "equivocation", "--store",
                                   str(tmp_path)]),
                 lambda: bench_byzantine_record(),
                 # the fleet slice's entry points
                 lambda: make_fleet_sims(raft, cfg, [1, 2]),
                 lambda: make_fleet_scan_fn(raft, cfg),
                 lambda: cli.main(args + ["--fleet", "2"]),
                 lambda: cli.main(["test", "-w", "lin-kv", "--node",
                                   "tpu:lin-kv", "--node-count", "3",
                                   "--fleet", "2", "--fleet-sweep",
                                   "nemesis", "--nemesis", "partition",
                                   "--store", str(tmp_path)]),
                 lambda: FleetRunner(core.build_test({
                     "workload": "broadcast", "node": "tpu:broadcast",
                     "node_count": 4, "fleet": 2})),
                 lambda: run_fleet_test(core.build_test({
                     "workload": "broadcast", "node": "tpu:broadcast",
                     "node_count": 4, "fleet": 2}), str(tmp_path)),
                 lambda: ColumnarSessions(64, 4),
                 lambda: SessionView(ColumnarSessions(1, 4,
                                                      device_reduce=True),
                                     0),
                 lambda: bench_fleet_record(sizes=[1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not any(tmp_path.iterdir())      # refused before any store dir
    # the flight recorder's pieces build on the CPU when asked
    assert make_ring(NetConfig(n_nodes=4, n_clients=2, telemetry=True),
                     "cpu").req_round.tolist() == [-1, -1]
    session = TelemetrySession(str(tmp_path / "tel"))
    session.close()
    assert "no records" in render_top([])


BROADCAST4 = ["test", "-w", "broadcast", "--node", "tpu:broadcast",
              "--node-count", "4", "--max-values", "8"]
# the entry points on the CPU when asked: one case a run, each bounded in
# rounds (a short client timeout where a kill strands an op)
CPU_RUNS = {
    "broadcast": BROADCAST4 + ["--time-limit", "0.2"],
    "broadcast-faults": BROADCAST4 + [
        "--time-limit", "0.4", "--nemesis", "partition,kill",
        "--nemesis-interval", "0.1", "--latency", "2", "--latency-dist",
        "uniform", "--p-loss", "0.1", "--timeout-ms", "300"],
    # too short a run for every op kind to complete, so the stats
    # checker's verdict is not asked for
    "lin-kv": {"workload": "lin-kv", "node": "tpu:lin-kv", "node_count": 3,
               "time_limit": 0.3, "rate": 20},
    "unique-ids": ["test", "-w", "unique-ids", "--node", "tpu:unique-ids",
                   "--node-count", "3", "--time-limit", "0.2",
                   "--ms-per-round", "5"],
    "pn-counter": {"workload": "pn-counter", "node": "tpu:pn-counter",
                   "node_count": 3, "time_limit": 0.2, "recovery_s": 0.1,
                   "ms_per_round": 5.0},
    # continuous mode with the flight recorder
    "echo-continuous": ["test", "-w", "echo", "--node", "tpu:echo",
                        "--node-count", "3", "--time-limit", "0.2",
                        "--continuous", "--telemetry"],
    # the in-cluster services, targeted faults, a one-role partition
    "lin-tso-targeted": ["test", "-w", "lin-tso", "--node", "tpu:services",
                         "--time-limit", "0.2", "--ms-per-round", "5",
                         "--nemesis", "kill,pause", "--nemesis-interval",
                         "0.05", "--nemesis-targets",
                         "kill=lww-kv,pause=seq-kv", "--timeout-ms", "200"],
    # a fleet of two clusters under a partition nemesis
    "broadcast-fleet": BROADCAST4 + ["--time-limit", "0.2", "--fleet", "2",
                                     "--nemesis", "partition",
                                     "--nemesis-interval", "0.1"],
    "solo-echo": ["test", "-w", "echo", "--node", "tpu:solo:echo",
                  "--node-count", "3", "--time-limit", "0.2",
                  "--ms-per-round", "5"],
    # the compartment, its cluster sized by --roles (as lin-kv's, too
    # short a run for the stats checker's verdict)
    "compartment": {"workload": "lin-kv", "node": "tpu:compartment",
                    "roles": "proxies=1,acceptors=1x2,replicas=1",
                    "time_limit": 0.3, "rate": 20, "ms_per_round": 5.0},
    # the byzantine adversary on an elected tier (stale ballots) and on
    # the batched broadcast (forged proofs; the run itself fails)
    "compartment-byzantine": {
        "workload": "lin-kv", "node": "tpu:compartment",
        "roles": "sequencers=2,proxies=1,acceptors=1x2,replicas=1",
        "time_limit": 0.4, "rate": 20, "ms_per_round": 5.0,
        "nemesis": {"byzantine"}, "nemesis_interval": 0.1,
        "nemesis_targets": "byzantine=sequencers",
        "byz_attacks": "stale-ballot"},
}


@pytest.mark.parametrize("name", list(CPU_RUNS))
def test_entry_points_run_on_the_cpu_when_asked(name, tmp_path):
    run = CPU_RUNS[name]
    if isinstance(run, list):
        assert cli.main(run + ["--device", "cpu", "--store",
                               str(tmp_path)]) == 0
        return
    res = core.run({**run, "device": "cpu", "store_root": str(tmp_path)})
    assert res["workload"]["valid"] is True and res["net"]["valid"] is True
    if name == "compartment-byzantine":
        assert res["byzantine"]["valid"] is True
        assert res["byzantine"]["injected"]["stale-ballot"] > 0
    elif name not in ("lin-kv", "compartment"):
        assert res["valid"] is True
