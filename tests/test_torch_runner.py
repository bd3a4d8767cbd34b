"""The port's CLI runner against the JAX package's, end to end.

The same `test -w broadcast` command runs in both packages, in this
process: the JAX CLI on the CPU (with --no-audit, since the static-audit
and cost blocks are not ported) and the port's with --device cpu. What
must be equal:

  - history.jsonl, byte for byte;
  - the network journal (net-journal/: events.jsonl and every .npz
    chunk), byte for byte;
  - results.json, except the keys named in `WALL_KEYS`: the transfer
    counters and host-poll times (wall-clock seconds and the port's own
    count of host reads, which differs by design: the port reads a scan
    flag once a chunk of rounds, see `sim.make_scan_fn`) and the
    availability checker's wall seconds.

The three configurations are `tests/test_tpu_e2e.py`'s grid (5 nodes)
and line (8 nodes, --latency 5 constant) runs and the README's 25-node
tree4 run at --latency 10 without its nemesis, at the e2e tests' rate 20,
seed 7 and a 2 s time limit (1 s for tree4), with a 64-value table, to
keep the CPU run short (the default 1024-value table is held against
pinned JAX hashes on the card, `chip_smoke.py` phase cli_small). All
three journal every message (clusters of 64 nodes or fewer)."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import generators as pg

WALL_KEYS = {
    "net": ("drains", "host-bytes", "host-blocked-s", "host-overlapped-s",
            "host-polls", "host-poll-s", "host-wall-per-wave"),
    "availability": ("check-wall-s",),
}

BASE = ["test", "-w", "broadcast", "--node", "tpu:broadcast", "--seed",
        "7", "--rate", "20", "--max-values", "64"]
CONFIGS = {
    "grid5": ["--node-count", "5", "--topology", "grid", "--time-limit",
              "2"],
    "line8-latency5": ["--node-count", "8", "--topology", "line",
                       "--latency", "5", "--time-limit", "2"],
    "tree4-25-latency10": ["--node-count", "25", "--topology", "tree4",
                           "--latency", "10", "--time-limit", "1"],
}


def _run(main, args, store):
    rc = main(args + ["--store", store])
    assert rc == 0
    return os.path.realpath(os.path.join(store, "latest"))


def _tree_bytes(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _strip(results):
    for block, keys in WALL_KEYS.items():
        for k in keys:
            results.get(block, {}).pop(k, None)
    return results


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cli_matches_jax(name, tmp_path):
    args = BASE + CONFIGS[name]
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
    assert sorted(pj) == sorted(jj)
    assert len(jj) > 1                      # the journal holds chunks
    for k in jj:
        assert pj[k] == jj[k], k
    with open(os.path.join(jdir, "results.json")) as f:
        jr = json.load(f)
    with open(os.path.join(pdir, "results.json")) as f:
        pr = json.load(f)
    assert jr["valid"] is True
    drains = pr["net"]["drains"]
    assert _strip(pr) == _strip(jr)
    # host reads stay O(host-relevant rounds), not O(simulated rounds)
    final_round = pr["availability"]["final-round"]
    assert drains < final_round / 4


def test_free_set_rotation_matches_sorted_list():
    """`FreeSet.rotated(k)` is the JAX package's `rotate_free` list —
    sorted by str, rotated by k mod n — read lazily, as the set changes
    between views."""
    rng = np.random.default_rng(5)
    procs = list(range(137)) + ["nemesis"]
    free = pg.FreeSet(procs)
    model: set = set()
    for step in range(400):
        p = procs[rng.integers(len(procs))]
        if rng.random() < 0.6:
            free.add(p)
            model.add(p)
        else:
            free.discard(p)
            model.discard(p)
        k = int(rng.integers(0, 10_000))
        fs = sorted(model, key=str)
        want = fs[k % len(fs):] + fs[:k % len(fs)] if fs else []
        view = pg.rotate_free(free, k)
        assert list(view) == want
        assert bool(view) == bool(want)
        if want:
            assert view[0] == want[0]
        assert len(free) == len(model)


@pytest.mark.parametrize("extra,slice_", [
    # the cases that refused the byzantine adversary, which now runs, keep
    # their ids and check what stays refused beside it
    # (fleets run since the fleet slice: beside one the adversary stays
    # refused in the JAX package's words; a mesh names the multi-GPU
    # slice)
    pytest.param(["--nemesis", "byzantine", "--fleet", "2"],
                 "does not compose with --fleet",
                 id="extra0-the byzantine adversary"),
    pytest.param(["--nemesis", "kill,byzantine", "--mesh", "1,2"],
                 "the multi-GPU slice", id="extra1-the byzantine adversary"),
    # the cases that refused what now runs (--nemesis-targets, lin-tso,
    # --ordering compartment's slice name, the compartment, its elected
    # tier, --client-retries) keep their ids and check what stays refused
    # beside them
    pytest.param(["--nemesis-targets", "kill=n0", "--roles",
                  "sequencers=2", "--checkpoint-every", "1"],
                 "checkpoint and resume",
                 id="extra2-the role-partitioned programs"),
    pytest.param(["--byz-rate", "0.5", "--checkpoint-every", "1"],
                 "checkpoint and resume",
                 id="extra3-the byzantine adversary"),
    # --sessions columnar and --fleet run since the fleet slice
    # (tests/test_torch_fleet.py holds them against JAX): these cases keep
    # their ids and check what stays refused beside them
    pytest.param(["--client-retries", "3", "--sessions", "columnar",
                  "--fleet", "2", "--continuous"], "the continuous fleet",
                 id="extra4-retries and backoff"),
    # the cases that refused what now runs (--continuous, --telemetry)
    # keep their ids and check what stays refused beside them
    pytest.param(["--continuous", "--fleet", "2"], "the continuous fleet",
                 id="extra5-continuous mode"),
    pytest.param(["--fleet", "4", "--telemetry"], "the continuous fleet",
                 id="extra6-mesh and fleet"),
    pytest.param(["--mesh", "1,4"], "the multi-GPU slice",
                 id="extra7-mesh and fleet"),
    (["--checkpoint-every", "1"], "checkpoint and resume"),
    (["--resume", "x"], "checkpoint and resume"),
    # the cases that refused what now runs (--device-checker on, the
    # transaction workloads, lin-mutex) keep their ids and check what
    # those surfaces are still refused: device Elle streamed through
    # the overlap pipeline, a transaction workload on a host binary or
    # role-partitioned ordering, lin-mutex under the byzantine adversary
    pytest.param(["-w", "txn-list-append", "--node", "tpu:txn-list-append",
                  "--device-checker", "on", "--check-workers", "1"],
                 "the overlap pipeline", id="extra10-device Elle"),
    pytest.param(["--telemetry", "--checkpoint-every", "1"],
                 "checkpoint and resume", id="extra11-telemetry rings"),
    pytest.param(["--ordering", "compartment", "--roles", "sequencers=2",
                  "--mesh", "1,2"], "the multi-GPU slice",
                 id="extra12-the role-partitioned programs"),
    pytest.param(["-w", "txn-rw-register", "--bin",
                  "demo/python/txn_rw_register.py"],
                 "the host-process path",
                 id="extra13-the Raft transaction programs"),
    pytest.param(["-w", "txn-list-append", "--ordering", "compartment",
                  "--election-timeout-rounds", "90", "--fleet", "2"],
                 "the role partitions",
                 id="extra14-the Raft transaction programs"),
    pytest.param(["-w", "lin-tso", "--node", "tpu:services",
                  "--leader-lease-ms", "5", "--nemesis", "byzantine",
                  "--resume", "x"], "checkpoint and resume",
                 id="extra14-lin-mutex and lin-tso"),
    pytest.param(["-w", "lin-mutex", "--node", "tpu:lin-kv", "--nemesis",
                  "byzantine", "--byz-attacks", "equivocation", "--bin",
                  "demo/python/lin_kv.py"], "the host-process path",
                 id="extra16-lin-mutex on tpu:lin-kv"),
])
def test_cli_refuses_options_out_of_scope(extra, slice_, tmp_path,
                                          capsys):
    args = BASE + ["--node-count", "3", "--device", "cpu", "--store",
                   str(tmp_path)] + extra
    assert pcli.main(args) == 2
    err = capsys.readouterr().err
    assert slice_ in err and "does not run it yet" in err
    assert not os.listdir(tmp_path)         # refused before any run


def _pinned_runs():
    """The runs whose JAX history hashes `chip_smoke.py` pins
    (`PINNED_CLI`): [(name, args)]."""
    import chip_smoke
    return [(name, list(args)) for name, args in chip_smoke.CLI_SMALL]


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n, _a in _pinned_runs()])
def test_pinned_cli_hashes(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_CLI: the sha256 of the JAX
    runner's history.jsonl for each of its cli_small runs (the largest,
    1024 nodes, takes minutes on the CPU)."""
    import chip_smoke
    args = dict(_pinned_runs())[name]
    jdir = _run(jcli.main, args + ["--no-audit"], str(tmp_path))
    with open(os.path.join(jdir, "history.jsonl"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    assert digest == chip_smoke.PINNED_CLI[name]
