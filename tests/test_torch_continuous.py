"""Continuous mode in the port against the JAX package's.

- `make_scan_fn(sched_inject=True)` (the select and fold of kernel K18,
  here its plain version) against JAX's sched-inject scan, leaf for leaf:
  the state (the metric ring of kernel K19 among it), the last round's
  client messages, k, the reply log and `im`, on the pool path (echo)
  and the edge path (lin-kv), with windows that end on k_max, on the
  first reply and on reply-log room, chunks that roll back, and rows the
  window does not reach.
- The CLI's continuous runs byte-equal to the JAX runner's (JAX without
  its overlap pipeline, which the port does not have): lin-kv and kafka
  with two consumer groups under the five-package soup (kafka with the
  ring on: the results' `net.telemetry` equal), and echo at 300 ops/s,
  whose windows batch many ops a drain.
- What stays refused: --continuous with a program whose completions
  read end-of-stretch state (`collect_replies=False`), and with
  --fleet, --mesh or --checkpoint-every.
- `-m slow`: the full-length runs whose JAX hashes `chip_smoke.py` pins
  (`PINNED_STREAM`, `PINNED_TELEMETRY`), re-derived by
      JAX_PLATFORMS=cpu python -m pytest tests/test_torch_continuous.py \\
          -m slow"""

from __future__ import annotations

import functools
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu import core as jcore
from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.sim import make_round_fn as j_make_round_fn
from maelstrom_tpu.sim import make_scan_fn as j_make_scan_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch import core as pcore
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.runner.tpu_runner import TpuRunner
from maelstrom_tpu_torch.sim import make_scan_fn as p_make_scan_fn
from test_torch_support import as_numpy, assert_trees_equal, \
    jax_tree_to_numpy

SOUP = {"kill", "pause", "partition", "duplicate", "weather"}
# request type codes: echo's T_ECHO, raft's T_READ / T_WRITE / T_CAS
ECHO, LINKV = (10,), (10, 12, 14)


@functools.lru_cache(maxsize=None)
def _setup(prog, n, Q, client_cap):
    nodes = [f"n{i}" for i in range(n)]
    opts = {"latency": {"mean": 0}}
    jprog = j_get_program(prog, opts, nodes)
    pprog = p_get_program(prog, opts, nodes, device="cpu")
    kw = dict(n_nodes=n, n_clients=Q, pool_cap=256,
              inbox_cap=jprog.inbox_cap, client_cap=client_cap,
              telemetry=True, telemetry_roles=((0, n),))
    jcfg = JT.NetConfig(**kw)
    # a mid-run start: lin-kv after its first election
    jsim = j_make_sim(jprog, jcfg, seed=11)
    if prog == "lin-kv":
        round_fn = j_make_round_fn(jprog, jcfg)
        for _ in range(60):
            jsim, _cm, _io = round_fn(jsim, JT.Msgs.empty(Q))
    return jprog, pprog, jcfg, PT.NetConfig(**kw), jsim


def _rows(n, Q, types, k_max, seed, early=False):
    """Q client requests with window offsets: most inside the window,
    some past it, a few invalid (offset -1); `early` packs them into the
    first rounds."""
    rng = np.random.default_rng(seed)
    valid = rng.random(Q) < 0.85
    hi = 4 if early else k_max + 6
    at = np.where(valid, rng.integers(0, hi, Q), -1).astype(np.int32)
    inj = {"valid": valid,
           "src": (n + np.arange(Q)).astype(np.int32),
           "dest": rng.integers(0, n, Q, dtype=np.int32),
           "due": np.zeros(Q, np.int32), "mid": np.zeros(Q, np.int32),
           "reply_to": np.full(Q, -1, np.int32),
           "type": np.asarray(types, np.int32)[
               rng.integers(0, len(types), Q)],
           "a": rng.integers(0, 4, Q, dtype=np.int32),
           "b": rng.integers(0, 5, Q, dtype=np.int32),
           "c": rng.integers(0, 5, Q, dtype=np.int32)}
    return inj, at


# (program, nodes, Q, client_cap, reply_cap, k_max, stop, chunk, early):
# windows that end on k_max, on the first reply, and on reply-log room
# (a log of 2 CW rows filled by more replies than a round's width)
SCAN_CASES = {
    "echo-kmax": ("echo", 5, 6, 12, 64, 23, False, 4, False),
    "echo-room": ("echo", 5, 24, 8, 1, 40, False, 4, True),
    "echo-stop": ("echo", 5, 6, 12, 64, 30, True, 8, False),
    "linkv-kmax": ("lin-kv", 5, 6, 12, 64, 37, False, 8, False),
    "linkv-stop": ("lin-kv", 5, 6, 12, 64, 40, True, 8, False),
    "linkv-burst": ("lin-kv", 5, 16, 4, 1, 60, False, 8, True),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_sched_inject_scan_matches_jax(case):
    prog, n, Q, cc, rcap, k_max, stop, chunk, early = SCAN_CASES[case]
    jprog, pprog, jcfg, pcfg, jsim = _setup(prog, n, Q, cc)
    inj, at = _rows(n, Q, ECHO if prog == "echo" else LINKV, k_max,
                    seed=len(case) * 7 + k_max, early=early)
    psim = convert.state_from_numpy(jax_tree_to_numpy(jsim), pprog, pcfg,
                                    device="cpu")
    out_j = j_make_scan_fn(jprog, jcfg, reply_cap=rcap, sched_inject=True)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in inj.items()}),
        jnp.asarray(at), jnp.int32(k_max), stop)
    scan = p_make_scan_fn(pprog, pcfg, reply_cap=rcap, device="cpu",
                          chunk=chunk, sched_inject=True)
    out_p = scan(psim, convert.msgs_from_numpy(inj, device="cpu"),
                 torch.from_numpy(at), k_max, stop)
    assert len(out_p) == len(out_j) == 5
    k = int(out_j[2])
    assert out_p[2] == k and 1 <= k <= k_max
    assert_trees_equal(jax_tree_to_numpy(out_j[0]), as_numpy(out_p[0]))
    assert_trees_equal(jax_tree_to_numpy(out_j[1]), as_numpy(out_p[1]))
    for name, a, b in zip(("rlog", "rounds", "rn"),
                          (out_j[3][0], out_j[3][1], out_j[3][3]),
                          (out_p[3][0], out_p[3][1], out_p[3][3])):
        assert_trees_equal(as_numpy(a), as_numpy(b), path=name)
    im = out_p[4].numpy()
    assert_trees_equal(np.asarray(out_j[4]), im, path="im")
    # im: a mid for exactly the valid rows the window reached
    reached = inj["valid"] & (at >= 0) & (at < k)
    assert np.array_equal(im >= 0, reached)
    # the ring folded every round of the window
    assert int(out_p[0].telemetry.rounds) - int(jsim.telemetry.rounds) == k
    if case.endswith("room"):
        assert k < k_max and int(out_p[3][3]) > 0
    if case.endswith("stop"):
        assert k < k_max
    if case in ("echo-room", "linkv-stop", "echo-stop"):
        # the exit fell inside a chunk: rolled back and replayed
        assert scan.replayed > 0 or k % chunk == 0


# --- the CLI, byte-equal to the JAX runner -------------------------------------

def _jax_run(opts, store):
    res = jcore.run({**opts, "store_root": store, "no_overlap": True,
                     "audit": False, "audit_trace": False})
    d = os.path.realpath(os.path.join(store, "latest"))
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        return res, f.read()


def _port_run(opts, store):
    res = pcore.run({**opts, "store_root": store, "device": "cpu"})
    d = os.path.realpath(os.path.join(store, "latest"))
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        return res, f.read()


def _in_fault_window(hist: bytes) -> list:
    """The client invokes that fall strictly inside a fault window."""
    ops = [json.loads(line) for line in hist.decode().splitlines()]
    starts = sorted(o["time"] for o in ops if o.get("f", "").startswith(
        "start-") and o["type"] == "info")
    stops = sorted(o["time"] for o in ops if o.get("f", "").startswith(
        "stop-") and o["type"] == "info")
    return [o for o in ops if o["type"] == "invoke"
            and o.get("process") != "nemesis"
            and any(s < o["time"] < e for s, e in zip(starts, stops))]


RUNS = {
    "linkv5-soup": {"workload": "lin-kv", "node": "tpu:lin-kv",
                    "node_count": 5, "rate": 10.0, "time_limit": 0.6,
                    "recovery_s": 0.3, "timeout_ms": 500, "seed": 29,
                    "continuous": True, "journal_rows": False,
                    "nemesis": SOUP, "nemesis_interval": 0.15},
    "kafka5-groups2-soup": {"workload": "kafka", "node": "tpu:kafka",
                            "node_count": 5, "rate": 20.0,
                            "time_limit": 0.6, "recovery_s": 0.3,
                            "timeout_ms": 500, "seed": 7,
                            "kafka_groups": 2, "continuous": True,
                            "journal_rows": False, "nemesis": SOUP,
                            "nemesis_interval": 0.15, "telemetry": "auto"},
    "echo5-rate300": {"workload": "echo", "node": "tpu:echo",
                      "node_count": 5, "rate": 300.0, "time_limit": 0.5,
                      "concurrency": 64, "timeout_ms": 5000, "seed": 3,
                      "latency": {"mean": 10, "dist": "constant"},
                      "continuous": True, "journal_rows": False},
}


@pytest.mark.parametrize("name", list(RUNS))
def test_continuous_cli_matches_jax(name, tmp_path):
    opts = RUNS[name]
    jres, jh = _jax_run(opts, str(tmp_path / "jax"))
    pres, ph = _port_run(opts, str(tmp_path / "port"))
    assert ph == jh
    assert pres["valid"] == jres["valid"]
    assert pres["workload"] == jres["workload"]
    assert pres["net"].get("telemetry") == jres["net"].get("telemetry")
    assert pres["perf"]["latency-ms"] == jres["perf"]["latency-ms"]
    if opts.get("nemesis"):
        assert _in_fault_window(ph), "no client op arrived mid-fault"
        assert "windows" not in pres["workload"]
    if opts.get("telemetry"):
        assert pres["net"]["telemetry"]["rounds"] > 0
    if name == "echo5-rate300":
        # one window carries many offered-rate ops
        ops = pres["stats"]["count"]
        assert pres["valid"] is True and ops > 100
        assert pres["net"]["drains"] < ops / 2


# --- what stays refused ----------------------------------------------------------

def test_continuous_rejections(tmp_path, capsys):
    opts = dict(store_root=str(tmp_path), workload="broadcast",
                node="tpu:broadcast", node_count=4, continuous=True,
                time_limit=1.0, collect_replies=False, device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        TpuRunner(pcore.build_test(dict(opts)))
    base = ["test", "-w", "lin-kv", "--node", "tpu:lin-kv", "--node-count",
            "3", "--device", "cpu", "--continuous", "--store",
            str(tmp_path / "cli")]
    for extra, slice_ in ((["--fleet", "2"], "the continuous fleet"),
                          (["--mesh", "1,2"], "the multi-GPU slice"),
                          (["--checkpoint-every", "1"],
                           "checkpoint and resume")):
        assert pcli.main(base + extra) == 2
        err = capsys.readouterr().err
        assert slice_ in err and "does not run it yet" in err
    assert not os.path.exists(tmp_path / "cli")


# --- the smoke's pins (slow) ------------------------------------------------------

def telemetry_digest(block) -> str:
    return hashlib.sha256(json.dumps(block, sort_keys=True).encode()
                          ).hexdigest()


def _stream_runs():
    import chip_smoke
    return dict(chip_smoke.CLI_STREAM)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_stream_runs()))
def test_pinned_stream_runs(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_STREAM: the sha256 of the JAX
    runner's history.jsonl and of its `net.telemetry` block for each
    cli_stream run (JAX without the overlap pipeline)."""
    import chip_smoke
    res, hist = _jax_run(_stream_runs()[name], str(tmp_path))
    pin = chip_smoke.PINNED_STREAM[name]
    assert res["valid"] is pin["valid"] and res["workload"]["valid"]
    assert hashlib.sha256(hist).hexdigest() == pin["history"]
    tel = res["net"].get("telemetry")
    assert (None if tel is None else telemetry_digest(tel)) == \
        pin["telemetry"]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["linkv5-faults", "echo5"])
def test_pinned_telemetry_blocks(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_TELEMETRY: the JAX runner's
    `net.telemetry` block for the existing runs the smoke drives with
    the ring on (their histories keep their old pins)."""
    import chip_smoke
    from maelstrom_tpu import cli as jcli
    from test_torch_runner import _run
    args = dict(chip_smoke.CLI_LINKV + chip_smoke.CLI_POOL)[name]
    jdir = _run(jcli.main, args + ["--telemetry", "--no-audit",
                                   "--no-overlap"], str(tmp_path))
    with open(os.path.join(jdir, "results.json")) as f:
        tel = json.load(f)["net"]["telemetry"]
    assert telemetry_digest(tel) == chip_smoke.PINNED_TELEMETRY[name]
