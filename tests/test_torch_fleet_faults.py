"""The port's fleet runner under faults (`--fleet N` with a nemesis)
against the JAX package's `FleetRunner` and the port's own standalone
runs, as `tests/test_torch_fleet.py` holds the benign fleets (the same
helpers and the same contract: each cluster's history.jsonl byte for
byte, results.json but the wall-clock and host-read keys).

In tier 1: the lin-kv nemesis sweep under partitions (the op stream
fixed, each cluster's fault schedule its own; RPC timeouts of 300 ms)
against JAX and the solos,
and a short port-only broadcast fleet under the fault soup (kill, pause,
partition, duplicate; F = 2, 0.6 s, RPC timeouts of 300 ms so that the
killed nodes' ops end soon) held against the port's standalone runs. The
soup fleets of `tests/test_fleet_runner.py` (:147, :201-215) against JAX
are slow-marked, as JAX marks its own for the wall time of the kill
restarts, and run with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fleet_faults.py \
        -m slow
"""

from __future__ import annotations

import pytest

from test_torch_fleet import BROADCAST, LIN_KV, _check

SOUP = {"nemesis": ["kill", "pause", "partition", "duplicate"],
        "nemesis_interval": 0.2}


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("fleet-faults"))


def test_nemesis_sweep_partition_matches_jax_and_solos(tmp_root):
    """--fleet-sweep nemesis under partitions on Raft lin-kv: the same
    op stream, fault schedules of their own (RPC timeouts of 300 ms keep
    the run short; its handful of ops leaves the stats checker's
    every-f-succeeded test to chance, so validity is not asserted: the
    bytes are JAX's and the solos')."""
    opts = {**LIN_KV, "nemesis": ["partition"], "nemesis_interval": 0.15,
            "timeout_ms": 300, "fleet": 2, "fleet_sweep": "nemesis"}
    port = _check(opts, tmp_root, valid=False)

    def nemesis_rows(h):
        return [r for r in h.decode().splitlines() if '"nemesis"' in r]
    assert nemesis_rows(port[0][0]) != nemesis_rows(port[1][0])


def test_soup_fleet_matches_its_solos(tmp_root):
    """The fault soup on a 2-cluster broadcast fleet, each cluster held
    against the port's own standalone run (the soup's runs against JAX
    are slow-marked below; the round-level soup parity of raft and
    broadcast is `tests/test_torch_parallel.py`'s)."""
    port = _check({**BROADCAST, **SOUP, "time_limit": 0.6,
                   "timeout_ms": 300, "fleet": 2},
                  tmp_root, jax=False, valid=False)
    for h, _r in port:
        text = h.decode()
        assert "start-kill" in text and "start-partition" in text


@pytest.mark.slow
@pytest.mark.parametrize("opts,fleet", [
    ({**BROADCAST, **SOUP, "time_limit": 1.2, "nemesis_interval": 0.4},
     2),
    ({**LIN_KV, **SOUP, "time_limit": 2.0, "recovery_s": 0.5,
      "nemesis_interval": 0.4}, 2)], ids=["broadcast", "lin-kv"])
def test_soup_fleet_matches_jax(opts, fleet, tmp_root):
    """The soup fleets of `tests/test_fleet_runner.py` (:147, :201-215)
    at F = 2, against JAX's fleet and the port's solos (some minutes on
    the CPU for the kill restarts)."""
    _check({**opts, "fleet": fleet}, tmp_root, valid=False)




def _jax_fleet_digests(opts, tmp):
    """Every cluster's history digest of a fleet through the JAX
    package's `core.run` (the audit and the overlap pipeline off, as the
    port runs)."""
    import os

    import chip_smoke
    from maelstrom_tpu import core as jcore
    jcore.run({**opts, "audit": False, "no_overlap": True,
               "store_root": tmp})
    return chip_smoke._fleet_digests(
        os.path.realpath(os.path.join(tmp, "latest")), opts["fleet"])


@pytest.mark.slow
def test_pins_match_live_jax_runs(tmp_path):
    """Re-derives chip_smoke.py's PINNED_FLEET (every cluster's history of
    each `CLI_FLEET` run, from the JAX package's fleet runner) and
    PINNED_FLEET_BENCH (bench.py's fleet record at 1, 8 and 64 clusters)
    on the CPU, and holds the port's CPU runs of the fleets of 8 or fewer
    clusters and its fleet bench to them (some fifteen minutes)."""
    import os

    import bench
    import chip_smoke
    from maelstrom_tpu_torch import core as pcore
    from maelstrom_tpu_torch.bench import bench_fleet_record
    got = {}
    for name, opts in chip_smoke.CLI_FLEET:
        got[name] = _jax_fleet_digests(opts, str(tmp_path / name))
        print("PINNED_FLEET", name, got[name])
    os.environ["BENCH_FLEET_SIZES"] = "1,8,64"
    rec = bench.bench_fleet_record()
    counts = {r["fleet"]: r["messages_delivered"] for r in rec["sizes"]}
    print("PINNED_FLEET_BENCH", counts)
    assert got == chip_smoke.PINNED_FLEET
    assert counts == chip_smoke.PINNED_FLEET_BENCH
    for name, opts in chip_smoke.CLI_FLEET:
        if opts["fleet"] > 8:
            continue
        store = str(tmp_path / f"port-{name}")
        pcore.run({**opts, "device": "cpu", "store_root": store})
        d = os.path.realpath(os.path.join(store, "latest"))
        assert chip_smoke._fleet_digests(d, opts["fleet"]) == got[name]
    prec = bench_fleet_record(sizes=[1, 8], device="cpu")
    assert {r["fleet"]: r["messages_delivered"] for r in prec["sizes"]} \
        == {k: v for k, v in counts.items() if k <= 8}
