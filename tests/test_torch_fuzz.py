"""The port's fault sweeps (`maelstrom_tpu_torch/fuzz.py`) against the JAX
package's, row for row.

  - `fuzz_broadcast` at 256 nodes with 8 values in chunks of 25 rounds:
    the four configs of `DEFAULT_SWEEP` (partitions as component labels,
    loss, constant, uniform and exponential latency), every row equal
    but for its wall seconds;
  - `fuzz_kafka` on its uniform-latency, 2%-loss config at 5 nodes for
    0.5 s: the graded run's row equal;
  - `python -m maelstrom_tpu_torch fuzz` on the CPU, and its refusal of
    `--program raft`.

`-m slow` re-derives the smoke's `PINNED_FUZZ`, the JAX rows of the
broadcast sweep at 4,096 nodes with 32 values (a few minutes)."""

from __future__ import annotations

import pytest

from maelstrom_tpu import core as jcore
from maelstrom_tpu import fuzz as jfuzz
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import fuzz as pfuzz


def _rows(rows):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]


def test_fuzz_broadcast_matches_jax():
    kw = dict(n_nodes=256, values=8, seed=0, chunk=25, log=lambda s: None)
    ref = jfuzz.fuzz_broadcast(**kw)
    got = pfuzz.fuzz_broadcast(**kw, device="cpu")
    assert _rows(got) == _rows(ref)
    assert all(r["ok"] for r in got)
    assert all(r["dropped_partition"] > 0 for r in got[:3])
    assert got[1]["lost"] > 0 and got[3]["lost"] > 0


def test_fuzz_kafka_matches_jax(tmp_path, monkeypatch):
    sweep = [jfuzz.KAFKA_SWEEP[2]]
    assert sweep == [pfuzz.KAFKA_SWEEP[2]]
    run = jcore.run

    def jrun(opts):
        # the JAX sweep's own store and audit settings aside: the rows
        # read neither
        return run({**opts, "store_root": str(tmp_path / "jax"),
                    "audit": False, "no_overlap": True})
    monkeypatch.setattr(jcore, "run", jrun)
    ref = jfuzz.fuzz_kafka(n_nodes=5, time_limit=0.5, sweep=sweep,
                           log=lambda s: None)
    got = pfuzz.fuzz_kafka(n_nodes=5, time_limit=0.5, sweep=sweep,
                           log=lambda s: None, device="cpu",
                           store_root=str(tmp_path / "port"))
    assert got == ref
    assert got[0]["ok"] and got[0]["lost"] > 0


def test_fuzz_cli(tmp_path, capsys):
    assert pcli.main(["fuzz", "--nodes", "16", "--values", "2", "--device",
                      "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"all_ok": true' in out and out.count('"config"') == 4
    assert pcli.main(["fuzz", "--program", "raft", "--device", "cpu"]) == 2
    assert "the graded Raft fleet (bench_raft_graded.py)" in \
        capsys.readouterr().err


def _pinned():
    import chip_smoke
    return chip_smoke.PINNED_FUZZ


@pytest.mark.slow
def test_pinned_fuzz_rows():
    """Re-derives chip_smoke.py's PINNED_FUZZ: the JAX broadcast sweep at
    4,096 nodes and 32 values, its rows less wall seconds."""
    import chip_smoke
    ref = jfuzz.fuzz_broadcast(**chip_smoke.FUZZ_PIN_ARGS,
                               log=lambda s: None)
    assert _rows(ref) == _pinned()
