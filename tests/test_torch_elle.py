"""The port's Elle checker against the JAX package's, on the CPU: K16
`elle_edges` and K17 `elle_screen` (their plain versions, through the
wrappers on CPU tensors) against JAX's jitted `edges_fn` / `screen_fn` on
the same `device_args` inputs, every output element and both screen
iteration counts exact (int32 and bool: zero tolerance); and the host
checker (`_edges_python`, `_edges_vectorized`, `analyze_txns` with the
device path on and off) against JAX's.

The histories are the JAX package's device-Elle suite's: seeded
`random_append_history` runs (every other one with 15% corrupt reads),
and the fixtures of `tests/test_elle_device.py` (G0, G1c, G-single,
G-nonadjacent, a realtime cycle, an empty version table, list-subclass
reads, no reads, the empty history)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from maelstrom_tpu.checkers import elle as jelle
from maelstrom_tpu.checkers import elle_device as jed
from maelstrom_tpu.testing.histories import \
    random_append_history as j_random_append_history
from maelstrom_tpu_torch.checkers import elle as pelle
from maelstrom_tpu_torch.checkers import elle_device as ped
from maelstrom_tpu_torch.testing.histories import ELLE_FIXTURES, from_rows
from maelstrom_tpu_torch.testing.histories import \
    random_append_history as p_random_append_history


FIXTURES = ELLE_FIXTURES


def _histories(kind, arg):
    """(JAX history, port history) of one case."""
    if kind == "fixture":
        rows = FIXTURES[arg]()
        from maelstrom_tpu.history import coerce_history
        return coerce_history(rows), from_rows(rows)
    seed, kw = arg
    return j_random_append_history(seed, **kw), \
        p_random_append_history(seed, **kw)


CASES = ([("random", (s, {"corrupt": 0.15 if s % 2 else 0.0}))
          for s in range(6)]
         + [("random", (9, {"empty_reads": True})),
            ("random", (3, {"n_txn": 200}))]
         + [("fixture", name) for name in FIXTURES])
IDS = ([f"seed{s}" for s in range(6)] + ["empty-version-table", "seed3-200"]
       + list(FIXTURES))


def _tables(h):
    """`analyze_txns`'s inputs to the device path, built by the JAX
    package's host code: (txns, longest, appender, rt)."""
    txns = jelle._txn_ops(h)
    appender, longest = {}, {}
    for t in txns:
        for f, k, v in t["micro"]:
            if f == "append":
                appender[(jelle._hk(k), jelle._hv(v))] = t["id"]
    for t in txns:
        if not t["ok"]:
            continue
        for f, k, v in t["micro"]:
            if f == "r" and isinstance(v, list):
                kk = jelle._hk(k)
                vv = [jelle._hv(x) for x in v]
                if len(vv) > len(longest.get(kk, [])):
                    longest[kk] = vv
    ok_txns = sorted((t for t in txns if t["ok"]), key=lambda t: t["ret"])
    rets = np.array([t["ret"] for t in ok_txns], np.float64)
    invs = np.array([t["inv"] for t in ok_txns], np.float64)
    before = np.searchsorted(rets, invs, side="left") - 1
    ok_tids = np.array([t["id"] for t in ok_txns], np.int64)
    return txns, longest, appender, (ok_tids, before)


def _device_args(module, txns, longest, appender, rt):
    cols = module.build_columns(txns)
    writers, slot_key, slot_idx, offsets, lens, key_idx = \
        module._writer_table(longest, appender, repr)
    tid, n_, wr_pos, rw_pos = module.read_positions(cols, key_idx, offsets,
                                                    lens, repr)
    return module.device_args(
        writers, slot_key, slot_idx, tid, n_, wr_pos, rw_pos, rt[0], rt[1],
        len(txns))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("kind,arg", CASES, ids=IDS)
def test_kernels_plain_match_jax(kind, arg):
    """K16 and K17's plain versions against `edges_fn` / `screen_fn` on
    the device_args of each history (built by both packages' host code,
    which must agree): all four edge arrays and all four screen outputs,
    element for element."""
    jh, ph = _histories(kind, arg)
    txns, longest, appender, rt = _tables(jh)
    eargs, sargs, tp, have_rt = _device_args(
        jed, txns, longest, appender, rt)
    peargs, psargs, ptp, phave = _device_args(
        ped, txns, longest, appender, rt)
    assert (ptp, phave) == (tp, have_rt)
    for a, b in zip(eargs + sargs, peargs + psargs):
        np.testing.assert_array_equal(a, b)
    fns = jed._fns()
    jedges = [np.asarray(x) for x in fns["edges"](*eargs)]
    pedges = ped.elle_edges(*map(_t, peargs))
    for j, p in zip(jedges, pedges):
        assert p.dtype == (torch.bool if j.dtype == bool else torch.int32)
        np.testing.assert_array_equal(p.numpy(), j)
    jscreen = [int(x) for x in fns["screen"](*sargs, n_txns_pad=tp,
                                             do_rt=have_rt)]
    pscreen = ped.elle_screen(*map(_t, psargs), n_txns_pad=ptp,
                              do_rt=phave)
    assert pscreen.dtype == torch.int32
    assert pscreen.tolist() == jscreen


@pytest.mark.parametrize("kind,arg", CASES, ids=IDS)
def test_analyze_device_on_matches_jax(kind, arg):
    """`analyze_txns(..., device="on")`: the report (screen verdicts,
    iteration counts, candidate count) and the anomalies equal JAX's
    (both build their edge sets in the same order), and the host path's
    (device off, and the Python edge oracle) find the same anomalies in
    the same transactions. A rendered witness cycle starts where the
    Tarjan walk enters the SCC, which follows the edge set's iteration
    order: the string hash seed's, in both packages."""
    jh, ph = _histories(kind, arg)
    jrep, prep = {}, {}
    janom = jelle.analyze_txns(jelle._txn_ops(jh), jelle._fail_appends(jh),
                               device="on", report=jrep)
    panom = pelle.analyze_txns(pelle._txn_ops(ph), pelle._fail_appends(ph),
                               device="on", report=prep,
                               torch_device="cpu")
    assert prep == jrep and prep["edges-on-device"] is True
    assert panom == janom

    def found(anoms):
        return {k: sorted(str(a.get("txns", a)) for a in v)
                for k, v in anoms.items()}
    assert found(panom) == found(pelle.analyze(ph, device="off")) \
        == found(pelle.analyze(ph, edges_impl=pelle._edges_python))


@pytest.mark.parametrize("seed", range(4))
def test_host_edges_and_checker_match_jax(seed):
    """The host edge builders and the checker's result (valid,
    anomaly types, rendered cycles) equal JAX's; the device edge set
    equals both host builds."""
    kw = {"corrupt": 0.15 if seed % 2 else 0.0}
    jh = j_random_append_history(seed, **kw)
    ph = p_random_append_history(seed, **kw)
    assert ph.to_jsonl() == jh.to_jsonl()
    txns, longest, appender, _rt = _tables(jh)
    ptxns = pelle._txn_ops(ph)
    assert ptxns == txns
    ev = pelle._edges_vectorized(ptxns, longest, appender)
    assert ev == jelle._edges_vectorized(txns, longest, appender)
    assert pelle._edges_python(ptxns, longest, appender) \
        == jelle._edges_python(txns, longest, appender) == ev
    assert ped.edges_device(ptxns, longest, appender, device="cpu") == ev
    for mode in ("on", "off", "auto"):
        j = jelle.ElleListAppendChecker(device=mode).check({}, jh)
        p = pelle.ElleListAppendChecker(device=mode).check(
            {"device": "cpu"}, ph)
        assert p == j


def test_transfer_books_the_device_call():
    """With the runner's TransferStats the device call is booked
    (`checker-device-calls`), and an undecided screen's edge-set fetch
    is a drain."""
    from maelstrom_tpu_torch.checkers.netstats import TransferStats
    tr = TransferStats()
    h = from_rows(FIXTURES["G0"]())
    rep = {}
    anoms = pelle.analyze_txns(pelle._txn_ops(h), pelle._fail_appends(h),
                               device="on", transfer=tr, report=rep,
                               torch_device="cpu")
    assert "G0" in anoms and rep["screen"]["data"] == "undecided"
    d = tr.as_dict()
    assert d["checker-device-calls"] == 1 and d["checker-device-s"] > 0
    assert d["drains"] == 2      # the verdict, then the edge arrays


def test_auto_mode_thresholds_and_cuda_default():
    assert ped.resolve("off", 10 ** 9) is False
    assert ped.resolve("on", 0) is True
    assert ped.resolve("auto", ped.AUTO_MIN_TXNS - 1) is False
    assert ped.resolve(None, ped.AUTO_MIN_TXNS) is True
    assert (ped.SCREEN_CAP, ped.AUTO_MIN_TXNS, ped._NEG) == \
        (jed.SCREEN_CAP, jed.AUTO_MIN_TXNS, jed._NEG)
    if not torch.cuda.is_available():
        h = from_rows(FIXTURES["G0"]())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pelle.analyze(h, device="on")
