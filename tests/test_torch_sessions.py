"""The port's client-session backends (`maelstrom_tpu_torch/runner/
sessions.py`: `CoroutineSessions`, `ColumnarSessions`, `SessionView`,
`resolve_mode`, `make_sessions`, and `encode_wave`'s device reduction,
K33's plain version on the CPU) against the JAX package's
(`maelstrom_tpu/runner/sessions.py`).

The cases of `tests/test_sessions.py` that do not touch the checkpoint
meta run on both packages' backends, and a seeded random stream of
register / absorb / expire / requeue / retry operations over a
three-shell table must give the same answer from each of the four
backends, op for op. `encode_wave` is held against the JAX package's
numpy pass and its jitted `_wave_reduce_fn` on random tables with empty
rows and INT32_MAX-adjacent deadlines. A standalone CLI run with
`--sessions columnar` (and `--client-retries 3`) gives JAX's
history.jsonl and the coroutine default's. Tolerance: exact."""

from __future__ import annotations

import os
from unittest import mock

import numpy as np
import pytest
import torch

from maelstrom_tpu.runner import sessions as JS
from maelstrom_tpu_torch.runner import sessions as PS

OP = {"f": "read", "value": None}


def _views(mod):
    """A coroutine backend and a one-shell columnar view of `mod`."""
    kw = {} if mod is JS else {"device": "cpu"}
    return mod.CoroutineSessions(), mod.ColumnarSessions(1, 4, **kw).view(0)


def _all():
    return _views(JS) + _views(PS)


def test_register_absorb_parity():
    for s in _all():
        s.register(100, 0, {**OP, "k": 0}, 2, 50)
        s.register(101, 1, {**OP, "k": 1}, 0, 60)
        assert len(s) == 2 and bool(s)
        assert s.min_deadline() == 50
        got = s.absorb_results([101, 999, 100])
        assert got == [(1, {**OP, "k": 1}, 0, 60), None,
                       (0, {**OP, "k": 0}, 2, 50)]
        assert len(s) == 0 and not s and s.min_deadline() is None


def test_take_expired_registration_order():
    for s in _all():
        s.register(1, 0, {"k": "a"}, 0, 30)
        s.register(2, 1, {"k": "b"}, 1, 10)
        s.register(3, 2, {"k": "c"}, 2, 20)
        s.register(4, 3, {"k": "d"}, 3, 99)
        assert s.take_expired(5) == []
        assert s.take_expired(25) == [(1, {"k": "b"}, 1),
                                      (2, {"k": "c"}, 2)]
        assert len(s) == 2 and s.min_deadline() == 30
        assert s.take_expired(100) == [(0, {"k": "a"}, 0),
                                       (3, {"k": "d"}, 3)]
        assert not s


def test_columnar_capacity_growth_and_single_absorb():
    v = PS.ColumnarSessions(1, 2, cap=2, device="cpu").view(0)
    for m in range(9):
        v.register(m, m % 2, {"m": m}, 0, 10 + m)
    assert len(v) == 9 and v.min_deadline() == 10
    assert [e[1]["m"] for e in v.absorb_results(list(range(9)))] == \
        list(range(9))
    v.register(7, 2, {"x": 1}, 1, 40)
    assert v.absorb_results([8]) == [None]
    assert v.absorb_results([7]) == [(2, {"x": 1}, 1, 40)]
    assert v.absorb_results([7]) == [None]


def test_requeue_due_order_stable_and_drain():
    for s in _all():
        s.requeue(20, 0, {"r": 0}, 1, 10, 0, 0, 0)
        s.requeue(10, 1, {"r": 1}, 2, 11, 0, 0, 0)
        s.requeue(10, 2, {"r": 2}, 0, 12, 0, 0, 0)
        s.requeue(30, 3, {"r": 3}, 1, 13, 0, 0, 0)
        assert s.has_requeue() and s.requeue_min_due() == 10
        rows = s.take_due_requeues(20)
        assert [(rw[0], rw[1]["r"]) for rw in rows] == \
            [(1, 1), (2, 2), (0, 0)]
        assert s.requeue_min_due() == 30
        assert s.take_due_requeues(29) == []
        s.requeue(5, 1, {"r": 4}, 2, 11, 0, 0, 0)
        assert s.drain_requeues(20) == [(30, 3, {"r": 3}, 1, 13, 0, 0, 0),
                                        (20, 1, {"r": 4}, 2, 11, 0, 0, 0)]
        assert not s.has_requeue() and s.requeue_min_due() is None


def test_retry_chain_transitions():
    for s in _all():
        assert s.attempt(2) == 0 and not s.retry_is_open(2)
        s.open_retry(2, 1)
        s.open_retry(2, 2)
        assert s.attempt(2) == 2 and s.retry_is_open(2)
        assert not s.retry_is_open(3)
        s.close_retry(2)
        assert s.attempt(2) == 0 and not s.retry_is_open(2)
        s.close_retry("nemesis")
        assert not s.retry_is_open("nemesis")
        assert s.attempt("nemesis") == 0


def test_shared_table_shell_isolation_and_encode_wave():
    t = PS.ColumnarSessions(3, 4, device="cpu")
    a, b = t.view(0), t.view(2)
    a.register(1, 0, {"s": 0}, 1, 25)
    b.register(1, 1, {"s": 2}, 0, 15)
    b.requeue(8, 2, {"r": 1}, 1, 0, 0, 0, 0)
    t.encode_wave()
    assert bool(t._cache_ok.all())
    assert a.min_deadline() == 25 and b.min_deadline() == 15
    assert t.view(1).min_deadline() is None
    assert not a.has_requeue() and b.requeue_min_due() == 8
    assert a.absorb_results([1]) == [(0, {"s": 0}, 1, 25)]
    assert b.absorb_results([1]) == [(1, {"s": 2}, 0, 15)]
    assert b.min_deadline() is None


def test_resolve_mode_and_make_sessions():
    for mod in (JS, PS):
        assert mod.resolve_mode({}) == "coroutine"
        assert mod.resolve_mode({"fleet": 8}) == "columnar"
        assert mod.resolve_mode({"fleet": 8, "sessions": "coroutine"}) \
            == "coroutine"
        assert mod.resolve_mode({"sessions": "columnar"}) == "columnar"
        with pytest.raises(ValueError, match="sessions"):
            mod.resolve_mode({"sessions": "hybrid"})
    assert PS.SESSION_MODES == JS.SESSION_MODES
    assert isinstance(PS.make_sessions({}, 4), PS.CoroutineSessions)
    cols = PS.make_sessions({"sessions": "columnar"}, 4, device="cpu")
    assert cols.table.F == 1 and cols.table.C == 4


def test_device_reduce_resolution():
    """None is auto (on from 64 clusters); MAELSTROM_SESSIONS_DEVICE
    forces either path; an explicit argument wins."""
    assert PS.ColumnarSessions(2, 4).device_reduce is False
    assert PS.ColumnarSessions(64, 4, device="cpu").device_reduce is True
    assert PS.ColumnarSessions(64, 4, device_reduce=False).device_reduce \
        is False
    with mock.patch.dict(os.environ, {"MAELSTROM_SESSIONS_DEVICE": "1"}):
        assert PS.ColumnarSessions(2, 4, device="cpu").device_reduce
    with mock.patch.dict(os.environ, {"MAELSTROM_SESSIONS_DEVICE": "0"}):
        assert PS.ColumnarSessions(64, 4).device_reduce is False
        assert PS.ColumnarSessions(64, 4, device_reduce=True,
                                   device="cpu").device_reduce


def _random_ops(seed, F, n_ops):
    """A seeded stream of (shell, op, args) over F shells: registers,
    absorbs (stale ids among them), expiries, requeues, due takes,
    drains, retry opens and closes, and wave passes."""
    rng = np.random.default_rng(seed)
    ops, mid = [], 0
    for _ in range(n_ops):
        i = int(rng.integers(0, F))
        r = int(rng.integers(0, 400))
        kind = rng.choice(["register", "absorb", "expire", "requeue",
                           "take_due", "drain", "open", "close", "wave",
                           "min"], p=[.3, .15, .1, .1, .08, .02, .05, .05,
                                      .05, .1])
        if kind == "register":
            mid += int(rng.integers(1, 4))
            ops.append((i, "register", (mid, int(rng.integers(0, 4)),
                                        {"m": mid}, int(rng.integers(0, 5)),
                                        r)))
        elif kind == "absorb":
            ops.append((i, "absorb_results",
                        ([int(x) for x in rng.integers(0, mid + 3, 3)],)))
        elif kind == "expire":
            ops.append((i, "take_expired", (r,)))
        elif kind == "requeue":
            ops.append((i, "requeue", (r, int(rng.integers(0, 4)),
                                       {"q": r}, 1, 10, 1, 2, 3)))
        elif kind == "take_due":
            ops.append((i, "take_due_requeues", (r,)))
        elif kind == "drain":
            ops.append((i, "drain_requeues", (r,)))
        elif kind == "open":
            ops.append((i, "open_retry", (int(rng.integers(0, 4)),
                                          int(rng.integers(1, 5)))))
        elif kind == "close":
            ops.append((i, "close_retry", (int(rng.integers(0, 4)),)))
        elif kind == "wave":
            ops.append((i, "wave", ()))
        else:
            ops.append((i, "min", ()))
    return ops


@pytest.mark.parametrize("device_reduce", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_streams_agree_across_backends(seed, device_reduce):
    """Four backends of three shells (JAX's and the port's coroutine
    dicts, JAX's and the port's columnar tables, with the wave pass on
    the host or as the device reduction) answer 1,500 random ops the
    same."""
    F = 3
    jt = JS.ColumnarSessions(F, 4, cap=2, device_reduce=device_reduce)
    pt = PS.ColumnarSessions(F, 4, cap=2, device_reduce=device_reduce,
                             device="cpu")
    backends = [[JS.CoroutineSessions() for _ in range(F)],
                [PS.CoroutineSessions() for _ in range(F)],
                [jt.view(i) for i in range(F)],
                [pt.view(i) for i in range(F)]]
    tables = [None, None, jt, pt]
    for i, op, args in _random_ops(seed, F, 1500):
        answers = []
        for shells, table in zip(backends, tables):
            s = shells[i]
            if op == "wave":
                if table is not None:
                    table.encode_wave()
                answers.append(None)
            elif op == "min":
                answers.append((s.min_deadline(), s.requeue_min_due(),
                                len(s), s.has_requeue()))
            else:
                answers.append(getattr(s, op)(*args))
        assert all(a == answers[0] for a in answers), (op, args, answers)
    assert pt.device_waves == (sum(1 for _i, o, _a in _random_ops(
        seed, F, 1500) if o == "wave") if device_reduce else 0)


@pytest.mark.parametrize("F,S,R", [(1, 8, 8), (64, 10, 8), (200, 33, 17)])
def test_encode_wave_matches_jax_both_paths(F, S, R):
    """The port's wave pass, host numpy and device reduction (K33's plain
    version here), against the JAX package's numpy pass and its jitted
    `_wave_reduce_fn`, on random tables with empty rows, free slots and
    deadlines at and past INT32_MAX (clamped as JAX clamps them)."""
    rng = np.random.default_rng(F * S)
    p_mid = np.where(rng.random((F, S)) < 0.5,
                     rng.integers(0, 10**6, (F, S)), -1).astype(np.int64)
    p_mid[::4] = -1
    p_dl = rng.integers(0, 2**31 + 5, (F, S)).astype(np.int64)
    p_dl[1::5, 0] = 2**31 - 1
    r_valid = rng.random((F, R)) < 0.3
    r_valid[2::3] = False
    r_due = rng.integers(0, 2**31 + 5, (F, R)).astype(np.int64)
    outs = []
    for mod, dr in ((JS, False), (JS, True), (PS, False), (PS, True)):
        kw = {} if mod is JS else {"device": "cpu"}
        t = mod.ColumnarSessions(F, 4, cap=S, device_reduce=dr, **kw)
        t.p_mid, t.p_dl = p_mid.copy(), p_dl.copy()
        t.r_valid = np.zeros((F, t.r_valid.shape[1]), bool)
        t.r_due = np.zeros((F, t.r_due.shape[1]), np.int64)
        n = min(R, t.r_valid.shape[1])
        t.r_valid[:, :n], t.r_due[:, :n] = r_valid[:, :n], r_due[:, :n]
        t.encode_wave()
        outs.append((t._min_dl.copy(), t._min_due.copy()))
    for dl, due in outs[1:]:
        np.testing.assert_array_equal(dl, outs[0][0])
        np.testing.assert_array_equal(due, outs[0][1])
    assert (outs[0][0] == np.iinfo(np.int64).max).any()


def test_wave_reduce_plain_is_the_masked_minimum():
    p_mid = torch.tensor([[-1, 3, 4], [-1, -1, -1]], dtype=torch.int32)
    p_dl = torch.tensor([[1, 9, 7], [5, 5, 5]], dtype=torch.int32)
    r_valid = torch.tensor([[False, True], [False, False]])
    r_due = torch.tensor([[0, 12], [3, 3]], dtype=torch.int32)
    dl, due = PS.wave_reduce(p_mid, p_dl, r_valid, r_due)
    assert dl.tolist() == [7, 2**31 - 1]
    assert due.tolist() == [12, 2**31 - 1]


def test_cli_standalone_sessions_columnar_matches_jax(tmp_path):
    """A standalone run with --sessions columnar and --client-retries 3
    (refused before the fleet slice) gives JAX's history.jsonl, and the
    coroutine default's."""
    from maelstrom_tpu import cli as jcli
    from maelstrom_tpu_torch import cli as pcli
    args = ["test", "-w", "broadcast", "--node", "tpu:broadcast",
            "--node-count", "3", "--rate", "20", "--time-limit", "0.4",
            "--seed", "5", "--client-retries", "3"]
    hist = {}
    for name, main, extra in (
            ("jax", jcli.main, ["--sessions", "columnar", "--no-audit",
                                "--no-overlap"]),
            ("port", pcli.main, ["--sessions", "columnar", "--device",
                                 "cpu"]),
            ("port-coroutine", pcli.main, ["--device", "cpu"])):
        store = str(tmp_path / name)
        assert main(args + extra + ["--store", store]) == 0
        with open(os.path.join(os.path.realpath(os.path.join(
                store, "latest")), "history.jsonl"), "rb") as f:
            hist[name] = f.read()
    assert hist["port"] == hist["jax"] == hist["port-coroutine"]
