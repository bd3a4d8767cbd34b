"""The port's transaction programs, their workloads and checkers, and
lin-mutex, against the JAX package's, on the CPU (exact equality: these
are host modules over the same data).

- `checkers/txn_rw_register.py` `RWRegisterChecker` and
  `workloads/lin_mutex.py` `LinMutexChecker` on the hand-built histories
  of `tests/test_txn_rw_register.py` and `tests/test_deep_checkers.py`:
  every result field equal to JAX's.
- `nodes/txn_list_append.py` `TxnRaftProgram`'s replay cache under
  out-of-order completions (as `tests/test_tpu_txn.py` builds them) and
  the two micro-op interpreters, against JAX's.
- The op generators (`TxnOpGen`, `RWOpGen`) and the ordering axis's
  txn-list-append applier, op for op."""

from __future__ import annotations

import random

import numpy as np
import pytest

from maelstrom_tpu.checkers.txn_rw_register import \
    RWRegisterChecker as JRW
from maelstrom_tpu.history import History as JHistory
from maelstrom_tpu.history import Op as JOp
from maelstrom_tpu.nodes import Intern as JIntern
from maelstrom_tpu.nodes.txn_list_append import TxnRaftProgram as JTxn
from maelstrom_tpu.nodes.txn_list_append import apply_txn as j_apply_txn
from maelstrom_tpu.nodes.txn_rw_register import \
    apply_rw_txn as j_apply_rw_txn
from maelstrom_tpu.ordering.appliers import \
    TxnListAppendApplier as JApplier
from maelstrom_tpu.workloads import lin_mutex as jmutex
from maelstrom_tpu.workloads.txn_list_append import TxnOpGen as JTxnGen
from maelstrom_tpu.workloads.txn_rw_register import RWOpGen as JRWGen
from maelstrom_tpu_torch.checkers.txn_rw_register import \
    RWRegisterChecker as PRW
from maelstrom_tpu_torch.nodes import EncodeCapacityError
from maelstrom_tpu_torch.nodes import Intern as PIntern
from maelstrom_tpu_torch.nodes import get_program
from maelstrom_tpu_torch.nodes.raft import OP_TXN
from maelstrom_tpu_torch.nodes.txn_list_append import apply_txn
from maelstrom_tpu_torch.nodes.txn_rw_register import apply_rw_txn
from maelstrom_tpu_torch.ordering.appliers import TxnListAppendApplier
from maelstrom_tpu_torch.testing.histories import from_rows
from maelstrom_tpu_torch.workloads import lin_mutex as pmutex
from maelstrom_tpu_torch.workloads.txn_list_append import TxnOpGen
from maelstrom_tpu_torch.workloads.txn_rw_register import RWOpGen


def _txn(t_inv, t_ok, mops, completed=None, type="ok", process=0):
    return [
        {"type": "invoke", "f": "txn", "process": process, "time": t_inv,
         "value": mops},
        {"type": type, "f": "txn", "process": process, "time": t_ok,
         "value": completed if completed is not None else mops},
    ]


# tests/test_txn_rw_register.py's histories, by its test names
RW_CASES = {
    "legal_chain": (_txn(0, 1, [["w", 1, 10]])
                    + _txn(2, 3, [["r", 1, None]], [["r", 1, 10]])
                    + _txn(4, 5, [["w", 1, 11], ["r", 1, None]],
                           [["w", 1, 11], ["r", 1, 11]])),
    "internal_violation": _txn(0, 1, [["w", 1, 10], ["r", 1, None]],
                               [["w", 1, 10], ["r", 1, 3]]),
    "g1a_aborted_read": (_txn(0, 1, [["w", 1, 99]], type="fail")
                         + _txn(2, 3, [["r", 1, None]], [["r", 1, 99]])),
    "g1b_intermediate_read": (_txn(0, 1, [["w", 1, 10], ["w", 1, 11]])
                              + _txn(2, 3, [["r", 1, None]],
                                     [["r", 1, 10]])),
    "read_from_the_future_cycle": (
        _txn(0, 1, [["r", 1, None]], [["r", 1, 50]])
        + _txn(10, 11, [["w", 1, 50]], process=1)),
    "concurrent_read_not_flagged": (
        _txn(0, 20, [["r", 1, None]], [["r", 1, 50]])
        + _txn(5, 15, [["w", 1, 50]], process=1)),
    "duplicate_writes_reported": (_txn(0, 1, [["w", 1, 7]])
                                  + _txn(2, 3, [["w", 1, 7]], process=1)),
    "vacuous_unknown": _txn(0, 1, [["w", 1, 5]], type="info"),
    "duplicate_write_with_failed_writer": (
        _txn(0, 1, [["w", 1, 7]], type="fail") + _txn(2, 3, [["w", 1, 7]])
        + _txn(4, 5, [["r", 1, None]], [["r", 1, 7]])),
    "failed_write_alone": (_txn(0, 1, [["w", 1, 7]], type="fail")
                           + _txn(2, 3, [["r", 1, None]], [["r", 1, 7]])),
}
RW_VALID = {"legal_chain": True, "concurrent_read_not_flagged": True,
            "vacuous_unknown": "unknown"}


@pytest.mark.parametrize("name", list(RW_CASES))
def test_rw_register_checker_matches_jax(name):
    rows = RW_CASES[name]
    j = JRW().check({}, JHistory([JOp(**o) for o in rows]), {})
    p = PRW().check({}, from_rows(rows), {})
    assert p == j
    assert p["valid"] == RW_VALID.get(name, False)


def _cas(t0, t1, frm, to, proc, typ="ok"):
    return [{"type": "invoke", "f": "cas", "value": [0, [frm, to]],
             "process": proc, "time": t0},
            {"type": typ, "f": "cas", "value": [0, [frm, to]],
             "process": proc, "time": t1}]


FREE = pmutex.FREE
_INIT = [{"type": "invoke", "f": "write", "value": [0, FREE], "process": 0,
          "time": -2},
         {"type": "ok", "f": "write", "value": [0, FREE], "process": 0,
          "time": -1}]
# tests/test_deep_checkers.py's lin-mutex histories
MUTEX_CASES = {
    "double_hold": (_cas(0, 1, FREE, 2, 0) + _cas(2, 3, FREE, 3, 1), False),
    "legal_handoff": (_INIT + _cas(0, 1, FREE, 2, 0)
                      + _cas(2, 3, 2, FREE, 0) + _cas(4, 5, FREE, 3, 1),
                      True),
    "foreign_release": (_cas(0, 1, FREE, 2, 0) + _cas(2, 3, 3, FREE, 1),
                        False),
    "failed_acquire_and_info": (
        _INIT + _cas(0, 1, FREE, 2, 0, "fail") + _cas(0, 2, FREE, 3, 1)
        + _cas(3, 9, 3, FREE, 1, "info") + _cas(4, 5, 2, FREE, 0, "fail"),
        True),
}


@pytest.mark.parametrize("name", list(MUTEX_CASES))
def test_lin_mutex_checker_matches_jax(name):
    rows, valid = MUTEX_CASES[name]
    assert (pmutex.LOCK_KEY, pmutex.FREE) == (jmutex.LOCK_KEY, jmutex.FREE)
    j = jmutex.LinMutexChecker().check(
        {}, JHistory([JOp(**o) for o in rows]))
    p = pmutex.LinMutexChecker().check({}, from_rows(rows))
    assert p == j
    assert p["valid"] is valid and p["mutex"]["valid"] is valid


def _log_row(cap, tids):
    log_a = np.zeros(cap, np.int32)
    log_b = np.zeros(cap, np.int32)
    for i, tid in enumerate(tids):
        log_a[i] = (1 << 16) | OP_TXN
        log_b[i] = ((tid >> 8) & 0xFF) << 8 | (tid & 0xFF)
    return {"commit": np.int32(len(tids) - 1),
            "log_len": np.int32(len(tids)), "log_a": log_a, "log_b": log_b}


@pytest.mark.parametrize("program", ["txn-list-append", "txn-rw-register"])
def test_replay_cache_out_of_order_matches_jax(program):
    """The incremental replay cache serves completions at any committed
    position in any arrival order (rewinds included), with a no-op entry
    in the log, as the JAX program does."""
    from maelstrom_tpu.nodes import get_program as j_get_program
    nodes = ["n0", "n1", "n2"]
    jprog = j_get_program(program, {"latency": {"mean": 0}}, nodes)
    pprog = get_program(program, {"latency": {"mean": 0}}, nodes,
                        device="cpu")
    assert pprog.cap == jprog.cap
    w = "append" if program == "txn-list-append" else "w"
    txns = [[[w, 1, i], ["r", 1, None], ["r", 2, None]] for i in range(6)]
    jin, pin = JIntern(), PIntern()
    tids = [jin.id(t) for t in txns]
    assert tids == [pin.id(t) for t in txns]
    row = _log_row(pprog.cap, tids)
    row["log_a"][3] = 1 << 16        # a no-op entry at position 3
    for p in (2, 0, 5, 4, 1, 5):
        body = {"type": "txn_ok", "position": p}
        if p == 3:
            continue
        j = jprog.completion({"f": "txn"}, body, lambda i=0: row, jin)
        got = pprog.completion({"f": "txn"}, body, lambda i=0: row, pin)
        assert got == j and got["type"] == "ok", (p, got, j)
    assert pprog.encode_body(pprog.request_for_op(
        {"value": txns[1]}), pin) == (16, tids[1], 0, 0)
    assert pprog.decode_body(17, 7, 0, 0, pin) == \
        {"type": "txn_ok", "position": 7}


def test_txn_command_table_capacity():
    prog = get_program("txn-list-append", {}, ["n0", "n1", "n2"],
                       device="cpu")
    it = PIntern()
    it._rev = [None] * 0x10001                  # a full table
    with pytest.raises(EncodeCapacityError, match="command table full"):
        prog.encode_body({"type": "txn", "txn": [["r", 1, None]]}, it)


def test_interpreters_generators_and_applier_match_jax():
    """apply_txn / apply_rw_txn, TxnOpGen (key window, writes per key,
    txn lengths) and RWOpGen op for op, and the txn applier's replay."""
    for seed in range(3):
        opts = {"seed": seed, "key_count": 3 + seed, "max_txn_length": 5,
                "max_writes_per_key": 4 + seed}
        jg, pg = JTxnGen(opts), TxnOpGen(opts)
        jr, pr = JRWGen(opts), RWOpGen(opts)
        ops = [pg() for _ in range(300)]
        assert ops == [jg() for _ in range(300)]
        rw_ops = [pr() for _ in range(300)]
        assert rw_ops == [jr() for _ in range(300)]
        jdb, pdb = {}, {}
        for op in ops:
            jdb, jout = j_apply_txn(jdb, op["value"])
            pdb, pout = apply_txn(pdb, op["value"])
            assert (pdb, pout) == (jdb, jout)
        jdb, pdb = {}, {}
        for op in rw_ops:
            jdb, jout = j_apply_rw_txn(jdb, op["value"])
            pdb, pout = apply_rw_txn(pdb, op["value"])
            assert (pdb, pout) == (jdb, jout)
        ja, pa = JApplier({}), TxnListAppendApplier({})
        js, ps = ja.init_state(), pa.init_state()
        rng = random.Random(seed)
        for op in ops[:100]:
            op = {**op, "process": rng.randrange(4)}
            js, jres = ja.apply(js, ja.command(op))
            ps, pres = pa.apply(ps, pa.command(op))
            assert pa.completed(op, pres) == ja.completed(op, jres)
        assert ps == js
