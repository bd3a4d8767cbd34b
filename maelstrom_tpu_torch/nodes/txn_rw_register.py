"""Batched transactional read/write registers over Raft (serving
`workloads/txn_rw_register.py`).

Counterpart of `maelstrom_tpu/nodes/txn_rw_register.py`. The
replicated-command machinery is `nodes/txn_list_append.py`'s, unchanged:
transactions are interned to opaque ids, ride the raft log as OP_TXN
entries, and materialize host-side by replaying the committed prefix.
Only the micro-op interpreter differs: registers overwrite where lists
append."""

from __future__ import annotations

from . import register
from .txn_list_append import TxnRaftProgram


def apply_rw_txn(db: dict, txn) -> tuple[dict, list]:
    out = []
    for f, k, v in txn:
        key = str(k)
        if f == "r":
            out.append([f, k, db.get(key)])
        else:
            db = {**db, key: v}
            out.append([f, k, v])
    return db, out


@register
class RWRegisterRaftProgram(TxnRaftProgram):
    name = "txn-rw-register"
    apply = staticmethod(apply_rw_txn)
