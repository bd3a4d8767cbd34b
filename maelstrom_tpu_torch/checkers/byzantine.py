"""The byzantine conviction source of the device path.

Counterpart of `maelstrom_tpu/checkers/byzantine.py` without the host
path's wire auditor (`ByzantineChecker`, which reads the host network's
journal bodies: it comes with the host-process path). `TpuByzantine`
surfaces the evidence the node program gathered inside its round
(`byz_evidence`, the compartment proxies' evidence leaves) through the
`Checker.convictions` hook; `Compose` grades them, with every other
checker's (the batched broadcast's proof audit convicts too), against
the injection ledger the runner puts in `test["byz_injected"]`.
`classify_wire_diff` is the host auditor's pure rule classifier, kept
for the host path."""

from __future__ import annotations

from . import Checker
from ..byzantine import PROOF_FIELDS


def classify_wire_diff(sent: dict, received: dict, prior: list) -> str:
    """Names the rule a corrupted delivery violates, from the shape of its
    send/recv body diff: a delivered body equal to an EARLIER send of the
    same culprit is ``stale-ballot`` (old traffic replayed over new); a
    diff confined to the proof vocabulary (`PROOF_FIELDS`) is
    ``forged-proof``; anything else is ``equivocation``."""
    if any(p == received for p in prior):
        return "stale-ballot"
    keys = {k for k in set(sent) | set(received)
            if sent.get(k) != received.get(k)}
    if keys and keys <= set(PROOF_FIELDS):
        return "forged-proof"
    return "equivocation"


class TpuByzantine(Checker):
    """The device path's conviction source: the evidence the program
    gathered in its round (`program.byz_evidence(nodes_host) ->
    [conviction, ...]`). Its own block only echoes the ledger; the
    verdict that counts is the `byzantine` block `Compose` assembles."""

    name = "byzantine"

    def __init__(self, runner):
        self.runner = runner

    def check(self, test, history, opts=None):
        return {"valid": True,
                "injected": dict(test.get("byz_injected") or {})}

    def convictions(self, test, history, opts=None):
        fn = getattr(self.runner.program, "byz_evidence", None)
        if fn is None:
            return []
        return list(fn(self.runner._nodes_host()))
