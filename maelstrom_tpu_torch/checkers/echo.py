"""Echo checker: every response's :echo equals the invocation's value
(reference `workload/echo.clj:44-63`).

A copy of `maelstrom_tpu/checkers/echo.py`."""

from __future__ import annotations

from . import Checker
from ..history import coerce_history


class EchoChecker(Checker):
    name = "echo"

    def check(self, test, history, opts=None):
        history = coerce_history(history)
        errs = []
        for invoke, complete in history.pairs():
            if complete is None or not complete.is_ok():
                continue
            got = complete.value
            echoed = got.get("echo") if isinstance(got, dict) else None
            if echoed != invoke.value:
                errs.append(["Expected a message with :echo", invoke.value,
                             "But received", got])
        return {"valid": not errs, "errors": errs or None}
