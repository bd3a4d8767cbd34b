"""Echo workload: send a message, expect the same payload back
(reference `src/maelstrom/workload/echo.clj`).

A copy of `maelstrom_tpu/workloads/echo.py` without the host-network
client and its RPC schema (external node processes are not ported): the
op source and `workload()`, the generator and checker of a test."""

from __future__ import annotations

import random

from .. import generators as g
from ..checkers.echo import EchoChecker


class EchoOpGen:
    """Picklable op source."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)

    def __call__(self):
        return {"f": "echo", "value": f"Please echo {self.rng.randrange(128)}"}


def workload(opts: dict) -> dict:
    return {
        "generator": g.Fn(EchoOpGen(opts.get("seed", 0))),
        "checker": EchoChecker(),
    }
