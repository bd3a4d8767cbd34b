"""Kafka-style replicated log workload (classic Maelstrom's `kafka`).

A copy of `maelstrom_tpu/workloads/kafka.py` without the host-network
client and its RPC schemas (external node processes are not ported).
Clients append messages to per-key logs (`send`, acked with the assigned
offset), read logs back (`poll`) and track consumption (`commit` /
`list`); with `kafka_groups` the workers are consumer-group members
(`subscribe`, cursor polls, per-group commits). Graded by
`checkers/kafka.py`."""

from __future__ import annotations

import random

from .. import generators as g
from ..checkers.kafka import KafkaChecker


class KafkaOpGen:
    """Picklable op source: weighted mix of sends (per-key counters so
    every message is unique), polls, commits, and committed-offset
    reads."""

    def __init__(self, seed: int, keys: int = 4):
        self.rng = random.Random(seed)
        self.keys = keys
        self.counter = 0

    def __call__(self):
        r = self.rng.random()
        if r < 0.5:
            self.counter += 1
            k = self.counter % self.keys
            return {"f": "send", "value": [k, self.counter]}
        if r < 0.8:
            return {"f": "poll"}
        if r < 0.9:
            return {"f": "commit"}
        return {"f": "list"}


class KafkaStreamOpGen:
    """Group-mode op source: explicit subscribes join the worker's
    consumer group (first polls auto-subscribe too), polls become cursor
    fetches over the member's assigned keys, commits claim exactly what
    the member consumed (and are the group heartbeat), lists read the
    group's committed floors."""

    def __init__(self, seed: int, keys: int = 4):
        self.rng = random.Random(seed)
        self.keys = keys
        self.counter = 0

    def __call__(self):
        r = self.rng.random()
        if r < 0.05:
            return {"f": "subscribe"}
        if r < 0.5:
            self.counter += 1
            k = self.counter % self.keys
            return {"f": "send", "value": [k, self.counter]}
        if r < 0.8:
            return {"f": "poll"}
        if r < 0.95:
            return {"f": "commit"}
        return {"f": "list"}


def workload(opts: dict) -> dict:
    keys = int(opts.get("key_count") or 4)
    groups = int(opts.get("kafka_groups") or 0)
    op_gen = (KafkaStreamOpGen(opts.get("seed", 0), keys) if groups
              else KafkaOpGen(opts.get("seed", 0), keys))
    return {"generator": g.Fn(op_gen), "checker": KafkaChecker()}
