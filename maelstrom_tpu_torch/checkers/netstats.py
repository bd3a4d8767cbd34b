"""Host-transfer accounting of the runner.

A copy of `TransferStats` from `maelstrom_tpu/checkers/netstats.py`, cut
to the counters a single-cluster run books (no checkpoint or fleet
counters): every read of device state by the host is booked here, so
results show that extraction stays O(host-relevant rounds), and the
device checker's calls are booked beside them."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..tree import leaves, tree_map


@dataclass
class TransferStats:
    """`drains`: how many times the run read device state on the host;
    `host_bytes`: how many bytes crossed; `blocked_s`: host wall time
    spent waiting for those reads (the device finishing its queued work
    included). `host_polls` / `host_poll_s`: the host's generator poll
    passes, one a stretch boundary, and their wall time.
    `checker_device_calls` / `checker_device_s`: the device Elle
    checker's calls (edge build and cycle screen) at check time and their
    wall time."""

    drains: int = 0
    host_bytes: int = 0
    blocked_s: float = 0.0
    host_polls: int = 0
    host_poll_s: float = 0.0
    checker_device_calls: int = 0
    checker_device_s: float = 0.0

    def record_poll(self, seconds: float) -> None:
        """Books one host poll pass (generator scheduling + pending
        scans + inject encode) of `seconds` wall time."""
        self.host_polls += 1
        self.host_poll_s += seconds

    def record_checker(self, seconds: float) -> None:
        """Books one device-checker call (edge build and/or cycle
        screen) of `seconds` wall time."""
        self.checker_device_calls += 1
        self.checker_device_s += seconds

    def fetch(self, tree):
        """Books one drain of `tree` (tensors, or dataclasses / dicts /
        tuples of them) and the host-blocked wall time of reading it.
        Returns the tree as numpy arrays (copies)."""
        self.drains += 1
        self.host_bytes += sum(t.numel() * t.element_size()
                               for _p, t in leaves(tree))
        t0 = time.perf_counter()
        out = tree_map(lambda t: np.array(t.cpu().numpy()), tree)
        self.blocked_s += time.perf_counter() - t0
        return out

    def as_dict(self) -> dict:
        out = {"drains": self.drains, "host-bytes": self.host_bytes,
               "host-blocked-s": round(self.blocked_s, 6),
               # no overlapped analysis pipeline: nothing overlaps
               "host-overlapped-s": 0.0}
        if self.checker_device_calls:
            out["checker-device-calls"] = self.checker_device_calls
            out["checker-device-s"] = round(self.checker_device_s, 6)
        if self.host_polls:
            out["host-polls"] = self.host_polls
            out["host-poll-s"] = round(self.host_poll_s, 6)
            out["host-wall-per-wave"] = round(
                self.host_poll_s / self.host_polls, 9)
        return out
