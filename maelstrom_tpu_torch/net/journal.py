"""The network journal: a log of every send/recv event.

A copy of the batched half of `maelstrom_tpu/net/journal.py`: the runner
logs the device's messages in numpy batches (`log_batch`: id, time,
type, src and dest indices; bodies stay on the device), and `close`
spills them to `net-journal/` in the store dir as `events.jsonl` (empty:
no host-path events) and one `.npz` chunk a batch, in the layout the JAX
package's `Journal.load` reads.
"""

from __future__ import annotations

import os

import numpy as np


class Journal:
    def __init__(self, dir: str | None = None):
        self.dir = dir
        self.chunks: list[dict] = []    # batched numpy event chunks
        self.host_bytes = 0             # bytes ingested via log_batch
        self.closed = False

    def log_batch(self, type: str, ids, times, srcs, dests, node_names=None):
        """Record a batch of events from device arrays. srcs/dests are node
        *indices*; node_names maps index -> node id string (kept per-chunk so
        stats can classify client vs server traffic)."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return
        chunk = {"type": type,
                 "ids": ids.astype(np.int64),
                 "times": np.asarray(times).astype(np.int64),
                 "srcs": np.asarray(srcs).astype(np.int32),
                 "dests": np.asarray(dests).astype(np.int32),
                 "node_names": node_names}
        self.chunks.append(chunk)
        self.host_bytes += sum(int(chunk[k].nbytes)
                               for k in ("ids", "times", "srcs", "dests"))

    def counts(self) -> dict:
        n_batch = sum(len(c["ids"]) for c in self.chunks)
        return {"host-events": 0, "batched-events": n_batch,
                "total": n_batch, "host-bytes": self.host_bytes}

    # --- persistence (reference journal.clj:183-223 writes stripes) ---

    def close(self):
        if self.closed or not self.dir:
            self.closed = True
            return
        os.makedirs(self.dir, exist_ok=True)
        open(os.path.join(self.dir, "events.jsonl"), "w").close()
        for i, ch in enumerate(self.chunks):
            np.savez_compressed(
                os.path.join(self.dir, f"chunk-{i:06d}.npz"),
                type=ch["type"], ids=ch["ids"], times=ch["times"],
                srcs=ch["srcs"], dests=ch["dests"],
                node_names=np.array(ch["node_names"] or [], dtype=object))
        self.closed = True
