"""The launch plans the port's wrappers compute in Python for their CUDA
kernels, checked on the CPU (the kernels themselves run only on the card,
where `tests/test_torch_kernels_gpu.py` holds them to their plain
versions; each kernel's C entry point rejects a plan that is not the
one these functions give).

- K15 (`nodes/broadcast_batched.py` `batched_plan`): P lanes a row, rows
  a warp, tiles and shared memory for every table size V from 1 to 2^20:
  a row on any 16-byte offset fits its lanes or its tiles, and the block's
  shared memory stays within the H100's 232,448 bytes.
- K32 (`sim.py` `hold_plan`): the chunk-offset table covers every byte of
  every leaf exactly once, at every row offset on the 16-byte grid, and
  the blocks' slices cover every chunk of a row once, for leaves of 0 to
  100,000 bytes a row."""

from __future__ import annotations

import numpy as np
import pytest

from maelstrom_tpu_torch.nodes.broadcast_batched import (K15_TILE,
                                                         K15_WARPS,
                                                         batched_plan)
from maelstrom_tpu_torch.sim import hold_chunks, hold_plan

H100_SMEM = 232_448       # shared memory a block can use (bytes)


def test_batched_plan_every_table_size():
    """Every V in [1, 2^20]: P a power of two (32 / P rows a warp),
    growing with V; without tiles the fewest lanes whose 16P values
    cover V + 15 (a row at any 16-byte offset), with tiles P is 32 and
    the fewest tiles that cover V + 15; shared memory within the
    card's."""
    prev_P = 1
    for V in range(1, 2**20 + 1):
        plan = batched_plan(7, 4, V)
        P = plan["P"]
        assert P & (P - 1) == 0 and 1 <= P <= 32
        assert P >= prev_P
        prev_P = P
        assert plan["rows_per_warp"] * P == 32
        if plan["tiles"] == 1 and 16 * P >= V + 15:
            assert P == 1 or 8 * P < V + 15   # the fewest lanes
        else:
            assert P == 32 and plan["tiles"] * K15_TILE >= V + 15
            assert (plan["tiles"] - 1) * K15_TILE < V + 15
        assert plan["smem_bytes"] <= H100_SMEM


@pytest.mark.parametrize("N,D,V", [(1, 1, 1), (5, 3, 17), (100_000, 4, 1024),
                                   (4096, 4, 512), (1089, 4, 300_256),
                                   (33, 2, 64)])
def test_batched_plan_covers_every_row(N, D, V):
    """The edge warps hold N * D rows and the node warps N, each warp
    32 / P rows, the blocks K15_WARPS warps."""
    plan = batched_plan(N, D, V)
    rows = plan["rows_per_warp"]
    ew, nw = plan["edge_warps"], plan["node_warps"]
    assert (ew - 1) * rows < N * D <= ew * rows
    assert (nw - 1) * rows < N <= nw * rows
    blocks = plan["blocks"]
    assert (blocks - 1) * K15_WARPS < ew + nw <= blocks * K15_WARPS


def _chunk_bytes(rb, r, o):
    """Bytes [lo, hi) of a leaf's row that its chunk r copies (csrc/fleet.cu
    hold_chunk): from the row's start for rb a multiple of 16, else on
    the 16-byte grid of the row's address, o its offset on that grid."""
    if rb % 16 == 0:
        return 16 * r, 16 * r + 16
    return max(16 * r - o, 0), min(16 * r + 16 - o, rb)


def _leaf_cover(row_bytes):
    """Every leaf's chunks cover each byte of its row once, the row at
    every offset on the 16-byte grid."""
    off, _rows, _slice = hold_plan(tuple(row_bytes))
    assert off[0] == 0 and len(off) == len(row_bytes) + 1
    for k, rb in enumerate(row_bytes):
        assert off[k + 1] - off[k] == hold_chunks(rb)
        for o in range(16) if rb % 16 else (0,):
            hits = np.zeros(rb, np.int64)
            for r in range(off[k + 1] - off[k]):
                lo, hi = _chunk_bytes(rb, r, o)
                assert hi <= rb
                hits[lo:max(hi, lo)] += 1
            assert (hits == 1).all(), f"leaf {k} at offset {o}"


ROW_SETS = {
    "narrow": [1, 2, 3, 5, 16, 17, 4000],
    "empty-leaf": [0, 4, 0, 33],
    "lin-kv-like": [64, 256, 256, 4, 40, 5, 4, 8] * 12,
    "bench-like": [64] + [4] * 95,
    "wide": [60_300, 241_200, 241_200, 241_200, 241_200, 4, 4],
    "one-big": [100_000],
}


@pytest.mark.parametrize("name", list(ROW_SETS))
def test_hold_plan_covers_every_byte_once(name):
    _leaf_cover(ROW_SETS[name])


def test_hold_plan_random_leaf_sets():
    rng = np.random.default_rng(32)
    for _ in range(50):
        n = int(rng.integers(1, 97))
        _leaf_cover([int(x) for x in rng.integers(0, 3000, n)])


@pytest.mark.parametrize("name", list(ROW_SETS))
def test_hold_plan_slices_cover_every_chunk_once(name):
    """Block row y of the grid copies chunks [y * slice, (y + 1) * slice)
    of its rows: the slices cover the row's C chunks once; a block's rows
    times its slice stay within one flag a thread and int."""
    off, rows, slice_ = hold_plan(tuple(ROW_SETS[name]))
    C = off[-1]
    slices = max(1, -(-C // slice_))
    hits = np.zeros(C, np.int64)
    for y in range(slices):
        hits[y * slice_:min((y + 1) * slice_, C)] += 1
    assert (hits == 1).all()
    assert 1 <= rows <= 256 and slices <= 65_535
    assert rows * slice_ < 2**31 - 1024
    assert slice_ <= 1024
