"""Device-resident Elle: the dependency-edge build and the cycle screen of
the txn-list-append checker on the card.

Counterpart of `maelstrom_tpu/checkers/elle_device.py`. The host checker
(`checkers/elle.py`) builds ww/wr/rw dependency edges and runs Tarjan
SCC in Python; this module runs the two hot pieces on the device:

1. **Edge construction** (`elle_edges`, kernel K16): the per-key version
   tables concatenate into one writer table on the host, and the ww
   consecutive-writer pairs plus every read's wr/rw gathers come out as
   one batch of candidate rows, the same `(src, dst, kind)` edge set as
   `elle._edges_vectorized`.

2. **Cycle screen** (`elle_screen`, kernel K17): label propagation to a
   fixed point. The screen looks for a *strict potential* phi: an
   integer label per transaction that increases along every dependency
   edge (and, for the realtime stage, along the realtime closure). Each
   iteration raises phi by one segment max over the edge list plus one
   prefix max over the ret-ordered labels (the whole realtime closure in
   one step). Zero violated constraints make phi a topological
   certificate: the graph is **definitely acyclic** and Tarjan is
   skipped. A cap hit or a phi that stops changing answers *undecided*
   and the host Tarjan path runs on the identical edge set. Iterations
   are Jacobi steps (every step reads the previous phi), so their counts
   equal the JAX package's.

   Two stages, two seeds: the data stage starts from the *version
   potential* (2*version-index+1 for writers, 2*observed-length for
   readers), the realtime stage from the *ret-rank potential* (position
   in completion order).

Everything stays int32/bool; the ret order is precomputed on the host
with a stable argsort. Each function has its plain PyTorch version
beside it (`elle_edges_plain`, `elle_screen_plain`); tensors on the CPU
take it, tensors on the card launch the kernel (`kernels.use_kernel`)."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import kernels as K
from ..tree import resolve_device

KIND_WW, KIND_WR, KIND_RW = 0, 1, 2
KIND_NAMES = ("ww", "wr", "rw")

# relaxation cap per screen stage: valid histories converge in a
# handful of iterations (the seeds satisfy the deep constraint families
# analytically); anything still violated after this many rounds falls
# back to host Tarjan
SCREEN_CAP = 32

# `--device-checker auto`: the device path only engages past this many
# transactions; below it the host path is already instant
AUTO_MIN_TXNS = 1024

_NEG = -(2 ** 30)

I32 = torch.int32


def available() -> bool:
    """The device path's backend imports (torch is the port's backend:
    always True, as the JAX package's is wherever jax imports)."""
    return True


def resolve(mode, n_txns: int) -> bool:
    """Maps a `--device-checker` value (on/off/auto, None = auto) to a
    concrete use-the-device decision for this history."""
    if mode in (False, "off", "host", "0"):
        return False
    if mode in (True, "on", "1"):
        return available()
    # auto
    return n_txns >= AUTO_MIN_TXNS and available()


def _pad_to(n: int) -> int:
    """Pow-2 shape buckets (as the JAX package's retrace buckets)."""
    return max(16, 1 << max(0, int(n - 1).bit_length()))


# ---------------------------------------------------------------------------
# Columnar read table (the host-side flatten)
# ---------------------------------------------------------------------------

class ElleColumns:
    """The columnar view of a transaction set's reads: per read, the
    transaction id, an interned key id, and the observed list length:
    everything the edge constructor needs from the read side."""

    __slots__ = ("tid", "kid", "n", "key_objs", "_key_ids", "micro_ops")

    def __init__(self):
        self.tid: list = []         # txn id per read
        self.kid: list = []         # interned key id per read
        self.n: list = []           # observed list length per read
        self.key_objs: list = []    # interned raw key objects
        self._key_ids: dict = {}    # raw key (or repr fallback) -> id
        self.micro_ops = 0

    def key_id(self, k) -> int:
        try:
            ki = self._key_ids.get(k)
        except TypeError:           # unhashable key: intern by repr
            k2 = repr(k)
            ki = self._key_ids.get(k2)
            if ki is None:
                ki = self._key_ids[k2] = len(self.key_objs)
                self.key_objs.append(k)
            return ki
        if ki is None:
            ki = self._key_ids[k] = len(self.key_objs)
            self.key_objs.append(k)
        return ki

    def add_txn(self, tid: int, micro) -> None:
        """Appends one OK transaction's reads to the table. The read
        filter MUST match the host edge builders' `isinstance(v, list)`:
        a narrower check would drop a list-subclass read's wr/rw
        constraints from the screen, letting it certify a graph whose
        true edge set is cyclic."""
        ta, ka, na = self.tid.append, self.kid.append, self.n.append
        self.micro_ops += len(micro)
        for m in micro:
            if m[0] == "r":
                v = m[2]
                if isinstance(v, list):
                    ta(tid)
                    ka(self.key_id(m[1]))
                    na(len(v))

    def key_lut(self, key_idx: dict, hk) -> np.ndarray:
        """Maps interned key ids to positions in the checker's version
        table (`key_idx`, keyed by `hk(key)`); -1 = key never observed."""
        return np.fromiter(
            (key_idx.get(hk(k), -1) for k in self.key_objs),
            np.int32, len(self.key_objs))


def build_columns(txns) -> ElleColumns:
    """One-shot flatten of a transaction list: one Python pass over the
    micro-ops; everything after is numpy and the device."""
    cols = ElleColumns()
    add = cols.add_txn
    for i, t in enumerate(txns):
        if t["ok"]:
            add(i, t["micro"])
        else:
            cols.micro_ops += len(t["micro"])
    return cols


# ---------------------------------------------------------------------------
# K16 elle_edges and K17 elle_screen, with their plain versions
# ---------------------------------------------------------------------------

def elle_edges_plain(writers, slot_key, r_tid, wr_pos, rw_pos):
    """Candidate (src, dst, kind, valid) rows: the ww consecutive-writer
    pairs inside each key's span ([0, Vp-1)), then every read's wr
    gather, then its rw gather ([Rp] each), duplicates allowed (the set
    view dedups on the host, the screen is duplicate-indifferent).
    Positions gather clamped into the table, as XLA's gathers do."""
    vp = writers.shape[0]
    a, b = writers[:-1], writers[1:]
    ww_ok = (slot_key[:-1] == slot_key[1:]) & (slot_key[1:] >= 0) \
        & (a >= 0) & (b >= 0) & (a != b)
    wsrc = writers[wr_pos.clamp(0, vp - 1).long()]
    wr_ok = (wr_pos >= 0) & (r_tid >= 0) & (wsrc >= 0) & (wsrc != r_tid)
    rdst = writers[rw_pos.clamp(0, vp - 1).long()]
    rw_ok = (rw_pos >= 0) & (r_tid >= 0) & (rdst >= 0) & (rdst != r_tid)

    def full(like, v):
        return torch.full(like.shape, v, dtype=I32, device=like.device)
    src = torch.cat([a, wsrc, r_tid])
    dst = torch.cat([b, r_tid, rdst])
    kind = torch.cat([full(a, KIND_WW), full(wsrc, KIND_WR),
                      full(r_tid, KIND_RW)])
    valid = torch.cat([ww_ok, wr_ok, rw_ok])
    return src, dst, kind, valid


def elle_edges(writers, slot_key, r_tid, wr_pos, rw_pos):
    """K16 (`csrc/elle.cu`): `elle_edges_plain`'s rows, one thread a
    candidate row."""
    if not K.use_kernel(writers):
        return elle_edges_plain(writers, slot_key, r_tid, wr_pos, rw_pos)
    dev = writers.device
    vp, rp = writers.numel(), r_tid.numel()
    n = vp - 1 + 2 * rp
    src, dst, kind = (torch.empty(n, dtype=I32, device=dev)
                      for _ in range(3))
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    K.ELLE_EDGES.launch([writers, slot_key, r_tid, wr_pos, rw_pos, src,
                         dst, kind, valid], [vp, rp], dev)
    return src, dst, kind, valid


def elle_screen_plain(writers, slot_key, slot_idx, r_tid, r_n, wr_pos,
                      rw_pos, ret_tid, before_idx, n_txns_pad,
                      do_rt=True):
    """int32 [data_acyclic, full_acyclic, data_iters, full_iters]. The
    phi arrays are [n_txns_pad]; padded and absent transactions carry no
    constraint. With do_rt False the realtime stage is skipped (full
    false, 0 iterations). Each stage iterates `phi -> step(phi)` while
    some constraint is violated, phi changed and fewer than SCREEN_CAP
    steps ran; the violation count is taken on the new phi."""
    N = int(n_txns_pad)
    dev = writers.device
    src, dst, _kind, valid = elle_edges_plain(writers, slot_key, r_tid,
                                              wr_pos, rw_pos)
    es, ed = src[valid].long(), dst[valid].long()

    def seg_max0(ids, vals):
        # max(0, segment max): empty segments and padding give 0
        out = torch.zeros(N, dtype=I32, device=dev)
        keep = ids >= 0
        return out.scatter_reduce_(0, ids[keep].long(), vals[keep],
                                   "amax")

    def data_step(phi):
        nphi = phi.clone()
        return nphi.scatter_reduce_(0, ed, phi[es] + 1, "amax")

    def data_viol(phi):
        return int((phi[es] >= phi[ed]).sum())

    has_b = before_idx >= 0
    b_t = torch.nonzero(has_b).flatten()
    b_at = before_idx[has_b].long()
    has_r = ret_tid >= 0
    neg = torch.tensor(_NEG, dtype=I32, device=dev)

    def rt_bound(phi):
        # phi in ret order; the prefix max is the full realtime closure
        # (every txn whose ret precedes my inv) in one step: [len(b_t)]
        pr = torch.where(has_r, phi[ret_tid.clamp(min=0).long()], neg)
        return torch.cummax(pr, 0).values[b_at] + 1

    def fixpoint(phi, step, viol):
        it, v, changed = 0, viol(phi), True
        while v > 0 and changed and it < SCREEN_CAP:
            nphi = step(phi)
            it, v = it + 1, viol(nphi)
            changed = bool((nphi != phi).any())
            phi = nphi
        return it, v

    # --- data stage: version-potential seed
    phi0 = torch.maximum(seg_max0(writers, 2 * slot_idx + 1),
                         seg_max0(r_tid, 2 * r_n))
    it_a, v_a = fixpoint(phi0, data_step, data_viol)
    if not do_rt:
        return torch.tensor([v_a == 0, False, it_a, 0], dtype=I32,
                            device=dev)

    # --- realtime stage: ret-rank seed
    rank = torch.arange(1, N + 1, dtype=I32, device=dev)
    phi_rank = seg_max0(ret_tid, rank)

    def full_step(phi):
        nphi = data_step(phi)
        nphi[b_t] = torch.maximum(nphi[b_t], rt_bound(phi))
        return nphi

    def full_viol(phi):
        return data_viol(phi) + int((phi[b_t] < rt_bound(phi)).sum())

    it_b, v_b = fixpoint(phi_rank, full_step, full_viol)
    return torch.tensor([v_a == 0, v_b == 0, it_a, it_b], dtype=I32,
                        device=dev)


def elle_screen(writers, slot_key, slot_idx, r_tid, r_n, wr_pos, rw_pos,
                ret_tid, before_idx, n_txns_pad, do_rt=True):
    """K17 (`csrc/elle.cu`): `elle_screen_plain`'s verdict. One call runs
    both stages; the C entry point drives the loop, reading a two-word
    flag (violations, changed) once an iteration."""
    if not K.use_kernel(writers):
        return elle_screen_plain(writers, slot_key, slot_idx, r_tid, r_n,
                                 wr_pos, rw_pos, ret_tid, before_idx,
                                 n_txns_pad, do_rt)
    dev = writers.device
    vp, rp, tp = writers.numel(), r_tid.numel(), int(n_txns_pad)
    n = vp - 1 + 2 * rp
    blocks = -(-tp // 1024)

    def empty(k):
        return torch.empty(k, dtype=I32, device=dev)
    out = empty(4)
    # scratch: compacted edges (-1 = invalid), phi, the next phi, the
    # ret-order prefix max, the prefix max's block carries, the flags
    scratch = [empty(n), empty(n), empty(tp), empty(tp), empty(tp),
               empty(blocks), empty(2)]
    K.ELLE_SCREEN.launch([writers, slot_key, slot_idx, r_tid, r_n, wr_pos,
                          rw_pos, ret_tid, before_idx, out, *scratch],
                         [vp, rp, tp, int(bool(do_rt)), SCREEN_CAP], dev)
    return out


# ---------------------------------------------------------------------------
# Host-side assembly
# ---------------------------------------------------------------------------

class DeviceElle:
    """One device analysis: screen verdicts plus a lazy edge-set view.
    `data_acyclic`/`full_acyclic` are definite (True = certified, False
    = undecided, fall back to Tarjan); `edge_set()` materializes the
    Python edge set (identical to `elle._edges_vectorized`) only when
    the fallback needs it, reading the device arrays through the run's
    `TransferStats` when it has one."""

    def __init__(self, edge_arrays, data_acyclic, full_acyclic, iters,
                 stats, transfer=None):
        self._edge_arrays = edge_arrays     # (src, dst, kind, valid)
        self.data_acyclic = bool(data_acyclic)
        self.full_acyclic = bool(full_acyclic)
        self.iters = iters
        self.stats = stats
        self._transfer = transfer
        self._set = None

    def edge_set(self) -> set:
        if self._set is None:
            arrs = tuple(self._edge_arrays)
            if isinstance(arrs[0], torch.Tensor):
                arrs = (self._transfer.fetch(arrs) if self._transfer
                        is not None else tuple(a.cpu().numpy()
                                               for a in arrs))
            src, dst, kind, valid = (np.asarray(a) for a in arrs)
            m = valid.astype(bool)
            s, d, k = src[m].tolist(), dst[m].tolist(), kind[m].tolist()
            self._set = set(zip(s, d, (KIND_NAMES[x] for x in k)))
        return self._set

    def report(self) -> dict:
        """The deterministic `device` block for checker results (no
        wall times here: those ride TransferStats)."""
        return {
            "screen": {
                "data": "acyclic" if self.data_acyclic else "undecided",
                "realtime": ("acyclic" if self.full_acyclic
                             else "undecided"),
                "iters": list(self.iters),
            },
            "edges-on-device": True,
            **self.stats,
        }


def _writer_table(longest, appender, hk):
    """Concatenated per-key version tables: (writers, slot_key,
    slot_idx, offsets, lens, key_idx), the host half of the per-key
    version-table merge (one dict gather per version, then numpy)."""
    keys = list(longest)
    key_idx = {kk: i for i, kk in enumerate(keys)}
    nk = len(keys)
    lens = np.fromiter((len(longest[kk]) for kk in keys), np.int64,
                       nk) if nk else np.zeros(0, np.int64)
    offsets = np.zeros(nk + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    ag = appender.get
    writers = np.fromiter(
        (ag((kk, v), -1) for kk in keys for v in longest[kk]),
        np.int64, total) if total else np.zeros(0, np.int64)
    slot_key = np.repeat(np.arange(nk, dtype=np.int64), lens) \
        if total else np.zeros(0, np.int64)
    slot_idx = np.arange(total, dtype=np.int64) - offsets[slot_key] \
        if total else np.zeros(0, np.int64)
    return writers, slot_key, slot_idx, offsets, lens, key_idx


def _padded(arr, n, fill, dtype=np.int32):
    out = np.full(n, fill, dtype)
    out[:len(arr)] = arr
    return out


def read_positions(columns: ElleColumns, key_idx: dict, offsets, lens,
                   hk):
    """Read-side arrays + writer-table gather positions (host numpy,
    exactly the `_edges_vectorized` index math): (tid, n, wr_pos,
    rw_pos), -1 positions masked."""
    n_reads = len(columns.tid)
    if n_reads and len(columns.key_objs):
        lut = columns.key_lut(key_idx, hk)
        ki = lut[np.asarray(columns.kid, np.int64)]
        n_ = np.asarray(columns.n, np.int64)
        tid = np.asarray(columns.tid, np.int64)
        ks = np.maximum(ki, 0)
        has = (ki >= 0) & (n_ > 0)
        if len(lens):
            wr_pos = np.where(has, offsets[ks] + n_ - 1, -1)
            can = (ki >= 0) & (n_ < lens[ks])
            rw_pos = np.where(can, offsets[ks] + n_, -1)
        else:
            wr_pos = rw_pos = np.full(n_reads, -1, np.int64)
        return tid, n_, wr_pos, rw_pos
    z = np.zeros(0, np.int64)
    return z, z, z, z


def device_args(writers, slot_key, slot_idx, tid, n_, wr_pos, rw_pos,
                ok_tids, before, n_txns):
    """The one host->device assembly (pow-2 shape-bucket padding + the
    per-txn realtime index scatter), shared by `screen_arrays` and the
    checker bench so measured timings describe the production path.
    Returns (edge_args, screen_args, n_txns_pad, have_rt) as numpy:
    `screen_args` feeds `elle_screen` (add n_txns_pad/do_rt),
    `edge_args` feeds `elle_edges`."""
    vp = _pad_to(max(len(writers), 1))
    rp = _pad_to(max(len(tid), 1))
    tp = _pad_to(max(n_txns, 1))
    d_writers = _padded(writers, vp, -1)
    d_slot_key = _padded(slot_key, vp, -1)
    d_slot_idx = _padded(slot_idx, vp, 0)
    d_tid = _padded(tid, rp, -1)
    d_n = _padded(n_, rp, 0)
    d_wr = _padded(wr_pos, rp, -1)
    d_rw = _padded(rw_pos, rp, -1)
    have_rt = len(ok_tids) > 0
    ret_tid = _padded(np.asarray(ok_tids, np.int64), tp, -1)
    before_of = np.full(tp, -1, np.int32)
    if have_rt:
        before_of[np.asarray(ok_tids, np.int64)] = \
            np.asarray(before, np.int64)
    edge_args = (d_writers, d_slot_key, d_tid, d_wr, d_rw)
    screen_args = (d_writers, d_slot_key, d_slot_idx, d_tid, d_n,
                   d_wr, d_rw, ret_tid, before_of)
    return edge_args, screen_args, tp, have_rt


def to_device(args, device) -> dict:
    """`device_args`'s numpy arrays as int32 tensors on `device`, one
    upload an array, keyed by the array's id (the five edge args are
    screen args too, uploaded once)."""
    return {id(a): torch.from_numpy(np.ascontiguousarray(a, np.int32))
            .to(device) for a in args}


def screen_arrays(writers, slot_key, slot_idx, tid, n_, wr_pos, rw_pos,
                  ok_tids, before, n_txns, transfer=None,
                  want_edges=True, device="cuda"):
    """Pads the host arrays into pow-2 shape buckets, uploads them to
    `device`, runs the screen (and optionally the edge constructor) and
    reads the verdict. `ok_tids`/`before`: ok txn ids in completion
    order and each position's latest-completion-strictly-before-
    invocation index (-1 = none); pass empty arrays to skip realtime
    certification. Returns a DeviceElle."""
    t0 = time.perf_counter()
    if len(writers) == 0 and len(tid) == 0:
        # no versions and no reads: no edges can exist, and the
        # realtime closure alone is an (interval) partial order
        return DeviceElle((np.zeros(0, np.int32),) * 3
                          + (np.zeros(0, bool),), True, True, (0, 0),
                          {"edge-candidates": 0})

    edge_args, screen_args, tp, have_rt = device_args(
        writers, slot_key, slot_idx, tid, n_, wr_pos, rw_pos, ok_tids,
        before, n_txns)
    dev = resolve_device(device)
    on = to_device(screen_args, dev)
    verdict = elle_screen(*(on[id(a)] for a in screen_args),
                          n_txns_pad=tp, do_rt=have_rt)
    edge_arrays = None
    if want_edges:
        edge_arrays = elle_edges(*(on[id(a)] for a in edge_args))
    verdict = (transfer.fetch(verdict) if transfer is not None
               else verdict.cpu().numpy())
    data_ok, full_ok, it_a, it_b = (int(x) for x in verdict)
    dt = time.perf_counter() - t0
    if transfer is not None:
        transfer.record_checker(dt)
    if not have_rt and n_txns > 1:
        full_ok = False     # no realtime inputs: never certify realtime
    # the combined certificate covers the data subgraph: a realtime-
    # acyclic graph is data-acyclic even when the version-potential
    # stage alone hit its cap
    data_ok = bool(data_ok) or bool(full_ok)
    return DeviceElle(edge_arrays, data_ok, full_ok, (it_a, it_b),
                      {"edge-candidates": int(len(writers) - 1
                                              + 2 * len(tid))
                       if len(writers) else int(2 * len(tid))},
                      transfer=transfer)


def host_arrays(txns, longest, appender, hk, columns=None, rt=None):
    """The host half of the device path over one transaction set: the
    writer table, the read table's gather positions and the realtime
    inputs, as `screen_arrays` takes them (writers, slot_key, slot_idx,
    tid, n, wr_pos, rw_pos, ok_tids, before, n_txns). `rt` is the
    precomputed realtime structure from `elle.analyze`:
    `(ok_tids_in_ret_order, before)` with `before[i]` the ret-order
    index of the last completion strictly before ok-txn i's invocation
    (-1 if none); none (no realtime screening) when rt is None."""
    if columns is None:
        columns = build_columns(txns)
    writers, slot_key, slot_idx, offsets, lens, key_idx = \
        _writer_table(longest, appender, hk)
    tid, n_, wr_pos, rw_pos = read_positions(columns, key_idx, offsets,
                                             lens, hk)
    if rt is not None:
        ok_tids, before = rt
    else:
        ok_tids = before = np.zeros(0, np.int64)
    return (writers, slot_key, slot_idx, tid, n_, wr_pos, rw_pos, ok_tids,
            before, len(txns))


def run(txns, longest, appender, hk, columns: ElleColumns | None = None,
        rt=None, transfer=None, want_edges=True, device="cuda"):
    """Runs the device path over one transaction set (`host_arrays`,
    then `screen_arrays`)."""
    return screen_arrays(*host_arrays(txns, longest, appender, hk,
                                      columns, rt),
                         transfer=transfer, want_edges=want_edges,
                         device=device)


def edges_device(txns, longest, appender, hk=repr, device="cuda"):
    """`edges_impl`-shaped wrapper: the device edge build materialized
    as the Python edge set (tests pin it against both `_edges_python`
    and `_edges_vectorized`). The checker keeps the arrays on the device
    and only materializes them on a screen fallback."""
    return run(txns, longest, appender, hk, rt=None,
               device=device).edge_set()
