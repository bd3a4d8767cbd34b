#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (`maelstrom_tpu_torch`).

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `maelstrom_tpu_torch/csrc`, holds
each kernel against its plain PyTorch version on the card (exact equality:
they compute on int32 and bool), drives the 1024-node graft path through
the kernels and through the plain versions, and runs the broadcast bench
(`maelstrom_tpu_torch.bench.run_broadcast_bench`) at 16,384 nodes against
the JAX reference's message counts and at 100,000 nodes, the main path.
Every phase prints one JSON line; any failed check exits non-zero. The
last line is `{"ok": true, "device": {...}}`.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. It imports nothing of JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The JAX reference's `recv_all` for bench.py's broadcast workload at
# 16,384 nodes (grid, 64 values, 1 gossip lane, latency 0, pool 8192, 700
# rounds, seed 1), from `maelstrom_tpu.sim.make_run_fn` on the CPU:
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sim.py -m slow \
#       -k reference_counts
PINNED_16K = {"efficient": 4_267_662, "eager": 7_768_330}

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# --- helpers ----------------------------------------------------------------

def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of `fn`: the kernels, copies and fills
    it runs on the card, summed from a `torch.profiler` trace of `iters`
    calls. Host dispatch and the idle gaps it leaves are not counted (a
    wrapper call costs more host time than its kernel takes, so events
    around back-to-back calls would time the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "timing: the trace holds no device time")
    return us / 1e3 / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: int) -> float:
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def max_abs_err(a, b) -> int:
    """Largest |a - b| over the leaves of two trees; raises on a
    mismatch of structure, shape or dtype."""
    from maelstrom_tpu_torch.tree import leaves
    if isinstance(a, tuple):
        check(len(a) == len(b), "tuple length differs")
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    la, lb = leaves(a), leaves(b)
    check([p for p, _ in la] == [p for p, _ in lb], "tree structure differs")
    err = 0
    for (p, x), (_q, y) in zip(la, lb):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"{p}: {tuple(x.shape)} {x.dtype} vs {tuple(y.shape)} "
              f"{y.dtype}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def clone(tree):
    from maelstrom_tpu_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


# --- phases -----------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    emit({"phase": "device", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return line


def phase_build():
    from maelstrom_tpu_torch import kernels as K
    t0 = time.perf_counter()
    lib = K.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib, ROOT)})


def _program(n, V, per_nb, eager=False, naive=False):
    from maelstrom_tpu_torch.nodes import get_program
    return get_program("broadcast",
                       {"topology": "grid", "max_values": V,
                        "gossip_per_neighbor": per_nb,
                        "latency": {"mean": 0}, "eager_resend": eager,
                        "naive_broadcast": naive},
                       [f"n{i}" for i in range(n)], device="cuda")


def _random_channels(g, cfg):
    import torch
    from maelstrom_tpu_torch.net.static import EdgeChannels
    shape = (cfg.n_nodes, cfg.degree, cfg.ring, cfg.lanes)

    def ints():
        return torch.randint(-99, 99, shape, generator=g, device="cuda",
                             dtype=torch.int32)
    return EdgeChannels(
        valid=torch.rand(shape, generator=g, device="cuda") < 0.4,
        type=ints(), a=ints(), b=ints(), c=ints(),
        overwrites=torch.zeros((), dtype=torch.int32, device="cuda"),
        lat_clipped=torch.zeros((), dtype=torch.int32, device="cuda"))


def _random_edge_msgs(g, shape, V, W):
    import torch
    from maelstrom_tpu_torch.net.static import EdgeMsgs
    typ = torch.tensor([14, 14, 15, 0], dtype=torch.int32, device="cuda")[
        torch.randint(0, 4, shape, generator=g, device="cuda")]
    a = torch.where(typ == 15,
                    torch.randint(0, W + 1, shape, generator=g,
                                  device="cuda"),
                    torch.randint(-2, V + 3, shape, generator=g,
                                  device="cuda")).to(torch.int32)

    def word():
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             device="cuda", dtype=torch.int32)
    return EdgeMsgs(valid=torch.rand(shape, generator=g, device="cuda") < 0.6,
                    type=typ, a=a, b=word(), c=word())


def _random_client(g, N, K, V):
    import torch
    from maelstrom_tpu_torch.net.tpu import Msgs

    def ints(lo, hi):
        return torch.randint(lo, hi, (N, K), generator=g, device="cuda",
                             dtype=torch.int32)
    typ = torch.tensor([10, 10, 12, 0], dtype=torch.int32, device="cuda")[
        torch.randint(0, 4, (N, K), generator=g, device="cuda")]
    return Msgs(valid=torch.rand((N, K), generator=g, device="cuda") < 0.01,
                src=ints(N, N + 1), dest=ints(0, N), due=ints(0, 99),
                mid=ints(0, 9999), reply_to=ints(-1, 0), type=typ,
                a=ints(-1, V + 2), b=ints(0, 9), c=ints(0, 9))


def kernel_checks(shape_name, n, V, per_nb, timed):
    """Each kernel against its plain version on random inputs at one
    shape; returns {kernel: {max_abs_err, ms, plain_ms, bound_ms}} (times
    only when `timed`)."""
    import torch
    from maelstrom_tpu_torch import sim as S
    from maelstrom_tpu_torch.net import static
    from maelstrom_tpu_torch.net.tpu import Msgs
    from maelstrom_tpu_torch.tree import tree_map
    g = torch.Generator(device="cuda")
    g.manual_seed(n + V)
    prog = _program(n, V, per_nb)
    cfg = prog.edge_cfg
    N, D, L, W, Kc = n, prog.D, cfg.lanes, prog.n_windows, prog.inbox_cap
    rnd = torch.tensor(17, dtype=torch.int32, device="cuda")
    out = {}

    def record(name, err, fn_k=None, fn_p=None, n_bytes=0):
        check(err == 0, f"{name} at the {shape_name} shape differs from its "
              f"plain version (max abs err {err})")
        r = {"max_abs_err": err, "bound_ms": bound_ms(n_bytes)}
        if timed:
            r["ms"] = cuda_ms(fn_k)
            r["plain_ms"] = cuda_ms(fn_p)
        out[name] = r

    # K1 edge_read
    ch = _random_channels(g, cfg)
    ck, cp = clone(ch), clone(ch)
    ck, ink = static.edge_read(cfg, ck, prog.neighbors, prog.rev, rnd)
    cp, inp = static.edge_read_plain(cfg, cp, prog.neighbors, prog.rev, rnd)
    torch.cuda.synchronize()
    lanes = N * D * L
    record("edge_read", max(max_abs_err(ck, cp), max_abs_err(ink, inp)),
           lambda: static.edge_read(cfg, ck, prog.neighbors, prog.rev, rnd),
           lambda: static.edge_read_plain(cfg, cp, prog.neighbors, prog.rev,
                                          rnd),
           lanes * (17 + 17 + 1) + N * D * 8)

    # K2 edge_write: first the per-lane latency form at ring 4 (exactness
    # only), then the form the round calls, timed: the program's channels
    # (ring 2, uniform arrival), the constant latency 0 as a broadcast
    # scalar and the per-edge deliver mask broadcast over lanes
    per_lane = static.EdgeConfig(n_nodes=N, degree=D, lanes=L, ring=4)
    forms = (
        (per_lane,
         torch.randint(0, 6, (N, D, L), generator=g, device="cuda",
                       dtype=torch.int32),
         torch.rand((N, D, L), generator=g, device="cuda") < 0.9),
        (cfg, torch.zeros((), dtype=torch.int32,
                          device="cuda").expand(N, D, L),
         (torch.rand((N, D, 1), generator=g, device="cuda")
          < 0.9).expand(N, D, L)))
    check(cfg.uniform_arrival and cfg.ring == 2,
          f"the bench program's channels are {cfg}, not ring 2 uniform")
    for wcfg, lat, mask in forms:
        ch = _random_channels(g, wcfg)
        eo = _random_edge_msgs(g, (N, D, L), V, W)
        ck, cp = clone(ch), clone(ch)
        static.edge_write(wcfg, ck, eo, rnd, lat, mask)
        static.edge_write_plain(wcfg, cp, eo, rnd, lat, mask)
        torch.cuda.synchronize()
        err = max_abs_err(ck, cp)
        check(err == 0, f"edge_write (ring {wcfg.ring}, uniform "
              f"{wcfg.uniform_arrival}) at the {shape_name} shape differs "
              f"(max abs err {err})")
    # bytes it needs: every lane's out.valid, the [N, D] mask and the
    # scalar latency; for each written lane its 4 fields, the cell's valid
    # (the overwrite count) and the 17 bytes of the cell
    ok_lanes = int((eo.valid & mask).sum())
    record("edge_write", err,
           lambda: static.edge_write(wcfg, ck, eo, rnd, lat, mask),
           lambda: static.edge_write_plain(wcfg, cp, eo, rnd, lat, mask),
           lanes + N * D + 4 + ok_lanes * (16 + 1 + 17))

    # K3 edge_step, every mode
    for mode in ("efficient", "eager", "naive"):
        p = _program(n, V, per_nb, eager=mode == "eager",
                     naive=mode == "naive")
        Lp = p.edge_cfg.lanes
        state = {"seen": torch.rand((N, V), generator=g, device="cuda") < .3,
                 "owed": torch.rand((N, D, W), generator=g,
                                    device="cuda") < .3,
                 **{k: torch.rand((N, D, V), generator=g, device="cuda") < .2
                    for k in ("pending", "inflight", "inflight_old")}}
        ein = _random_edge_msgs(g, (N, D, Lp), V, W)
        cin = _random_client(g, N, Kc, V)
        ctx = {"round": rnd}
        for rr in (p.retry_rounds * 3, p.retry_rounds * 3 + 1):
            rnd_t = torch.tensor(rr, dtype=torch.int32, device="cuda")
            got = p.edge_step(state, ein, cin, {"round": rnd_t})
            ref = p.edge_step_plain(state, ein, cin, rnd_t)
            torch.cuda.synchronize()
            err = max_abs_err(got, ref)
            check(err == 0, f"edge_step ({mode}, round {rr}) at the "
                  f"{shape_name} shape differs (max abs err {err})")
        if mode == "efficient":
            so, eo2, co = got
            # the client fields the step reads: at V <= 64 the replies'
            # b and c are the packed seen words, not the request's
            c_read = ("valid", "src", "due", "mid", "type", "a") + (
                () if V <= 64 else ("b", "c"))
            io_bytes = (nbytes(*state.values(), *[getattr(ein, f) for f in
                                                  ("valid", "type", "a",
                                                   "b", "c")],
                               *[getattr(cin, f) for f in c_read],
                               p.neighbors)
                        + nbytes(*so.values(),
                                 *[getattr(eo2, f) for f in
                                   ("valid", "type", "a", "b", "c")],
                                 *[getattr(co, f) for f in
                                   Msgs.__dataclass_fields__]))
            record("broadcast_step", err,
                   lambda: p.edge_step(state, ein, cin, ctx),
                   lambda: p.edge_step_plain(state, ein, cin, rnd),
                   io_bytes)

    # K4 reply compaction: a sparse round (the main path's) and a dense one
    CC = 2
    for p_valid in (0.5, 3.0 / (N * Kc)):
        flat = tree_map(lambda f: f.reshape(N * Kc),
                        _random_client(g, N, Kc, V))
        flat = flat.replace(valid=torch.rand(N * Kc, generator=g,
                                             device="cuda") < p_valid)
        nm = torch.tensor(1234, dtype=torch.int32, device="cuda")
        for cc in (CC, 7):
            got = S.compact_replies(flat, Kc, cc, nm)
            ref = S.compact_replies_plain(flat, Kc, cc, nm)
            torch.cuda.synchronize()
            err = max_abs_err(got, ref)
            check(err == 0, f"reply_compact (p={p_valid}, CC={cc}) at the "
                  f"{shape_name} shape differs (max abs err {err})")
    record("reply_compact", err,
           lambda: S.compact_replies(flat, Kc, CC, nm),
           lambda: S.compact_replies_plain(flat, Kc, CC, nm),
           N * Kc + CC * (1 + 7 * 4) + 4 + CC * 37 + 4)
    return out


BENCH_SHAPE = ("bench", 100_000, 64, 1)   # name, nodes, values, per_nb
GRAFT_SHAPE = ("graft", 1024, 32, 4)


def phase_kernels(shapes, timed):
    res = {}
    for shape_name, n, V, per_nb in shapes:
        t0 = time.perf_counter()
        r = kernel_checks(shape_name, n, V, per_nb, timed)
        emit({"phase": "kernels_vs_plain", "shape": shape_name,
              "nodes": n, "values": V, "gossip_per_neighbor": per_nb,
              "timed": timed, "seconds": time.perf_counter() - t0,
              "kernels": r})
        res[shape_name] = r
    return res


def phase_graft():
    """The graft-entry shape (1024-node grid, pool 16384, 32 values, 4
    gossip lanes): 64 rounds of broadcasts, then reads, through the
    kernels and then through the plain versions, on the card."""
    import numpy as np
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch.net.tpu import Msgs, NetConfig
    from maelstrom_tpu_torch.nodes.broadcast import T_BCAST, T_READ
    from maelstrom_tpu_torch.sim import make_run_fn, make_sim
    from maelstrom_tpu_torch.tree import to_numpy
    N, V, R, M = 1024, 32, 64, 2
    prog = _program(N, V, 4)
    cfg = NetConfig(n_nodes=N, n_clients=1, pool_cap=16384,
                    inbox_cap=prog.inbox_cap, client_cap=0)
    rng = np.random.default_rng(11)
    rr = np.arange(R)[:, None] * M + np.arange(M)[None, :]
    col = {"valid": rng.random((R, M)) < 0.9,
           "src": np.full((R, M), N), "dest": rng.integers(0, N, (R, M)),
           "type": np.where(rr < V, T_BCAST, T_READ), "a": rr % V}
    plan = Msgs.empty((R, M), "cuda").replace(
        **{k: torch.tensor(np.asarray(v), device="cuda").to(
            torch.bool if k == "valid" else torch.int32)
           for k, v in col.items()})
    run_fn = make_run_fn(prog, cfg, collect_client_msgs=True)
    before = K.launch_counts()
    sim_k, msgs_k = run_fn(make_sim(prog, cfg, seed=3), plan)
    torch.cuda.synchronize()
    grew = {k: K.launch_counts()[k] - before[k] for k in before}
    with K.forced_plain():
        flat_before = K.launch_counts()
        sim_p, msgs_p = run_fn(make_sim(prog, cfg, seed=3), plan)
        torch.cuda.synchronize()
        check(K.launch_counts() == flat_before,
              "a kernel launched inside forced_plain")
    a, b = to_numpy(sim_k), to_numpy(sim_p)

    def walk(x, y, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif x is None:
            check(y is None, path)
        else:
            check(np.array_equal(x, y), f"graft path: {path} differs between "
                  f"the kernels and the plain versions")
    walk(a, b, "sim")
    mk, mp = to_numpy(msgs_k), to_numpy(msgs_p)
    check(np.array_equal(mk["valid"], mp["valid"]), "graft replies differ")
    for k in mk:
        check(np.array_equal(mk[k][mk["valid"]], mp[k][mk["valid"]]),
              f"graft replies: {k} differs")
    check(all(v > 0 for v in grew.values()),
          f"graft path did not launch every kernel: {grew}")
    emit({"phase": "graft_path", "nodes": N, "values": V, "rounds": R,
          "equal": True, "launches": grew,
          "replies": int(mk["valid"].sum()),
          "recv_all": int(sim_k.net.stats.recv_all)})


def _bench_checks(rec, pins=None):
    for pre in ("eager_", ""):
        mode = "eager" if pre else "efficient"
        check(rec[f"{pre}converged"], f"{rec['nodes']} nodes, {mode}: "
              f"not converged")
        check(rec[f"{pre}dropped_overflow"] == 0,
              f"{rec['nodes']} nodes, {mode}: pool overflow")
        check(rec[f"{pre}overwrites"] == 0,
              f"{rec['nodes']} nodes, {mode}: channel overwrites")
        if pins is not None:
            check(rec[f"{pre}messages_delivered"] == pins[mode],
                  f"{rec['nodes']} nodes, {mode}: delivered "
                  f"{rec[f'{pre}messages_delivered']}, the JAX reference "
                  f"{pins[mode]}")


def _bench_line(rec, smi, extra):
    keep = ("nodes", "values", "rounds", "messages_delivered", "converged",
            "wall_s", "msgs_per_sec", "ms_per_round", "dropped_overflow",
            "overwrites")
    line = {k: rec[k] for k in keep}
    line.update({f"eager_{k}": rec[f"eager_{k}"] for k in keep[3:]})
    line.update({"device": rec["device"], "nvidia_smi": smi, **extra})
    return line


def phase_bench_16k(smi):
    from maelstrom_tpu_torch.bench import run_broadcast_bench
    rec = run_broadcast_bench(n_nodes=16_384, values=64, rounds=700,
                              gossip=1, pool=8192, eager=True, seed=1)
    _bench_checks(rec, PINNED_16K)
    emit({"phase": "bench_16k",
          **_bench_line(rec, smi, {"jax_reference": PINNED_16K})})


def phase_main_path(smi):
    """The main path: the 100,000-node bench in both modes, with every
    launch counter set to 0 just before and read just after."""
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch.bench import run_broadcast_bench
    K.reset_launches()
    rec = run_broadcast_bench(n_nodes=100_000, values=64, rounds=700,
                              gossip=1, pool=8192, eager=True, seed=1)
    launches = K.launch_counts()
    _bench_checks(rec)
    check(all(v > 0 for v in launches.values()),
          f"the main path did not launch every kernel: {launches}")
    emit({"phase": "bench_100k", **_bench_line(rec, smi,
                                               {"launches": launches})})
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "maelstrom_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(maelstrom_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from maelstrom_tpu_torch import kernels as K

    smi = phase_device()
    phase_build()
    checks = phase_kernels([BENCH_SHAPE, GRAFT_SHAPE], timed=False)
    phase_graft()
    phase_bench_16k(smi)
    launches = phase_main_path(smi)
    # kernel times last: the profiler they are read from stays out of
    # the bench phases' wall-clock timing
    bench = phase_kernels([BENCH_SHAPE], timed=True)["bench"]

    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": max(r[k.name]["max_abs_err"] for r in
                            (checks["bench"], checks["graft"], bench)),
         "ms": bench[k.name]["ms"], "plain_ms": bench[k.name]["plain_ms"],
         "bound_ms": bench[k.name]["bound_ms"], "bound_by": "bytes",
         "library_ms": None} for k in K.KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
