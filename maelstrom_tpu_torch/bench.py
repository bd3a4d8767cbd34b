"""The throughput benchmarks on the port: broadcast, Raft clusters, batched
broadcast, the checkers, the compartment's proxy scaling, its leader
failover and its byzantine conviction record.

The same workload as `bench.py`'s broadcast record (`_main_broadcast`): a
grid of `n_nodes` nodes, `values` broadcast values injected one every
other round at Fibonacci-hash spread nodes, one gossip lane per edge,
constant latency 0, pool 8192, 700 rounds. With `eager=True` it runs the
eager-resend protocol and then the efficient send-once-plus-retry one,
and reports the efficient run as the headline with the eager run under
`eager_*` keys, as bench.py does. A run counts only with `converged`
true: every node has seen every value.

    python -m maelstrom_tpu_torch.bench [--nodes N] [--values V] ...

With `--raft` it runs the throughput half of `bench.py`'s
`bench_raft_clusters` (BASELINE config 4): 10,000 independent 5-node
Raft clusters on the cluster axis (`parallel.make_cluster_round_fn`),
300 rounds in chunks of 100, no client traffic, and reports
cluster-rounds a second; it exits 1 unless every cluster has exactly one
leader. The graded half (`bench_raft_graded.py`) comes with the graded
Raft fleet slice, so the record's `graded` is null.

    python -m maelstrom_tpu_torch.bench --raft [--clusters F] [--rounds R]

With `--broadcast-batched` it runs `bench.py`'s batched-vs-eager record
(`bench_broadcast_batched_record`): the batched atomic broadcast node
against the eager-resend gossip node, 4,096 nodes, 512 values, batches
of 32, chunks of 64 rounds, each side timed to its own convergence; it
exits 1 unless both converge.

    python -m maelstrom_tpu_torch.bench --broadcast-batched [--nodes N]

With `--checkers` it runs `bench.py`'s checker-throughput record
(`bench_checkers_record`): a 1,000,000-row lin-kv history through the
linearizability checker (columnar screen against the sequential WGL
path), and the Elle edge build on a 1,000,000-micro-op list-append set
(`elle_synthetic`: 64 keys of 3,125 versions and random prefix reads),
vectorized against the nested-loop build, with the device block: the
same edge set built by kernel K16 and screened by K17 on the card, and
the screen's decided fraction over 12 valid concurrent histories. It
exits 1 unless every verdict and edge set matches and the screen
decides at least 90% of the fixtures.

    python -m maelstrom_tpu_torch.bench --checkers [--device cpu]

With `--compartment` it runs `bench.py`'s proxy-scaling record
(`bench_compartment_record`, `_main_compartment`): lin-kv client ops
against the PROXY count of `--node tpu:compartment` (P = 1, 2, 4, 8), at
one fixed leader and acceptor budget (leader_slots 128, proxy_slots 8,
compartment_inbox 16, a 2x2 grid, two replicas, kv_keys 1,024), offered
8,000 ops a second for 2 s by 96 clients, seed 11, through `core.run`.
The environment's BENCH_COMPARTMENT_PROXIES, _RATE, _TIME_LIMIT and
_CONC override the sweep, as bench.py's do. It exits 1 unless every
point grades valid and 4 proxies complete at least twice the ok ops of
one (`scaling_1_to_4 >= 2`, when both points are in the sweep).

    python -m maelstrom_tpu_torch.bench --compartment [--device cpu]

With `--failover` it runs `bench.py`'s leader-failover record
(`bench_failover_record`, `_main_failover`): `--nemesis-targets
kill=sequencer` kills the LIVE elected leader every 0.7 s on `--node
tpu:compartment --roles sequencers=3,proxies=4,acceptors=2x2,replicas=2`
(leader_slots 128, proxy_slots 8, compartment_inbox 16, kv_keys 1,024,
timeout 400 ms, 48 clients at 200 ops a second for 6 s, 2 s of
recovery, seed 11), through `core.run` (kernels K26-K29). The record
reports completed failovers, forced kills, rounds from candidacy to win,
ok ops a virtual second before, during and after the kill windows, the
longest no-ok gap and the dips past the RPC timeout. BENCH_FAILOVER_RATE,
_TIME_LIMIT and _INTERVAL override the run, as bench.py's do. It exits 1
unless the run grades valid with at least two failovers.

    python -m maelstrom_tpu_torch.bench --failover [--device cpu]

With `--byzantine` it runs `bench.py`'s conviction record
(`bench_byzantine_record`, `_main_byzantine`): the elected compartment
(2 candidates, 2 proxies, a 1x2 grid, 1 replica, retry 3, 1,024 keys;
16 clients at 200 ops a second for 6 s, seed 3) once benign and once
under the equivocating sequencer (`--nemesis byzantine
--nemesis-targets byzantine=sequencers --byz-attacks equivocation`, a
window every 1.5 s). The record reports the attack windows, the injected
ledger and the convictions, the conviction latency in rounds and the ok
ops a virtual second benign and under attack. BENCH_BYZ_RATE,
_TIME_LIMIT and _INTERVAL override the run. It exits 1 unless the
byzantine block grades valid (every injection convicted, none spurious)
and the benign twin grades valid with no block.

    python -m maelstrom_tpu_torch.bench --byzantine [--device cpu]

With `--fleet` it runs `bench.py`'s fleet record (`bench_fleet_record`):
the same 5-node broadcast grid (eager resend, 8 values, pool 64, constant
latency 0) in fleets of 1, 8, 64, 512 and 10,000 clusters, each size 8
dispatches of the fleet scan (`sim.make_fleet_scan_fn`, the dispatch
every fleet wave runs) of 64 rounds, one fresh value a cluster a
dispatch, seeds from the size on. It reports clusters a second (the
campaign's throughput), messages delivered a second over the whole
fleet, the host milliseconds a dispatch and the speed-up over the
1-cluster fleet, and exits 1 unless every size converges (every value
on every node of every cluster) and drops nothing. BENCH_FLEET_SIZES,
_NODES, _VALUES, _CHUNK and _POOL override it, as bench.py's do.

    python -m maelstrom_tpu_torch.bench --fleet [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np
import torch

from .net import tpu as T
from .nodes import get_program
from .nodes.broadcast import T_BCAST
from .sim import make_run_fn, make_sim
from .tree import resolve_device

WARMUP_ROUNDS = 8


def injection_plan(n_nodes: int, values: int, rounds: int, device) -> T.Msgs:
    """V broadcast values, one every other round, spread across the grid
    by a Fibonacci-hash stride (bench.py's plan)."""
    rr = np.arange(rounds)
    inj_round = (rr % 2 == 0) & (rr // 2 < values)
    value = (rr // 2) % values
    dest = (value.astype(np.int64) * 2654435761) % n_nodes

    def col(x):
        return torch.tensor(np.asarray(x)[:, None], dtype=T.I32,
                            device=device)
    return T.Msgs.empty((rounds, 1), device).replace(
        valid=torch.tensor(inj_round[:, None], device=device),
        src=col(np.full(rounds, n_nodes)), dest=col(dest),
        type=col(np.full(rounds, T_BCAST)), a=col(value))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _setup(n_nodes, values, rounds, gossip, pool, eager, dev):
    """(program, cfg, run_fn, plan) of one protocol mode."""
    nodes = [f"n{i}" for i in range(n_nodes)]
    program = get_program("broadcast",
                          {"topology": "grid", "max_values": values,
                           "gossip_per_neighbor": gossip,
                           "latency": {"mean": 0}, "eager_resend": eager},
                          nodes, device=dev)
    cfg = T.NetConfig(n_nodes=n_nodes, n_clients=1, pool_cap=pool,
                      inbox_cap=program.inbox_cap, client_cap=0)
    return (program, cfg, make_run_fn(program, cfg, device=dev),
            injection_plan(n_nodes, values, rounds, dev))


def _run_mode(n_nodes, values, rounds, gossip, pool, eager, seed, dev):
    """One protocol mode: a short warm-up run, then the timed run on a
    fresh state. Returns the mode's record fields."""
    program, cfg, run_fn, plan = _setup(n_nodes, values, rounds, gossip,
                                        pool, eager, dev)

    warm = plan.at_rows(slice(0, min(WARMUP_ROUNDS, rounds)))
    run_fn(make_sim(program, cfg, seed=0, device=dev), warm)
    _sync(dev)
    sim = make_sim(program, cfg, seed=seed, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    sim, _counts = run_fn(sim, plan)
    _sync(dev)
    wall = time.perf_counter() - t0
    if int(sim.net.round) != rounds:
        raise RuntimeError(f"ran {int(sim.net.round)} of {rounds} rounds")
    st = T.stats_dict(sim.net)
    msgs = st["recv_all"]
    return {"messages_delivered": msgs,
            "converged": bool(sim.nodes["seen"][:, :values].all()),
            "wall_s": wall, "msgs_per_sec": msgs / wall,
            "ms_per_round": 1000.0 * wall / rounds,
            "dropped_overflow": st["dropped_overflow"],
            "overwrites": int(sim.channels.overwrites)}


def run_broadcast_bench(n_nodes: int = 100_000, values: int = 64,
                        rounds: int = 700, gossip: int = 1,
                        pool: int = 8192, eager: bool = True, seed: int = 1,
                        device="cuda") -> dict:
    """bench.py's broadcast record, measured on the port. The headline
    `value` is the efficient protocol's simulated msgs/s."""
    dev = resolve_device(device)
    record = {
        "metric": (f"broadcast_sim_msgs_per_sec_{n_nodes}_nodes"
                   if n_nodes != 100_000
                   else "broadcast_sim_msgs_per_sec_100k_nodes"),
        "unit": "msgs/sec", "nodes": n_nodes, "values": values,
        "rounds": rounds, "gossip_per_neighbor": gossip, "pool": pool,
        "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")}
    if eager:
        res = _run_mode(n_nodes, values, rounds, gossip, pool, True, seed,
                        dev)
        record.update({f"eager_{k}": v for k, v in res.items()})
    res = _run_mode(n_nodes, values, rounds, gossip, pool, False, seed, dev)
    record.update(res)
    record["value"] = res["msgs_per_sec"]
    record["eager_resend"] = False
    return record


def profile_rounds(n_nodes: int = 100_000, values: int = 64,
                   start: int = 100, window: int = 20, gossip: int = 1,
                   pool: int = 8192, eager: bool = False, seed: int = 1,
                   top: int = 12, device="cuda") -> dict:
    """Where a round's time goes on the card: runs the bench plan to round
    `start`, times the next `window` rounds, then traces `window` more
    under `torch.profiler`. Reports the untraced host ms a round, the
    device's busy ms a round (the sum of kernel times in the trace; one
    stream, so they do not overlap), its idle share, and the `top`
    device functions by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profile_rounds measures the card")
    program, cfg, run_fn, plan = _setup(n_nodes, values,
                                        start + 2 * window, gossip, pool,
                                        eager, dev)
    sim, _ = run_fn(make_sim(program, cfg, seed=seed, device=dev),
                    plan.at_rows(slice(0, start)))
    _sync(dev)
    t0 = time.perf_counter()
    sim, _ = run_fn(sim, plan.at_rows(slice(start, start + window)))
    _sync(dev)
    wall_ms = 1e3 * (time.perf_counter() - t0) / window
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim, _ = run_fn(sim, plan.at_rows(slice(start + window,
                                                start + 2 * window)))
        _sync(dev)

    # the device's own events (kernels, copies, fills), not the host
    # ops that launched them, which carry the same time again
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3 / window
    return {"nodes": n_nodes, "values": values, "eager_resend": eager,
            "rounds": [start, start + 2 * window],
            "wall_ms_per_round": wall_ms,
            "device_busy_ms_per_round": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device": torch.cuda.get_device_name(dev),
            "top": [{"name": k, "ms_per_round": us / 1e3 / window,
                     "calls_per_round": n / window}
                    for k, us, n in rows[:top]]}


def _raft_setup(n: int, dev):
    """bench.py bench_raft_clusters' program and config: Raft serving
    lin-kv at latency 0, one client, pool 64, client_cap 4."""
    from .parallel import make_cluster_round_fn
    nodes = [f"n{i}" for i in range(n)]
    program = get_program("lin-kv", {"latency": {"mean": 0}}, nodes,
                          device=dev)
    cfg = T.NetConfig(n_nodes=n, n_clients=1, pool_cap=64,
                      inbox_cap=program.inbox_cap, client_cap=4)
    return program, cfg, make_cluster_round_fn(program, cfg, device=dev)


def run_raft_bench(clusters: int = 10_000, rounds: int = 300,
                   chunk: int = 100, seed: int = 1, n: int = 5,
                   device="cuda", return_state: bool = False):
    """bench.py's raft record, measured on the port: `clusters`
    independent n-node clusters from `make_cluster_sims(seed)`, rounds //
    chunk chunks of `chunk` rounds with no injections, timed on the host
    clock from the first round to the last round's completion (a short
    warm-up run on seed 0 first). A chunk is the unit the host waits on,
    as a scan dispatch is in the JAX bench: its rounds are queued back
    to back, then the host waits for the card and checks the clusters'
    round. Returns the record (and the final state with
    `return_state`)."""
    from .parallel import make_cluster_sims
    dev = resolve_device(device)
    chunk = min(int(chunk), int(rounds))
    done = (rounds // chunk) * chunk
    program, cfg, round_fn = _raft_setup(n, dev)
    inject = T.Msgs.empty((clusters, 1), dev)

    def run(sims, n_chunks, length):
        """n_chunks chunks of `length` rounds, the host waiting for the
        card at each chunk's end."""
        start = int(sims.net.round[0])
        for c in range(1, n_chunks + 1):
            for _ in range(length):
                sims = round_fn(sims, inject)[0]
            at = int(sims.net.round[0])         # waits for the card
            if at != start + c * length:
                raise RuntimeError(f"chunk {c}: the clusters are at round "
                                   f"{at}, not {start + c * length}")
        return sims

    run(make_cluster_sims(program, cfg, clusters, seed=0, device=dev), 1,
        min(WARMUP_ROUNDS, chunk))
    sims = make_cluster_sims(program, cfg, clusters, seed=seed, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    sims = run(sims, rounds // chunk, chunk)
    wall = time.perf_counter() - t0
    roles = sims.nodes["role"]
    one_leader = float(((roles == 2).sum(dim=1) == 1).float().mean())
    record = {
        "metric": (f"raft_cluster_rounds_per_sec_{clusters}_clusters"
                   if clusters != 10_000
                   else "raft_cluster_rounds_per_sec_10k_clusters"),
        "value": done * clusters / wall, "unit": "cluster-rounds/sec",
        "clusters": clusters, "nodes_per_cluster": n, "rounds": done,
        "wall_s": wall, "ms_per_round": 1000.0 * wall / max(done, 1),
        "clusters_with_one_leader": one_leader, "chunk": chunk,
        "seed": seed, "graded": None,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")}
    return (record, sims) if return_state else record


def profile_raft(clusters: int = 10_000, start: int = 100,
                 window: int = 20, seed: int = 1, n: int = 5, top: int = 12,
                 device="cuda") -> dict:
    """Where a raft cluster round's time goes on the card: `start` rounds
    untraced, `window` rounds timed on the host clock, then `window`
    more under `torch.profiler` (device busy ms a round, idle share, the
    `top` device functions)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from .parallel import make_cluster_sims
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profile_raft measures the card")
    program, cfg, round_fn = _raft_setup(n, dev)
    inject = T.Msgs.empty((clusters, 1), dev)
    sims = make_cluster_sims(program, cfg, clusters, seed=seed, device=dev)
    for _ in range(start):
        sims = round_fn(sims, inject)[0]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(window):
        sims = round_fn(sims, inject)[0]
    _sync(dev)
    wall_ms = 1e3 * (time.perf_counter() - t0) / window
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(window):
            sims = round_fn(sims, inject)[0]
        _sync(dev)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3 / window
    return {"clusters": clusters, "nodes_per_cluster": n,
            "rounds": [start, start + 2 * window],
            "wall_ms_per_round": wall_ms,
            "device_busy_ms_per_round": busy_ms,
            "device_calls_per_round": sum(r[2] for r in rows) / window,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device": torch.cuda.get_device_name(dev),
            "top": [{"name": k, "ms_per_round": us / 1e3 / window,
                     "calls_per_round": c / window}
                    for k, us, c in rows[:top]]}


def _batched_measure(kind, n_nodes, values, batch, chunk, max_rounds,
                     pool, dev):
    """One protocol of the batched-vs-eager record: the batched node
    (`batch` values a T_BATCH injection) or the eager-resend gossip node
    (one T_BCAST a value), both eager, one gossip lane an edge, one
    injection a round from round 0 at Fibonacci-hash spread nodes, run
    in chunks of `chunk` rounds to convergence (every node has seen every
    value, read once a chunk) or `max_rounds`. A full run on seed 0,
    then the timed run on seed 1."""
    from .checkers.set_full import range_checksum
    from .nodes.broadcast_batched import T_BATCH
    V, B, N = values, batch, n_nodes
    nodes = [f"n{i}" for i in range(N)]
    opts = {"topology": "grid", "max_values": V, "gossip_per_neighbor": 1,
            "latency": {"mean": 0}, "eager_resend": True}
    if kind == "batched":
        prog = get_program("broadcast-batched", {**opts, "batch_max": B},
                           nodes, device=dev)
        n_inj = (V + B - 1) // B
        a_col = np.arange(n_inj, dtype=np.int64) * B
        b_col = np.minimum(B, V - a_col)
        c_col = np.array([range_checksum(int(lo), int(n))
                          for lo, n in zip(a_col, b_col)], dtype=np.int64)
        t_code = T_BATCH
    else:
        prog = get_program("broadcast", opts, nodes, device=dev)
        n_inj = V
        a_col = np.arange(V, dtype=np.int64)
        b_col = c_col = np.zeros(V, dtype=np.int64)
        t_code = T_BCAST
    cfg = T.NetConfig(n_nodes=N, n_clients=1, pool_cap=pool,
                      inbox_cap=prog.inbox_cap, client_cap=0,
                      unit_words=tuple(getattr(prog, "unit_words", ())
                                       or ()))
    run_fn = make_run_fn(prog, cfg, device=dev)
    rr = np.arange(max_rounds)
    j = np.minimum(rr, n_inj - 1)

    def col(x):
        return torch.tensor(np.asarray(x, dtype=np.int64).astype(
            np.int32)[:, None], device=dev)
    plan = T.Msgs.empty((max_rounds, 1), dev).replace(
        valid=torch.tensor((rr < n_inj)[:, None], device=dev),
        src=col(np.full(max_rounds, N)),
        dest=col((a_col[j] * 2654435761) % N),
        type=col(np.full(max_rounds, t_code)), a=col(a_col[j]),
        b=col(b_col[j]), c=col(c_col[j]))

    def run(seed):
        sim = make_sim(prog, cfg, seed=seed, device=dev)
        rounds = 0
        for i in range(max_rounds // chunk):
            sim, _ = run_fn(sim, plan.at_rows(slice(i * chunk,
                                                    (i + 1) * chunk)))
            rounds += chunk
            # the convergence probe: one scalar read a chunk, the same
            # for both protocols inside the timed window
            if bool(sim.nodes["seen"][:, :V].all()):
                break
        return sim, rounds

    run(seed=0)
    _sync(dev)
    t0 = time.perf_counter()
    sim, rounds = run(seed=1)
    _sync(dev)
    dt = time.perf_counter() - t0
    st = T.stats_dict(sim.net)
    units = st["recv_units"] if cfg.unit_words else st["recv_all"]
    return {
        "protocol": kind,
        "rounds_to_convergence": rounds,
        "wall_s": dt,
        "converged": bool(sim.nodes["seen"][:, :V].all()),
        "client_ops": V,
        "client_ops_per_sec": V / dt,
        "messages_delivered": int(st["recv_all"]),
        "msgs_per_sec": st["recv_all"] / dt,
        "units_delivered": int(units),
        "units_per_msg": round(units / max(st["recv_all"], 1), 3),
        "dropped_overflow": st["dropped_overflow"],
        "ms_per_round": 1e3 * dt / max(rounds, 1),
    }


def run_broadcast_batched_bench(n_nodes: int = 4096, values: int = 512,
                                batch: int = 32, chunk: int = 64,
                                max_rounds: int = None, pool: int = 4096,
                                device="cuda") -> dict:
    """bench.py's `bench_broadcast_batched_record`, measured on the port:
    the batched node against the eager-resend node at equal node count,
    each timed to its own convergence. `speedup_client_ops` is the
    batched side's delivered client ops a second over the eager side's;
    a side that does not converge (or overflows the pool) makes the
    record invalid. The JAX record's `predicted` cost-model block is not
    ported (null)."""
    dev = resolve_device(device)
    max_rounds = int(max_rounds or 16 * values)
    max_rounds = max(chunk, (max_rounds // chunk) * chunk)
    rows = [_batched_measure(kind, n_nodes, values, batch, chunk,
                             max_rounds, pool, dev)
            for kind in ("eager", "batched")]
    eager, batched = rows
    for r in rows:
        r["predicted"] = None
    return {
        "metric": "broadcast_batched_client_ops_per_sec",
        "value": batched["client_ops_per_sec"],
        "unit": "client-ops/sec",
        "vs_baseline": batched["client_ops_per_sec"]
        / max(eager["client_ops_per_sec"], 1e-9),
        "protocols": rows,
        "nodes": n_nodes, "values": values, "batch": batch,
        "chunk": chunk, "max_rounds": max_rounds,
        "speedup_client_ops": batched["client_ops_per_sec"]
        / max(eager["client_ops_per_sec"], 1e-9),
        "msg_reduction": round(eager["messages_delivered"]
                               / max(batched["messages_delivered"], 1), 2),
        "donated_carry": False,
        "host_cpus": os.cpu_count(),
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "valid": all(r["converged"] and not r["dropped_overflow"]
                     for r in rows),
    }


# --- the checker-throughput record ------------------------------------------

def elle_synthetic(elle_ops):
    """The checker bench's synthetic list-append transaction set:
    per-key serial version chains plus random prefix reads, ~elle_ops
    micro-ops total (bench.py's, txn for txn). Key count scales down with
    tiny elle_ops so the version-construction floor (2 appends per key)
    never eats the whole budget. Reads of one key and length share one
    list object, a prefix of the key's values (the checkers only read
    them): bench.py's fresh list a read holds some 1.25 billion elements
    at 1,000,000 micro-ops, tens of GB and minutes of host time. The
    garbage collector is paused while it builds: its passes over the
    set's some 3 million containers took three quarters of the build.
    Returns (txns, longest, appender, micro_ops)."""
    was = gc.isenabled()
    gc.disable()
    try:
        return _synthetic_txns(elle_ops)
    finally:
        if was:
            gc.enable()


def _synthetic_txns(elle_ops):
    ekeys = min(64, max(1, elle_ops // 10))
    versions_per_key = max(2, elle_ops // (5 * ekeys))
    rng = np.random.RandomState(7)
    txns, longest, appender = [], {}, {}
    micro_ops = 0
    for ki in range(ekeys):
        kk = repr(ki)
        order = []
        for vi in range(versions_per_key):
            vv = repr(ki * versions_per_key + vi)
            tid = len(txns)
            txns.append({"id": tid, "ok": True, "inv": micro_ops,
                         "ret": micro_ops + 1,
                         "micro": [["append", ki,
                                    ki * versions_per_key + vi]]})
            appender[(kk, vv)] = tid
            order.append(vv)
            micro_ops += 1
        longest[kk] = order
    # reads fill whatever the version floor left of the budget
    n_reads = max(0, elle_ops - micro_ops)
    read_keys = rng.randint(0, ekeys, n_reads)
    read_lens = rng.randint(0, versions_per_key + 1, n_reads)
    full = [list(range(ki * versions_per_key, (ki + 1) * versions_per_key))
            for ki in range(ekeys)]
    seen: dict = {}
    for ki, ln in zip(read_keys.tolist(), read_lens.tolist()):
        tid = len(txns)
        v = seen.get((ki, ln))
        if v is None:
            v = seen[ki, ln] = full[ki][:ln]
        txns.append({"id": tid, "ok": True, "inv": micro_ops,
                     "ret": micro_ops + 1, "micro": [["r", ki, v]]})
        micro_ops += 1
    return txns, longest, appender, micro_ops


# valid concurrent histories the screen's decided fraction is taken over
SCREEN_FIXTURES = 12


def bench_elle_device_record(txns, longest, appender, micro_ops, py_s, ev,
                             device="cuda") -> dict:
    """The device edge build (K16) and cycle screen (K17) against the
    pure-Python baseline time `py_s` (bench.py's record):

      - flatten_s: the one-shot host columnarization of the read table;
      - table_s: the per-key version-table merge + gather positions and
        the padded device arguments (host numpy), no realtime inputs
        (the synthetic's stale prefix reads make it realtime-cyclic by
        design: only the data stage is meaningful);
      - build_s: their upload and the edge construction, after a warm-up
        call, timed to the device's end;
      - screen_s: the upload and the data-stage cycle screen, its verdict
        read back.

    `speedup` = python_s / build_s; `speedup_total` = python_s /
    (flatten + table + build). The edge set is held equal to the
    vectorized build (`match`); SCREEN_FIXTURES valid concurrent
    histories run the whole checker with the device path on, and the
    screen must certify at least 90% of them (data and realtime)."""
    from .checkers import elle_device as ed
    from .checkers.elle import _fail_appends, _txn_ops, analyze_txns
    from .testing.histories import random_append_history
    dev = resolve_device(device)

    t0 = time.perf_counter()
    cols = ed.build_columns(txns)
    flatten_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eargs, sargs, tp, have_rt = ed.device_args(*ed.host_arrays(
        txns, longest, appender, repr, columns=cols))
    table_s = time.perf_counter() - t0

    def build():
        on = ed.to_device(eargs, dev)
        out = ed.elle_edges(*(on[id(a)] for a in eargs))
        _sync(dev)
        return out

    def screen():
        on = ed.to_device(sargs, dev)
        return ed.elle_screen(*(on[id(a)] for a in sargs), n_txns_pad=tp,
                              do_rt=have_rt).cpu()

    build()         # warm-up: the library's load, the allocator
    t0 = time.perf_counter()
    earrs = build()
    build_s = time.perf_counter() - t0
    screen()
    t0 = time.perf_counter()
    data_ok, _full, it_a, _it_b = screen().tolist()
    screen_s = time.perf_counter() - t0

    es = ed.DeviceElle(earrs, data_ok, False, (it_a, 0), {}).edge_set()
    total_s = flatten_s + table_s + build_s
    rec = {
        "flatten_s": round(flatten_s, 4),
        "table_s": round(table_s, 4),
        "build_s": round(build_s, 4),
        "screen_s": round(screen_s, 4),
        "total_s": round(total_s, 4),
        "build_ops_per_s": round(micro_ops / max(build_s, 1e-9), 1),
        "match": es == ev,
        "speedup": round(py_s / max(build_s, 1e-9), 2),
        "speedup_total": round(py_s / max(total_s, 1e-9), 2),
        "screen_data_decided": bool(data_ok),
        "screen_iters": int(it_a),
    }
    decided = 0
    for seed in range(SCREEN_FIXTURES):
        h = random_append_history(seed, n_txn=150)
        rep: dict = {}
        analyze_txns(_txn_ops(h), _fail_appends(h), device="on",
                     report=rep, torch_device=dev)
        if rep.get("screen", {}).get("realtime") == "acyclic":
            decided += 1
    rec["screen_fixtures"] = {
        "histories": SCREEN_FIXTURES, "decided": decided,
        "decided_fraction": round(decided / SCREEN_FIXTURES, 3),
    }
    return rec


def bench_checkers_record(n_rows: int = 1_000_000, elle_ops: int = 1_000_000,
                          device="cuda", synthetic=None) -> dict:
    """bench.py's checker-throughput record: the analysis hot paths on
    synthetic histories, each against its pure-Python baseline.

      - register: an n_rows-row lin-kv history over 128 keys (one
        worker, every 4th op a write) through LinearizableRegisterChecker:
        the columnar
        partition + vectorized screen against the sequential WGL path
        (opts no_fast);
      - elle: ww/wr/rw edge construction on an elle_ops-micro-op
        list-append set, the sorted-index-array build against the
        nested-loop build;
      - elle.device: the same edge set built by K16 and screened by K17
        (`bench_elle_device_record`).

    Every half holds its verdicts or edge sets equal; a mismatch marks
    the record invalid. `synthetic`, where given, is
    `elle_synthetic(elle_ops)` built by the caller (read, not changed)."""
    from .checkers.elle import _edges_python, _edges_vectorized
    from .checkers.linearizable import LinearizableRegisterChecker
    from .history import History

    n_rows -= n_rows % 2
    n_ops = n_rows // 2
    keys = 128
    h = History()
    state = [None] * keys
    for i in range(n_ops):
        k = i % keys
        if i % 4 == 0:
            f, v = "write", i % 7
            state[k] = v
        else:
            f, v = "read", state[k]
        h.append_row("invoke", f, [k, v], 0, 2 * i)
        h.append_row("ok", f, [k, v], 0, 2 * i + 1)

    c = LinearizableRegisterChecker()
    t0 = time.perf_counter()
    fast = c.check({}, h)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = c.check({}, h, {"no_fast": True})
    base_s = time.perf_counter() - t0
    register = {
        "history_rows": n_rows, "ops": n_ops, "keys": keys,
        "valid": fast["valid"], "verdicts_match": fast == base,
        "fast_s": round(fast_s, 4),
        "fast_ops_per_s": round(n_ops / fast_s, 1),
        "baseline_s": round(base_s, 4),
        "baseline_ops_per_s": round(n_ops / base_s, 1),
        "speedup": round(base_s / fast_s, 2),
    }

    txns, longest, appender, micro_ops = (
        synthetic if synthetic is not None else elle_synthetic(elle_ops))
    t0 = time.perf_counter()
    ev = _edges_vectorized(txns, longest, appender)
    vec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ep = _edges_python(txns, longest, appender)
    py_s = time.perf_counter() - t0
    elle = {
        "micro_ops": micro_ops, "keys": len(longest),
        "edges": len(ev), "match": ev == ep,
        "vectorized_s": round(vec_s, 4),
        "vectorized_ops_per_s": round(micro_ops / vec_s, 1),
        "python_s": round(py_s, 4),
        "python_ops_per_s": round(micro_ops / py_s, 1),
        "speedup": round(py_s / vec_s, 2),
    }
    d = elle["device"] = bench_elle_device_record(
        txns, longest, appender, micro_ops, py_s, ev, device=device)
    dev_ok = d["match"] and d["screen_fixtures"]["decided_fraction"] >= 0.9
    return {"register": register, "elle": elle,
            "valid": bool(register["verdicts_match"] and elle["match"]
                          and register["valid"] is True and dev_ok)}


# --- the compartment's proxy-scaling record ---------------------------------

def bench_compartment_record(proxies=None, device="cuda") -> dict:
    """bench.py's `bench_compartment_record` on the port: lin-kv client
    ops a virtual second against the proxy count at fixed leader and
    acceptor capacity, driven end to end through `core.run` on `--node
    tpu:compartment` (kernels K23-K26). Offered load stays well above
    the one-proxy tier's capacity, so the ok ops are the tier's
    saturation capacity: excess commands shed definitely (error 11) and
    every point must grade valid. `ops_per_vsec` is virtual throughput
    (ok ops a simulated second); the wall numbers ride along. Each
    point's `predicted` is null: the JAX record's cost-model block is
    not ported (the port has no cost model)."""
    import shutil
    import tempfile

    from . import core

    dev = resolve_device(device)
    if proxies is None:
        proxies = [int(x) for x in os.environ.get(
            "BENCH_COMPARTMENT_PROXIES", "1,2,4,8").split(",")
            if x.strip()]
    rate = float(os.environ.get("BENCH_COMPARTMENT_RATE", 8000.0))
    tl = float(os.environ.get("BENCH_COMPARTMENT_TIME_LIMIT", 2.0))
    conc = int(os.environ.get("BENCH_COMPARTMENT_CONC", 96))
    rows = []
    root = tempfile.mkdtemp(prefix="bench-compartment-")
    try:
        for p in proxies:
            t0 = time.perf_counter()
            res = core.run(dict(
                store_root=root, seed=11, workload="lin-kv",
                node="tpu:compartment",
                roles=f"proxies={p},acceptors=2x2,replicas=2",
                concurrency=conc, rate=rate, time_limit=tl,
                journal_rows=False, device=str(dev),
                # fixed leader/acceptor capacity across the sweep: only
                # the proxy tier scales
                leader_slots=128, proxy_slots=8, compartment_inbox=16,
                kv_keys=1024, timeout_ms=20000))
            dt = time.perf_counter() - t0
            ok = res["stats"]["ok-count"]
            rows.append({
                "proxies": p,
                "ok_ops": ok,
                "ops_per_vsec": round(ok / tl, 1),
                "wall_s": round(dt, 3),
                "ops_per_wall_sec": round(ok / dt, 1),
                "predicted": None,
                # definite fails: leader backpressure sheds (error 11)
                # and ordinary lin-kv cas-mismatch/absent-key errors
                "failed_ops": res["stats"]["fail-count"],
                "valid": res["valid"] is True,
            })
    finally:
        shutil.rmtree(root, ignore_errors=True)
    by_p = {r["proxies"]: r for r in rows}
    scaling = None
    if 1 in by_p and 4 in by_p and by_p[1]["ops_per_vsec"]:
        scaling = round(by_p[4]["ops_per_vsec"]
                        / by_p[1]["ops_per_vsec"], 2)
    return {
        "proxies": rows,
        "scaling_1_to_4": scaling,
        "offered_rate": rate, "time_limit_s": tl, "concurrency": conc,
        "host_cpus": os.cpu_count(),
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "valid": all(r["valid"] for r in rows),
    }


def main_compartment(device="cuda") -> tuple:
    """bench.py's `_main_compartment`: the proxy-scaling record with its
    headline (client ops a virtual second at the largest proxy count).
    Returns (record, exit code): 1 when a point graded invalid or the
    1 -> 4 scaling fell under 2 (gated only when both points ran)."""
    rec = bench_compartment_record(device=device)
    top = max(rec["proxies"], key=lambda r: r["proxies"])
    record = {"metric": "compartment_client_ops_per_vsec",
              "value": top["ops_per_vsec"], "unit": "client-ops/vsec",
              "vs_baseline": None, **rec}
    bad_scaling = (rec["scaling_1_to_4"] is not None
                   and rec["scaling_1_to_4"] < 2.0)
    return record, (1 if not rec["valid"] or bad_scaling else 0)


def bench_failover_record(device="cuda") -> dict:
    """bench.py's `bench_failover_record` on the port: the elected
    compartment under forced sequencer kills, its history segmented by
    the kill windows (see the module docstring). `devices` counts CUDA
    devices."""
    import shutil
    import tempfile

    from . import core

    dev = resolve_device(device)
    rate = float(os.environ.get("BENCH_FAILOVER_RATE", 200.0))
    tl = float(os.environ.get("BENCH_FAILOVER_TIME_LIMIT", 6.0))
    interval = float(os.environ.get("BENCH_FAILOVER_INTERVAL", 0.7))
    root = tempfile.mkdtemp(prefix="bench-failover-")
    try:
        t0 = time.perf_counter()
        res = core.run(dict(
            store_root=root, seed=11, workload="lin-kv",
            node="tpu:compartment",
            roles="sequencers=3,proxies=4,acceptors=2x2,replicas=2",
            concurrency=48, rate=rate, time_limit=tl,
            journal_rows=False, device=str(dev),
            leader_slots=128, proxy_slots=8, compartment_inbox=16,
            kv_keys=1024, timeout_ms=400,
            nemesis={"kill"}, nemesis_interval=interval,
            nemesis_targets="kill=sequencer", recovery_s=2))
        wall = time.perf_counter() - t0
        ns_pr = 1e6                  # 1 ms a round
        # segment ok completions by the kill windows
        kills, heals, oks = [], [], []
        with open(os.path.join(root, "latest", "history.jsonl")) as f:
            for ln in f:
                o = json.loads(ln)
                if o.get("process") == "nemesis" \
                        and o.get("type") == "invoke":
                    if o.get("f") == "start-kill":
                        kills.append(o["time"] / ns_pr)
                    elif o.get("f") == "stop-kill":
                        heals.append(o["time"] / ns_pr)
                elif o.get("type") == "ok":
                    oks.append(o["time"] / ns_pr)
        end_r = tl * 1000.0
        first_kill = min(kills) if kills else float("inf")

        def window_close(k):
            # the heal closing this kill window, else the run's end
            return min((h for h in heals if h >= k), default=end_r)

        last_heal = max((window_close(k) for k in kills), default=0.0)
        in_window = sum(1 for t in oks
                        for k in kills if k <= t <= window_close(k))
        windows_r = sum(window_close(k) - k for k in kills)
        before = sum(1 for t in oks if t < first_kill)
        after = sum(1 for t in oks if t > last_heal)
        seg = {
            "before": round(before / max(first_kill / 1000.0, 1e-9), 1),
            "during": round(in_window / max(windows_r / 1000.0, 1e-9), 1),
            "after": round(after / max((end_r - last_heal) / 1000.0,
                                       1e-9), 1),
        }
        avail = res.get("availability", {})
        elect = avail.get("election", {})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "failovers": elect.get("failovers", 0),
        "forced_kills": len(kills),
        "rounds_to_leader": elect.get("rounds-to-leader"),
        "client_ops_per_vsec": seg,
        "longest_ok_gap_rounds": avail.get("longest-ok-gap-rounds"),
        "dip_count": avail.get("dip-count"),
        "dip_threshold_rounds": avail.get("dip-threshold-rounds"),
        # the client-side leader lease: on at twice the election timeout
        "leader_lease_rounds":
            2 * core.DEFAULTS["election_timeout_rounds"],
        "offered_rate": rate, "time_limit_s": tl,
        "nemesis_interval_s": interval,
        "wall_s": round(wall, 3),
        "host_cpus": os.cpu_count(),
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "valid": res["valid"] is True,
    }


def main_failover(device="cuda") -> tuple:
    """bench.py's `_main_failover`: the failover record with its headline
    (the most rounds from candidacy to a won election). Returns (record,
    exit code): 1 unless the run graded valid with two failovers or
    more."""
    rec = bench_failover_record(device=device)
    rtl = rec.get("rounds_to_leader") or {}
    record = {"metric": "failover_rounds_to_new_leader_max",
              "value": rtl.get("max"), "unit": "rounds",
              "vs_baseline": None, **rec}
    return record, (1 if not rec["valid"] or rec["failovers"] < 2 else 0)


def bench_byzantine_record(device="cuda") -> dict:
    """bench.py's `bench_byzantine_record` on the port: the same
    compartment cluster (2 candidates, 2 proxies, a 1x2 grid, 1 replica,
    retry 3, 1,024 keys; 16 clients at the rate for the time limit, seed
    3) runs once benign and once under the equivocating sequencer
    (`--nemesis byzantine`, `byzantine=sequencers`, equivocation, a
    window every interval), through `core.run` (kernels K26-K30). The
    record reports the conviction latency (rounds from the first
    start-byzantine invoke to the proxies' first conviction stamp), the
    injected and convicted ledger of the `byzantine` block, and the ok
    ops a virtual second benign and under attack. BENCH_BYZ_RATE,
    _TIME_LIMIT and _INTERVAL override the run, as bench.py's do."""
    import shutil
    import tempfile

    from . import core

    dev = resolve_device(device)
    rate = float(os.environ.get("BENCH_BYZ_RATE", 200.0))
    tl = float(os.environ.get("BENCH_BYZ_TIME_LIMIT", 6.0))
    interval = float(os.environ.get("BENCH_BYZ_INTERVAL", 1.5))
    base = dict(
        seed=3, workload="lin-kv", node="tpu:compartment",
        roles="sequencers=2,proxies=2,acceptors=1x2,replicas=1",
        concurrency=16, rate=rate, time_limit=tl, journal_rows=False,
        compartment_retry=3, kv_keys=1024, device=str(dev))
    root = tempfile.mkdtemp(prefix="bench-byzantine-")
    try:
        t0 = time.perf_counter()
        res_b = core.run(dict(base, store_root=root))
        wall_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_a = core.run(dict(
            base, store_root=root, nemesis={"byzantine"},
            nemesis_interval=interval,
            nemesis_targets="byzantine=sequencers",
            byz_attacks="equivocation"))
        wall_a = time.perf_counter() - t0
        ns_pr = 1e6                  # 1 ms a round
        starts = []
        with open(os.path.join(root, "latest", "history.jsonl")) as f:
            for ln in f:
                o = json.loads(ln)
                if o.get("process") == "nemesis" \
                        and o.get("type") == "invoke" \
                        and o.get("f") == "start-byzantine":
                    starts.append(o["time"] / ns_pr)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    blk = res_a.get("byzantine") or {}
    convs = blk.get("convictions") or []
    conv_rounds = [c["evidence"]["round"] for c in convs
                   if c.get("evidence", {}).get("round", -1) >= 0]
    latency = (round(min(conv_rounds) - min(starts), 1)
               if conv_rounds and starts else None)
    ok_b = res_b["stats"]["ok-count"]
    ok_a = res_a["stats"]["ok-count"]
    return {
        "attack": "equivocation",
        "attack_windows": len(starts),
        "conviction_latency_rounds": latency,
        "injected": blk.get("injected"),
        "convictions": [
            {"rule": c["rule"], "culprit": c["culprit"],
             "count": c["evidence"].get("count"),
             "witness": c.get("witness")} for c in convs],
        "byzantine_valid": blk.get("valid") is True,
        "client_ops_per_vsec": {"benign": round(ok_b / tl, 1),
                                "under_attack": round(ok_a / tl, 1)},
        "benign_valid": res_b["valid"] is True,
        "benign_convictions": len(
            (res_b.get("byzantine") or {}).get("convictions") or ()),
        "offered_rate": rate, "time_limit_s": tl,
        "nemesis_interval_s": interval,
        "wall_s": {"benign": round(wall_b, 3),
                   "under_attack": round(wall_a, 3)},
        "host_cpus": os.cpu_count(),
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "valid": blk.get("valid") is True and res_b["valid"] is True
        and "byzantine" not in res_b,
    }


def main_byzantine(device="cuda") -> tuple:
    """bench.py's `_main_byzantine`: the conviction record with its
    headline (rounds from injection to the first device conviction).
    Returns (record, exit code): 1 when the byzantine block graded
    invalid or the benign twin was not clean."""
    rec = bench_byzantine_record(device=device)
    record = {"metric": "byzantine_conviction_latency_rounds",
              "value": rec["conviction_latency_rounds"], "unit": "rounds",
              "vs_baseline": None, **rec}
    return record, (0 if rec["valid"] else 1)


FLEET_SIZES = (1, 8, 64, 512, 10_000)


def bench_fleet_record(sizes=None, device="cuda") -> dict:
    """The fleet record (see the module docstring): one row a fleet size
    with `clusters_per_sec`, `agg_msgs_per_sec`, `messages_delivered`,
    `converged`, `dropped_overflow` and `host_ms_per_dispatch`, the keys
    of the JAX package's record beside the port's own."""
    from .parallel import make_fleet_sims
    from .sim import make_fleet_scan_fn
    dev = resolve_device(device)
    if sizes is None:
        sizes = [int(x) for x in os.environ.get(
            "BENCH_FLEET_SIZES", ",".join(map(str, FLEET_SIZES))).split(",")
            if x.strip()]
    n = int(os.environ.get("BENCH_FLEET_NODES", 5))
    V = int(os.environ.get("BENCH_FLEET_VALUES", 8))     # dispatches
    chunk = int(os.environ.get("BENCH_FLEET_CHUNK", 64))  # rounds each
    pool_cap = int(os.environ.get("BENCH_FLEET_POOL", 64))
    nodes = [f"n{i}" for i in range(n)]
    program = get_program("broadcast",
                          {"topology": "grid", "max_values": V,
                           "latency": {"mean": 0}, "eager_resend": True},
                          nodes, device=dev)
    cfg = T.NetConfig(n_nodes=n, n_clients=1, pool_cap=pool_cap,
                      inbox_cap=program.inbox_cap, client_cap=0)
    R = V * chunk
    rows = []
    for F in sizes:
        fleet_fn = make_fleet_scan_fn(program, cfg, device=dev)
        kmax = np.full(F, chunk, np.int32)
        hold = np.zeros(F, bool)             # never stop on a reply
        active = np.ones(F, bool)
        injects = []
        for d in range(V):
            # one fresh value a cluster a dispatch, dest spread per
            # (cluster, value) by the Fibonacci-hash stride
            dest = (np.arange(F, dtype=np.int64) * V + d) \
                * 2654435761 % n
            inj = T.Msgs.empty((F, 1), dev)
            injects.append(inj.replace(
                valid=torch.ones((F, 1), dtype=torch.bool, device=dev),
                src=torch.full((F, 1), n, dtype=T.I32, device=dev),
                dest=torch.from_numpy(dest.astype(np.int32)[:, None]).to(
                    dev),
                type=torch.full((F, 1), T_BCAST, dtype=T.I32, device=dev),
                a=torch.full((F, 1), d, dtype=T.I32, device=dev)))

        def run(seed0, F=F, fleet_fn=fleet_fn, kmax=kmax, hold=hold,
                active=active, injects=injects):
            sim = make_fleet_sims(program, cfg, list(range(seed0,
                                                           seed0 + F)),
                                  device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            for inj in injects:
                sim, _cm, _k, _log = fleet_fn(sim, inj, kmax, hold, active)
            host = time.perf_counter() - t0
            if int(sim.net.round[0]) != R:
                raise RuntimeError(f"fleet {F}: ran {int(sim.net.round[0])} "
                                   f"rounds, not {R}")
            return sim, host
        run(0)                                # warm-up
        t0 = time.perf_counter()
        sim, host = run(F)
        _sync(dev)
        dt = time.perf_counter() - t0
        st = T.stats_dict(sim.net)            # sums over the fleet
        seen = sim.nodes["seen"][:, :, :V]
        rows.append({
            "fleet": F, "wall_s": round(dt, 3),
            "rounds_per_cluster": R,
            "messages_delivered": int(st["recv_all"]),
            "agg_msgs_per_sec": round(st["recv_all"] / dt, 1),
            "clusters_per_sec": round(F / dt, 3),
            "converged": bool(seen.all()),
            "dropped_overflow": st["dropped_overflow"],
            "host_ms_per_dispatch": round(1e3 * host / V, 3),
            "host_syncs": fleet_fn.host_syncs,
            "hold_row_bytes": fleet_fn.row_bytes,
        })
        del sim
        gc.collect()
    base = next((r for r in rows if r["fleet"] == 1), rows[0])
    for r in rows:
        r["agg_speedup_vs_fleet1"] = round(
            r["agg_msgs_per_sec"] / base["agg_msgs_per_sec"], 2)
    return {"metric": "fleet_clusters_per_sec", "sizes": rows,
            "nodes_per_cluster": n, "values": V, "rounds_per_cluster": R,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "valid": all(r["converged"] and not r["dropped_overflow"]
                         for r in rows)}


def profile_fleet(F: int, top: int = 12, device="cuda") -> dict:
    """Where a fleet dispatch's time goes on the card: the fleet bench's
    grid at F clusters, one dispatch of 64 rounds warm, one timed on the
    host clock, one under `torch.profiler` (device busy ms a dispatch,
    idle share, the `top` device functions)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .parallel import make_fleet_sims
    from .sim import make_fleet_scan_fn
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profile_fleet measures the card")
    n, chunk = 5, 64
    program = get_program("broadcast",
                          {"topology": "grid", "max_values": 8,
                           "latency": {"mean": 0}, "eager_resend": True},
                          [f"n{i}" for i in range(n)], device=dev)
    cfg = T.NetConfig(n_nodes=n, n_clients=1, pool_cap=64,
                      inbox_cap=program.inbox_cap, client_cap=0)
    fleet_fn = make_fleet_scan_fn(program, cfg, device=dev)
    sim = make_fleet_sims(program, cfg, list(range(F)), device=dev)
    inj = T.Msgs.empty((F, 1), dev)
    args = (np.full(F, chunk, np.int32), np.zeros(F, bool),
            np.ones(F, bool))
    sim = fleet_fn(sim, inj, *args)[0]
    _sync(dev)
    t0 = time.perf_counter()
    sim = fleet_fn(sim, inj, *args)[0]
    _sync(dev)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim = fleet_fn(sim, inj, *args)[0]
        _sync(dev)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    return {"clusters": F, "nodes_per_cluster": n,
            "rounds_per_dispatch": chunk,
            "wall_ms_per_dispatch": wall_ms,
            "host_ms_per_round": wall_ms / chunk,
            "device_busy_ms_per_dispatch": busy_ms,
            "device_calls_per_dispatch": sum(r[2] for r in rows),
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device": torch.cuda.get_device_name(dev),
            "top": [{"name": k, "ms_per_dispatch": us / 1e3,
                     "calls_per_dispatch": c}
                    for k, us, c in rows[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=None,
                    help="broadcast 100,000, batched 4,096")
    ap.add_argument("--values", type=int, default=None,
                    help="broadcast 64, batched 512")
    ap.add_argument("--gossip", type=int, default=1)
    ap.add_argument("--pool", type=int, default=None,
                    help="broadcast 8192, batched 4096")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--no-eager", action="store_true",
                    help="run only the efficient protocol")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace a window of rounds in each mode instead")
    ap.add_argument("--raft", action="store_true",
                    help="the Raft clusters bench (bench.py "
                         "bench_raft_clusters) instead of broadcast")
    ap.add_argument("--clusters", type=int, default=10_000)
    ap.add_argument("--chunk", type=int, default=None,
                    help="raft (100): rounds the host queues before it "
                         "waits for the card (the JAX bench's scan "
                         "length), rounds rounded down to a multiple of "
                         "it; batched (64): rounds between convergence "
                         "reads")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds (broadcast 700, raft 300; batched: the "
                         "horizon, default 16 x values)")
    ap.add_argument("--broadcast-batched", action="store_true",
                    help="the batched-vs-eager record (bench.py "
                         "bench_broadcast_batched_record): --nodes "
                         "default 4096, --values 512, --batch 32, "
                         "--chunk 64, --pool 4096")
    ap.add_argument("--batch", type=int, default=32,
                    help="batched: values a client batch")
    ap.add_argument("--checkers", action="store_true",
                    help="the checker-throughput record (bench.py "
                         "bench_checkers_record), its Elle device block "
                         "through K16 and K17")
    ap.add_argument("--compartment", action="store_true",
                    help="the proxy-scaling record (bench.py "
                         "bench_compartment_record) on tpu:compartment, "
                         "through K23-K26")
    ap.add_argument("--failover", action="store_true",
                    help="the leader-failover record (bench.py "
                         "bench_failover_record) on the elected "
                         "tpu:compartment, through K26-K29")
    ap.add_argument("--byzantine", action="store_true",
                    help="the conviction record (bench.py "
                         "bench_byzantine_record) on the elected "
                         "tpu:compartment under the equivocating "
                         "sequencer, through K26-K30")
    ap.add_argument("--fleet", action="store_true",
                    help="the fleet record (bench.py bench_fleet_record): "
                         "5-node broadcast clusters in fleets of 1 to "
                         "10,000, through the fleet scan (K32, K5)")
    a = ap.parse_args(argv)
    if a.fleet:
        rec = bench_fleet_record(device=a.device)
        print(json.dumps(rec))
        return 0 if rec["valid"] else 1
    if a.byzantine:
        rec, rc = main_byzantine(device=a.device)
        print(json.dumps(rec))
        return rc
    if a.failover:
        rec, rc = main_failover(device=a.device)
        print(json.dumps(rec))
        return rc
    if a.compartment:
        rec, rc = main_compartment(device=a.device)
        print(json.dumps(rec))
        return rc
    if a.checkers:
        rec = bench_checkers_record(device=a.device)
        print(json.dumps(rec))
        return 0 if rec["valid"] else 1
    if a.broadcast_batched:
        rec = run_broadcast_batched_bench(
            a.nodes or 4096, a.values or 512, a.batch, a.chunk or 64,
            a.rounds, a.pool or 4096, device=a.device)
        print(json.dumps(rec))
        return 0 if rec["valid"] else 1
    if a.raft:
        if a.profile:
            print(json.dumps(profile_raft(a.clusters, seed=a.seed,
                                          device=a.device)))
            return 0
        rec = run_raft_bench(a.clusters, a.rounds or 300, a.chunk or 100,
                             a.seed, device=a.device)
        print(json.dumps(rec))
        return 0 if rec["clusters_with_one_leader"] == 1.0 else 1
    a.rounds = a.rounds or 700
    a.nodes, a.values = a.nodes or 100_000, a.values or 64
    a.pool = a.pool or 8192
    if a.profile:
        for eager in ([False] if a.no_eager else [True, False]):
            print(json.dumps(profile_rounds(
                a.nodes, a.values, gossip=a.gossip, pool=a.pool,
                eager=eager, seed=a.seed, device=a.device)))
        return 0
    rec = run_broadcast_bench(a.nodes, a.values, a.rounds, a.gossip, a.pool,
                              eager=not a.no_eager, seed=a.seed,
                              device=a.device)
    print(json.dumps(rec))
    ok = rec["converged"] and rec.get("eager_converged", True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
