"""The broadcast throughput benchmark on the port.

The same workload as `bench.py`'s broadcast record (`_main_broadcast`): a
grid of `n_nodes` nodes, `values` broadcast values injected one every
other round at Fibonacci-hash spread nodes, one gossip lane per edge,
constant latency 0, pool 8192, 700 rounds. With `eager=True` it runs the
eager-resend protocol and then the efficient send-once-plus-retry one,
and reports the efficient run as the headline with the eager run under
`eager_*` keys, as bench.py does. A run counts only with `converged`
true: every node has seen every value.

    python -m maelstrom_tpu_torch.bench [--nodes N] [--values V] ...
"""

from __future__ import annotations

import argparse
import json
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--values", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=700)
    ap.add_argument("--gossip", type=int, default=1)
    ap.add_argument("--pool", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--no-eager", action="store_true",
                    help="run only the efficient protocol")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace a window of rounds in each mode instead")
    a = ap.parse_args(argv)
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
