"""Fault-mix sweeps: the broadcast fuzz at scale and the kafka fuzz.

Counterpart of `maelstrom_tpu/fuzz.py` (`fuzz_broadcast`, `fuzz_kafka`,
`main`). The broadcast fuzz is BASELINE config 5 ("broadcast fuzz: 100k
nodes, random partitions + latency sweep"): the broadcast simulation runs
in chunks of rounds through a sweep of fault configurations (latency
distributions, message loss, a random two-component partition injected
while values are still being injected and healed after) and each config
is graded on its final state: every value that was born reached every
node, with no silent drop. The partition is a component label a node,
flipped between chunks (no N x N matrix). The kafka fuzz runs the graded
kafka test under its own sweep.

    python -m maelstrom_tpu_torch fuzz --nodes 100000        # broadcast
    python -m maelstrom_tpu_torch fuzz --program kafka       # 5 nodes
    python -m maelstrom_tpu_torch fuzz --nodes 256 --device cpu
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

DEFAULT_SWEEP = [
    {"name": "zero-latency+partition", "latency": 0, "dist": "constant",
     "p_loss": 0.0, "partition": True},
    {"name": "latency2+loss5%+partition", "latency": 2, "dist": "constant",
     "p_loss": 0.05, "partition": True},
    {"name": "uniform-latency+partition", "latency": 2, "dist": "uniform",
     "p_loss": 0.0, "partition": True},
    {"name": "exponential-latency+loss2%", "latency": 2,
     "dist": "exponential", "p_loss": 0.02, "partition": False},
]


def fuzz_broadcast(n_nodes: int = 4096, values: int = 32,
                   sweep=None, seed: int = 0, chunk: int = 100,
                   max_rounds: int = 20_000, log=print,
                   device="cuda") -> list[dict]:
    from .net import tpu as T
    from .nodes import get_program
    from .nodes.broadcast import T_BCAST
    from .sim import make_run_fn, make_sim
    from .tree import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    results = []
    for ci, c in enumerate(sweep or DEFAULT_SWEEP):
        nodes = [f"n{i}" for i in range(n_nodes)]
        program = get_program(
            "broadcast",
            {"topology": "grid", "max_values": values,
             "latency": {"mean": c["latency"], "dist": c["dist"]},
             "ms_per_round": 1.0},
            nodes, device=dev)
        cfg = T.NetConfig(
            n_nodes=n_nodes, n_clients=1, pool_cap=max(64, 2 * values),
            inbox_cap=program.inbox_cap, client_cap=0,
            latency_mean_rounds=float(c["latency"]),
            latency_dist=c["dist"])
        run_fn = make_run_fn(program, cfg, device=dev)
        sim = make_sim(program, cfg, seed=seed + ci, device=dev)
        if c["p_loss"]:
            sim = sim.replace(net=T.flaky(sim.net, c["p_loss"]))

        # injections target a 4-chunk span (one a round at most, so large
        # value counts extend it); the partition covers chunks 1-2, so
        # values born inside one component must cross after the heal.
        # Convergence is declared only once the last injection has passed
        step = max(1, 4 * chunk // values)
        inj_rounds = step * values
        inj_span = -(-inj_rounds // chunk) * chunk

        def make_chunk(r0):
            rr = np.arange(r0, r0 + chunk)
            on = (rr % step == 0) & (rr // step < values)
            val = (rr // step) % values
            dest = (val.astype(np.int64) * 2654435761) % n_nodes

            def col(x):
                return torch.from_numpy(
                    np.ascontiguousarray(x, dtype=np.int32)[:, None]).to(dev)
            return T.Msgs.empty((chunk, 1), dev).replace(
                valid=torch.from_numpy(on[:, None]).to(dev),
                src=col(np.full(chunk, n_nodes)), dest=col(dest),
                type=col(np.full(chunk, T_BCAST)), a=col(val))

        # the partition window: two random components while values are
        # still being injected, healed afterwards
        part_from, part_until = chunk, 3 * chunk
        labels = rng.integers(0, 2, size=n_nodes).tolist()

        t0 = time.perf_counter()
        r = 0
        converged_at = None
        partitioned = False
        while r < max_rounds:
            want = c["partition"] and part_from <= r < part_until
            if want != partitioned:      # flip fault state at boundaries
                sim = sim.replace(
                    net=(T.partition_components(sim.net, labels) if want
                         else T.heal(sim.net)))
                partitioned = want
            sim, _counts = run_fn(sim, make_chunk(r))
            r += chunk
            if r >= inj_span:
                seen = sim.nodes["seen"][:, :values].cpu().numpy()
                # a value whose injection was lost is indeterminate (no
                # node saw it); every value born must reach every node,
                # probed only with the network healed
                born = seen.any(axis=0)
                if (seen.all(axis=0) == born).all() and not partitioned:
                    converged_at = r
                    n_born = int(born.sum())
                    break
        dt = time.perf_counter() - t0

        st = T.stats_dict(sim.net)
        ch = sim.channels
        overwrites = int(ch.overwrites) if ch is not None else 0
        # ring overwrites are a bounded-channel drop, legal only for a
        # program that retransmits until acknowledged
        tolerated = getattr(program, "tolerates_channel_overwrites", False)
        # randomized-dist configs accept clipped tail draws: past 4,096
        # nodes the ring is 8x the mean, and a draw clipped shorter can
        # only speed convergence, the property checked; recorded
        clipped = int(ch.lat_clipped) if ch is not None else 0
        clip_tolerated = c["dist"] != "constant"
        ok = (converged_at is not None and st["dropped_overflow"] == 0
              and (overwrites == 0 or tolerated)
              and (clipped == 0 or clip_tolerated))
        res = {
            "config": c["name"], "nodes": n_nodes, "values": values,
            "values_born": n_born if converged_at is not None else None,
            "ok": bool(ok), "converged_at_round": converged_at,
            "wall_s": round(dt, 2),
            "delivered": st["recv_all"], "lost": st["lost"],
            "dropped_partition": st["dropped_partition"],
            "dropped_overflow": st["dropped_overflow"],
            "channel_overwrites": overwrites,
            "latency_clipped": clipped,
            "latency_clip_tolerated": bool(clip_tolerated),
        }
        results.append(res)
        log(json.dumps(res))
    return results


KAFKA_SWEEP = [
    {"name": "partition", "p_loss": 0.0, "latency": None,
     "partition": True},
    {"name": "loss3%+partition", "p_loss": 0.03, "latency": None,
     "partition": True},
    {"name": "latency3-uniform+loss2%", "p_loss": 0.02,
     "latency": {"mean": 3, "dist": "uniform"}, "partition": False},
    {"name": "latency5-exponential+partition", "p_loss": 0.0,
     "latency": {"mean": 5, "dist": "exponential"}, "partition": True},
    {"name": "loss3%+latency3-exponential+partition", "p_loss": 0.03,
     "latency": {"mean": 3, "dist": "exponential"}, "partition": True},
]


def fuzz_kafka(n_nodes: int = 5, seed: int = 0, time_limit: float = 6.0,
               rate: float = 20.0, sweep=None, log=print, device="cuda",
               store_root: str = "store",
               nemesis_interval: float = 2.0) -> list[dict]:
    """The kafka program end to end through the runner under the fault
    sweep, graded by the kafka checker with the net checker's audit of
    silent drops gating each run. The runs' stores go under
    `store_root`/kafka; `nemesis_interval` is the partitioning configs'
    (the JAX sweep's 2 s by default; scale it with a shorter
    `time_limit` to keep the sweep's partitions and heals)."""
    from . import core

    results = []
    for ci, c in enumerate(sweep or KAFKA_SWEEP):
        opts = dict(
            store_root=store_root, device=device,
            seed=seed + 31 * ci, workload="kafka", node="tpu:kafka",
            node_count=n_nodes, rate=rate, time_limit=time_limit,
            journal_rows=False, p_loss=c["p_loss"])
        if c["latency"]:
            opts["latency"] = c["latency"]
        if c["partition"]:
            opts.update(nemesis={"partition"},
                        nemesis_interval=nemesis_interval)
        r = core.run(opts)
        net = r.get("net") or {}
        res = {
            "config": c["name"], "nodes": n_nodes,
            "ok": bool(r["valid"]),
            "valid": r["valid"],
            "ops": (r.get("stats") or {}).get("count"),
            "dropped_overflow": net.get("dropped-overflow"),
            "lost": net.get("lost"),
            "dropped_partition": net.get("dropped-partition"),
        }
        results.append(res)
        log(json.dumps(res))
    return results


def main(n_nodes: int | None, values: int, seed: int,
         program: str = "broadcast", device="cuda",
         store_root: str = "store") -> int:
    if program == "broadcast":
        results = fuzz_broadcast(n_nodes=n_nodes or 4096, values=values,
                                 seed=seed, device=device)
    elif program == "kafka":
        results = fuzz_kafka(n_nodes=n_nodes or 5, seed=seed,
                             device=device, store_root=store_root)
    elif program == "raft":
        raise NotImplementedError(
            "fuzz --program raft runs the graded Raft fleet under faults, "
            "which maelstrom_tpu_torch does not run yet; it comes with the "
            "cluster axis under faults")
    else:
        raise ValueError(f"unknown fuzz program {program!r}")
    ok = all(r["ok"] for r in results)
    print(json.dumps({"fuzz": program, "configs": len(results),
                      "all_ok": ok}))
    return 0 if ok else 1
