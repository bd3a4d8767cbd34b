"""The command line: `python -m maelstrom_tpu_torch test ...`.

Counterpart of the `test` subcommand of `maelstrom_tpu/cli.py`, with its
option names and defaults. The port runs the broadcast workload on the
built-in program (`--node tpu:broadcast`), batched atomic broadcast
(`-w broadcast-batched --node tpu:broadcast-batched`), the lin-kv
workload on Raft
(`--node tpu:lin-kv`, graded by the linearizability checker), echo and
unique-ids on the pool-path programs, g-set, pn-counter and g-counter
on the CRDT programs and kafka (classic, or consumer groups with
`--kafka-groups`) on the replicated-log program (`--node
tpu:<workload>`), txn-list-append (graded by Elle, its edge build and
cycle screen on the device with `--device-checker on`) and
txn-rw-register on the Raft transaction programs, lin-mutex on
`tpu:lin-kv`, lin-kv, lin-mutex, kafka and txn-list-append over the
ordering axis (`--ordering raft|batched`, the composed `tpu:ordered`),
lin-tso on the in-cluster services (`--node tpu:services
[--service-roles ...]`, a role partition), lin-kv on compartmentalized
consensus (`--node tpu:compartment [--roles ...]`, also an engine of the
ordering axis; `--roles sequencers=S` with S > 1 elects the leader, and
`--nemesis kill --nemesis-targets kill=sequencer` kills the live one,
each kill a failover), any of these programs wrapped
as a one-role partition (`--node tpu:solo:<program>`), on one card, or
on the CPU with `--device cpu`, under loss, randomized latency and the
partition, kill, pause, duplicate and weather nemeses (kill, pause and
partition scoped to role groups or nodes with `--nemesis-targets`), and
under the byzantine adversary (`--nemesis byzantine`, `--byz-rate`,
`--byz-attacks`: the compartment's equivocating or stale-ballot
sequencer, the batched broadcast's forged proofs, each run graded by its
`byzantine` conviction block),
round-synchronous or in continuous mode (`--continuous`), with the
flight recorder (`--telemetry [DIR]`, tailed by `top`), and as fleets:
`--fleet N` runs N independent broadcast or Raft lin-kv clusters in
lockstep (`--fleet-sweep seed|nemesis|capacity`, `--sessions
columnar|coroutine`), each byte-identical to its standalone run. `fuzz` runs
the broadcast and kafka fault sweeps (`fuzz.py`). Every other option of the JAX CLI is recognised and refused unless it holds its
default, with an error that names the slice of the port that brings it
(`OUT_OF_SCOPE`).

    python -m maelstrom_tpu_torch test -w broadcast --node tpu:broadcast \\
        --node-count 25 --topology tree4 --latency 10 --nemesis partition \\
        [--device cpu]
    python -m maelstrom_tpu_torch test -w lin-kv --node tpu:lin-kv \\
        --node-count 5 --rate 20 --nemesis kill,pause,partition [--device cpu]
    python -m maelstrom_tpu_torch test -w pn-counter --node tpu:pn-counter \\
        --node-count 5 --nemesis partition [--device cpu]
    python -m maelstrom_tpu_torch test -w kafka --node tpu:kafka \\
        --node-count 5 --rate 20 --kafka-groups 2 [--device cpu]
    python -m maelstrom_tpu_torch test -w broadcast-batched \\
        --node tpu:broadcast-batched --node-count 5 --batch-max 16
    python -m maelstrom_tpu_torch test -w lin-kv --ordering batched
    python -m maelstrom_tpu_torch test -w txn-list-append \\
        --node tpu:txn-list-append --device-checker on
    python -m maelstrom_tpu_torch test -w lin-mutex --node tpu:lin-kv
    python -m maelstrom_tpu_torch test -w kafka --node tpu:kafka \\
        --node-count 5 --continuous --kafka-groups 2 \\
        --nemesis kill,pause,partition,duplicate,weather --telemetry tel
    python -m maelstrom_tpu_torch top tel
    python -m maelstrom_tpu_torch test -w lin-tso --node tpu:services \\
        --nemesis kill,pause,partition --nemesis-targets \\
        kill=lww-kv,pause=lin-tso
    python -m maelstrom_tpu_torch test -w lin-kv --node tpu:compartment \\
        --roles proxies=4,acceptors=2x2,replicas=2 --nemesis kill,partition \\
        --nemesis-targets kill=proxies,partition=acceptor-col-0
    python -m maelstrom_tpu_torch test -w lin-kv --node tpu:compartment \
        --roles sequencers=3,proxies=4,acceptors=2x2,replicas=2 \
        --nemesis kill --nemesis-targets kill=sequencer
    python -m maelstrom_tpu_torch test -w lin-kv --node tpu:compartment \
        --roles sequencers=2,proxies=2,acceptors=1x2,replicas=1 \
        --nemesis byzantine --nemesis-targets byzantine=sequencers \
        --byz-attacks stale-ballot
    python -m maelstrom_tpu_torch test -w lin-kv --node tpu:solo:lin-kv
    python -m maelstrom_tpu_torch test -w lin-kv --node tpu:lin-kv \
        --node-count 3 --fleet 8 --fleet-sweep nemesis --nemesis partition
    python -m maelstrom_tpu_torch fuzz --program broadcast --nodes 100000
"""

from __future__ import annotations

import argparse
import logging
import sys

WORKLOADS = ["broadcast", "broadcast-batched", "echo", "g-set", "g-counter",
             "pn-counter", "lin-kv", "lin-mutex", "lin-tso",
             "txn-list-append", "unique-ids", "kafka", "txn-rw-register"]

# the built-in program each workload the port runs is served by
PROGRAMS = {"broadcast": "tpu:broadcast", "lin-kv": "tpu:lin-kv",
            "lin-mutex": "tpu:lin-kv",
            **{w: f"tpu:{w}" for w in ("echo", "unique-ids", "g-set",
                                       "pn-counter", "g-counter",
                                       "kafka", "broadcast-batched",
                                       "txn-list-append",
                                       "txn-rw-register")},
            "lin-tso": "tpu:services"}
# the other built-in programs a workload may name with --node
ALSO = {"lin-kv": ("tpu:compartment",)}

MULTI_GPU = "the multi-GPU slice (torch.distributed)"

# (option, refused when, the slice of the port that brings it)
OUT_OF_SCOPE = [
    ("--bin", lambda v: v is not None,
     "the host-process path (external node binaries)"),
    ("--workload", lambda v: v not in PROGRAMS, "the other node programs"),
    ("--mesh", lambda v: v is not None, MULTI_GPU),
    ("--checkpoint-every", lambda v: v is not None,
     "checkpoint and resume"),
    ("--resume", lambda v: v is not None, "checkpoint and resume"),
    ("--sync-checkpoint", bool, "checkpoint and resume"),
    ("--check-workers", lambda v: v is not None and v > 0,
     "the overlap pipeline"),
]


def _faults(spec: str) -> set:
    """--nemesis kill,pause -> {"kill", "pause"}."""
    return set(filter(None, spec.split(",")))


class ScopeError(ValueError):
    """An option this slice of the port does not run."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="maelstrom_tpu_torch",
        description="The PyTorch / CUDA port of maelstrom_tpu.")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("test", help="Run a single test")
    t.add_argument("--node", help="Built-in node program: tpu:<the "
                                  "workload>, tpu:lin-kv for lin-kv and "
                                  "lin-mutex, tpu:compartment for lin-kv, "
                                  "tpu:services for lin-tso, or "
                                  "tpu:solo:<that program>")
    t.add_argument("-w", "--workload", default="lin-kv", choices=WORKLOADS,
                   help="What workload to run (the port: broadcast, "
                        "broadcast-batched, lin-kv, lin-mutex, lin-tso, "
                        "echo, unique-ids, g-set, pn-counter, g-counter, "
                        "kafka, txn-list-append, txn-rw-register)")
    t.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu: the kernels' plain "
                        "PyTorch versions on the CPU")
    t.add_argument("--node-count", type=int,
                   help="How many nodes to run. Overrides --nodes.")
    t.add_argument("--nodes", help="Comma-separated node names")
    t.add_argument("--rate", type=float, default=5.0,
                   help="Approximate number of requests/sec")
    t.add_argument("--time-limit", type=float, default=10.0,
                   help="Test duration in seconds")
    t.add_argument("--concurrency", type=int,
                   help="Number of client workers")
    t.add_argument("--latency", type=float, default=0,
                   help="Mean network latency in ms")
    t.add_argument("--topology", default="grid",
                   choices=["line", "grid", "tree", "tree2", "tree3",
                            "tree4", "total"],
                   help="Network topology offered to broadcast nodes")
    t.add_argument("--max-values", type=int,
                   help="Broadcast value-table capacity (broadcast / "
                        "broadcast-batched nodes; default 1024)")
    t.add_argument("--nemesis", default="",
                   help="Comma-separated fault packages: partition, kill, "
                        "pause, duplicate, weather")
    t.add_argument("--nemesis-interval", type=float, default=10.0,
                   help="Seconds between nemesis operations")
    t.add_argument("--nemesis-seed", type=int,
                   help="Seed of the nemesis decision streams (default: "
                        "--seed)")
    t.add_argument("--latency-dist", default="constant",
                   choices=["constant", "uniform", "exponential"],
                   help="Latency distribution")
    t.add_argument("--p-loss", type=float, default=0.0,
                   help="Probability of losing each message")
    t.add_argument("--latency-scale", type=float, default=1.0,
                   help="Baseline latency scale factor (the weather "
                        "nemesis restores it)")
    t.add_argument("--client-backoff-ms", type=float, default=50.0)
    t.add_argument("--client-backoff-cap-ms", type=float, default=2000.0)
    t.add_argument("--key-count", type=int)
    t.add_argument("--max-txn-length", type=int, default=4)
    t.add_argument("--max-writes-per-key", type=int, default=16)
    t.add_argument("--consistency-models", default="strict-serializable")
    t.add_argument("--log-stderr", action="store_true")
    t.add_argument("--log-net-send", action="store_true")
    t.add_argument("--log-net-recv", action="store_true")
    t.add_argument("--seed", type=int, default=0, help="PRNG seed")
    t.add_argument("--store", default="store", help="Store directory root")
    t.add_argument("--max-scan", type=int,
                   help="Upper bound on rounds per scan dispatch "
                        "(default 65536)")
    t.add_argument("--journal-scan-cap", type=int,
                   help="Journal rows buffered on the device per "
                        "dispatch on journaled runs (default 256)")
    t.add_argument("--reply-log-cap", type=int,
                   help="Client replies buffered on the device per "
                        "dispatch (default 256)")
    t.add_argument("--timeout-ms", type=float, default=None,
                   help="Client RPC timeout in virtual ms (default 5000)")
    t.add_argument("--ms-per-round", type=float, default=1.0,
                   help="Virtual milliseconds per simulation round")
    t.add_argument("--no-audit", action="store_true",
                   help="Accepted for compatibility: the static-audit "
                        "block is not ported, so results never carry it")
    t.add_argument("--no-overlap", action="store_true",
                   help="Accepted for compatibility: the overlapped "
                        "analysis pipeline is not ported")
    t.add_argument("--on-preempt", choices=["checkpoint", "abort"],
                   default="checkpoint",
                   help="Accepted for compatibility: without checkpoints "
                        "a signal ends the run")
    # the JAX CLI's other options (`OUT_OF_SCOPE` refuses those the port
    # does not run unless at their default)
    t.add_argument("--bin")
    t.add_argument("--nemesis-targets",
                   help="Scope node-picking faults to groups: "
                        "fault=group[+group],... (kill, pause, partition; "
                        "groups come from the node family's fault groups, "
                        "e.g. lin-tso, seq-kv, lww-kv for tpu:services, "
                        "or are literal node names)")
    t.add_argument("--client-retries", type=int, default=0,
                   help="Leader-redirect hops a client op may take "
                        "(0, the default: 16)")
    t.add_argument("--continuous", action="store_true",
                   help="Continuous generator mode: client ops are "
                        "injected at their seeded offered-rate rounds "
                        "inside the scan window (traffic lands while "
                        "the nemesis's faults are live) instead of one "
                        "dispatch an op")
    t.add_argument("--continuous-window-ms", type=float,
                   help="Continuous-mode window in virtual ms (default "
                        "250): windows cross replies, and the window "
                        "bounds how long a freed worker waits for the "
                        "generator's next poll")
    t.add_argument("--fleet", type=int,
                   help="Run N independent clusters in lockstep (the "
                        "fleet runner): one batched state, one fleet scan "
                        "a wave; each cluster byte-identical to its "
                        "standalone run (broadcast and Raft lin-kv)")
    t.add_argument("--fleet-sweep", choices=["seed", "nemesis", "capacity"],
                   help="What the fleet varies a cluster (default seed): "
                        "seed + i, the nemesis seed (same ops, other "
                        "faults), or the offered rate x (i + 1)")
    t.add_argument("--mesh")
    t.add_argument("--sessions", choices=["coroutine", "columnar"],
                   help="Client-session table: columnar (one table for "
                        "the fleet, the default under --fleet) or "
                        "coroutine (the default standalone); the same "
                        "bytes either way")
    t.add_argument("--checkpoint-every", type=float)
    t.add_argument("--resume")
    t.add_argument("--sync-checkpoint", action="store_true")
    t.add_argument("--telemetry", nargs="?", const="auto", default=None,
                   metavar="DIR|off",
                   help="Flight recorder: a metric ring folded into every "
                        "round on the device (message flow, pool and "
                        "channel occupancy, per-role sends, latency in "
                        "rounds), drained on the existing fetches, with "
                        "phase spans (trace.json) and a telemetry.jsonl "
                        "record a window (tail it with `top`). DIR names "
                        "the directory; bare --telemetry puts it in the "
                        "store dir. Histories are byte-identical on or "
                        "off")
    t.add_argument("--check-workers", type=int)
    t.add_argument("--device-checker", choices=["auto", "on", "off"],
                   help="txn-list-append: the Elle checker's edge build "
                        "and cycle screen on the device (kernels K16, "
                        "K17): on, off, or auto (the default: past 1,024 "
                        "transactions)")
    t.add_argument("--byz-rate", type=float, default=1.0,
                   help="Byzantine injection probability a round while an "
                        "attack window is open (--nemesis byzantine; a pure "
                        "hash gate, so the benign streams do not move)")
    t.add_argument("--byz-attacks", default=None,
                   help="Restrict the byzantine package's attack pool: a "
                        "comma list of equivocation, forged-proof, "
                        "stale-ballot (default: all)")
    t.add_argument("--ordering", choices=["raft", "compartment", "batched"],
                   help="Ordering engine under the workload's applier "
                        "(lin-kv, lin-mutex, kafka, txn-list-append): raft, "
                        "compartment (sized by --roles) or batched; runs "
                        "the composed program tpu:ordered")
    t.add_argument("--roles",
                   help="tpu:compartment layout: sequencers=S,proxies=P,"
                        "acceptors=RxC,replicas=R (default sequencers=1,"
                        "proxies=2,acceptors=2x2,replicas=2); S > 1 makes "
                        "the leader elected, so a kill of the live "
                        "sequencer fails over; sizes the cluster when "
                        "--node-count is not given")
    t.add_argument("--service-roles",
                   help="tpu:services layout, e.g. lin-tso=1,seq-kv=1,"
                        "lww-kv=3 (the default); sizes the cluster when "
                        "--node-count is not given")
    t.add_argument("--election-timeout-rounds", type=int,
                   help="Failure-detector deadline of the sequencer "
                        "election in rounds (default 60; --roles "
                        "sequencers>1)")
    t.add_argument("--ballot-width", type=int)
    t.add_argument("--compartment-retry", type=int,
                   help="tpu:compartment: rounds between the sequencer's "
                        "and the proxies' resends (default 10)")
    t.add_argument("--leader-lease-ms", type=float,
                   help="Client-side leader lease in virtual ms: new ops "
                        "rotate to the next candidate after this long "
                        "without a reply from the guessed leader "
                        "(default twice the election timeout; 0 off)")
    t.add_argument("--batch-max", type=int,
                   help="Batched broadcast: max client values distilled "
                        "into one batch (broadcast-batched workload; "
                        "default 16)")
    t.add_argument("--kafka-groups", type=int,
                   help="Kafka consumer groups: N > 0 switches polls to "
                        "group subscriptions with cursor fetches, "
                        "coordinator rebalancing and per-group commits")
    t.add_argument("--session-timeout-ms", type=float,
                   help="Consumer-group session timeout: a member silent "
                        "this long is evicted (default 2500)")
    t.add_argument("--poll-batch", type=int,
                   help="Max entries a consumer-group fetch (default 8)")

    tp = sub.add_parser(
        "top", help="Tail a run's telemetry stream: the freshest window "
                    "(round, ops, delivered rate, p50/p95/p99 latency)")
    tp.add_argument("path", nargs="?", default="store/latest",
                    help="telemetry dir, telemetry.jsonl file, or a store "
                         "test dir (default: store/latest)")
    tp.add_argument("--follow", action="store_true",
                    help="render again every --interval seconds until "
                         "interrupted")
    tp.add_argument("--interval", type=float, default=1.0)

    f = sub.add_parser("fuzz", help="Fault-mix sweeps: broadcast set-full "
                                    "at scale (BASELINE config 5), kafka")
    f.add_argument("--program", choices=["broadcast", "raft", "kafka"],
                   default="broadcast")
    f.add_argument("--nodes", type=int, default=None,
                   help="broadcast: node count (default 4096); kafka: "
                        "node count (default 5)")
    f.add_argument("--values", type=int, default=32)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    f.add_argument("--store", default="store",
                   help="Store directory root of the kafka runs")
    return p


def _check_fleet(args) -> None:
    """The combinations a fleet (--fleet N, N > 1) does not run yet
    (`runner.fleet_runner.check_fleet_scope`), refused before any store
    dir."""
    from .runner.fleet_runner import check_fleet_scope
    try:
        check_fleet_scope({"nemesis": _faults(args.nemesis),
                           "continuous": args.continuous,
                           "telemetry": args.telemetry,
                           "workload": args.workload, "node": args.node,
                           "ordering": args.ordering})
    except (ValueError, NotImplementedError) as e:
        raise ScopeError(str(e)) from None


def check_scope(args) -> None:
    """Raises ScopeError naming the first option this slice refuses."""
    if (args.fleet or 1) > 1 and not args.ordering and not (
            args.node and str(args.node).startswith("tpu:")):
        # the JAX CLI's words
        raise ScopeError("--fleet needs the TPU path (--node tpu:<program>)"
                         ": the cluster axis is a vmapped dimension of the "
                         "compiled scan")
    for flag, refused, slice_ in OUT_OF_SCOPE:
        value = getattr(args, flag.lstrip("-").replace("-", "_"))
        if refused(value):
            raise ScopeError(f"{flag} {value!r}: maelstrom_tpu_torch does "
                             f"not run it yet; it comes with {slice_}")
    if (args.fleet or 1) > 1:
        _check_fleet(args)
    if args.ordering:
        return   # the node is the composed tpu:ordered (core.build_test)
    want = PROGRAMS[args.workload]
    # tpu:solo:<program> wraps the program as a one-role partition
    if args.node not in (want, "tpu:solo:" + want[len("tpu:"):],
                         *ALSO.get(args.workload, ())):
        raise ScopeError(f"--node {args.node!r}: the port runs -w "
                         f"{args.workload} on --node {want} or "
                         f"tpu:solo:{want[len('tpu:'):]} (other programs "
                         f"come with the other node programs)")


def opts_from_args(args) -> dict:
    check_scope(args)
    if args.ordering and not args.node:
        args.node = "tpu:ordered"
    opts = {
        "workload": args.workload,
        "bin": None,
        "node": args.node,
        "device": args.device,
        "node_count": args.node_count,
        "nodes": args.nodes.split(",") if isinstance(args.nodes, str)
        else None,
        "rate": args.rate,
        "time_limit": args.time_limit,
        "concurrency": args.concurrency,
        "latency": {"mean": args.latency, "dist": args.latency_dist},
        "p_loss": args.p_loss,
        "latency_scale": args.latency_scale,
        "continuous": args.continuous,
        "nemesis": _faults(args.nemesis),
        "nemesis_interval": args.nemesis_interval,
        "client_retries": args.client_retries,
        "client_backoff_ms": args.client_backoff_ms,
        "client_backoff_cap_ms": args.client_backoff_cap_ms,
        "topology": args.topology,
        "key_count": args.key_count,
        "max_txn_length": args.max_txn_length,
        "max_writes_per_key": args.max_writes_per_key,
        "consistency_models": [m.strip() for m in
                               args.consistency_models.split(",")
                               if m.strip()],
        "log_stderr": args.log_stderr,
        "log_net_send": args.log_net_send,
        "log_net_recv": args.log_net_recv,
        "seed": args.seed,
        "store_root": args.store,
        "ms_per_round": args.ms_per_round,
        "checkpoint_every": None,
        "resume": None,
        "sync_checkpoint": False,
        "on_preempt": args.on_preempt,
        "no_overlap": args.no_overlap,
        "audit": False,
        "audit_trace": False,
        "ordering": args.ordering,
        "fleet": args.fleet or 1,
        "fleet_sweep": args.fleet_sweep or "seed",
        "sessions": args.sessions,
    }
    # performance knobs: only forwarded when given, so the runner's own
    # defaults stay in one place
    for k in ("max_scan", "journal_scan_cap", "reply_log_cap",
              "max_values", "timeout_ms", "nemesis_seed", "kafka_groups",
              "session_timeout_ms", "poll_batch", "batch_max",
              "device_checker", "continuous_window_ms", "service_roles",
              "nemesis_targets", "roles", "compartment_retry",
              "ballot_width", "election_timeout_rounds", "leader_lease_ms",
              "byz_rate", "byz_attacks"):
        v = getattr(args, k, None)
        if v is not None:
            opts[k] = v
    # the flight recorder: "off" is the explicit disable spelling
    if args.telemetry and args.telemetry != "off":
        opts["telemetry"] = args.telemetry
    return opts


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    args = build_parser().parse_args(argv)
    if args.cmd == "test":
        from . import core
        try:
            results = core.run(opts_from_args(args))
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        valid = results.get("valid")
        print("\nEverything looks good! ヽ(‘ー`)ノ" if valid is True else
              ("\nValidity unknown (;￣ー￣)" if valid == "unknown" else
               "\nAnalysis invalid! (ﾉಥ益ಥ)ﾉ ┻━┻"))
        return 0 if valid is True else (2 if valid == "unknown" else 1)
    if args.cmd == "top":
        from .telemetry import top_main
        return top_main(args.path, follow=args.follow,
                        interval=args.interval)
    if args.cmd == "fuzz":
        from .fuzz import main as fuzz_main
        try:
            return fuzz_main(args.nodes, args.values, args.seed,
                             program=args.program, device=args.device,
                             store_root=args.store)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    return 1
