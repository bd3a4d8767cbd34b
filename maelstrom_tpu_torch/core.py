"""Test composition and execution: the maelstrom-test equivalent.

Counterpart of `maelstrom_tpu/core.py` for the parts the port runs:
`DEFAULTS`, `parse_nodes` (with the node count a role partition
derives), and the built-in-program branch of `build_test` for the
workloads of `WORKLOADS` (the nemesis package beside the clients, the
generator phases with the nemesis's final heal, the composed checker
suite with the byzantine conviction source under `--nemesis byzantine`
and the `--byz-attacks` pool; `ordering` selects the composed program
`tpu:ordered`), without the host network and external node
processes. `run` makes the store dir, attaches the network journal and
the run log, and hands the test to `runner.tpu_runner.run_tpu_test`
(which routes `--fleet N`, N > 1, to `runner.fleet_runner`: N
independent clusters, each the standalone run of `FleetSpec.cluster_opts`,
the JAX package's `FleetSpec`)."""

from __future__ import annotations

import importlib
import logging
import os
from dataclasses import dataclass

from . import generators as g
from . import nemesis as nem
from . import store
from .checkers import Compose, Stats, UnhandledExceptions
from .checkers.perf import PerfChecker, TimelineChecker
from .net.journal import Journal
from .tree import resolve_device

log = logging.getLogger("maelstrom")

# The JAX package's option defaults, key for key (test.json stores the
# keys of this dict). The CLI refuses non-default values of the options
# this slice does not port.
DEFAULTS = dict(
    workload="lin-kv", node_count=None, nodes=None, rate=5.0,
    time_limit=10.0, concurrency=None, latency={"mean": 0,
                                                "dist": "constant"},
    nemesis=set(), nemesis_interval=10.0, topology="grid",
    key_count=None, max_txn_length=4, max_writes_per_key=16,
    consistency_models=["strict-serializable"], log_stderr=False,
    log_net_send=False, log_net_recv=False, seed=0, store_root="store",
    client_retries=0, client_backoff_ms=50.0, client_backoff_cap_ms=2000.0,
    mesh=None, check_workers=None, no_overlap=False,
    device_checker="auto",
    checkpoint_every=None, resume=None, sync_checkpoint=False,
    on_preempt="checkpoint",
    audit=True, audit_trace=False,
    fleet=1, fleet_sweep="seed", nemesis_seed=None,
    p_loss=None, latency_scale=1.0,
    continuous=False, continuous_window_ms=250.0,
    kafka_groups=0, session_timeout_ms=2500.0, poll_batch=8,
    batch_max=16, batch_dup_rate=0.25,
    telemetry=None,
    roles=None, service_roles=None, nemesis_targets=None,
    byz_rate=1.0, byz_attacks=None,
    election_timeout_rounds=60, ballot_width=6,
    availability_dip_rounds=None,
    leader_lease_ms=None,
    ordering=None,
    sessions=None,
)


# Keys build_test adds to a test dict (derived objects, not options):
# stripped when a fleet re-derives each cluster's option set, so each
# cluster's test is built from scratch as its standalone run's would be
_BUILT_KEYS = frozenset({"net", "workload_map", "client", "generator",
                         "checker", "nemesis_pkg", "store_dir",
                         "analysis", "journal", "transfer"})


@dataclass(frozen=True)
class FleetSpec:
    """The campaign of `--fleet N --fleet-sweep <dim>` (the JAX package's
    `FleetSpec`): N independent clusters in lockstep, differing along
    one swept dimension:

      - ``seed``: cluster i runs with seed base + i (its op stream, its
        simulation's draws and its nemesis schedule);
      - ``nemesis``: the op stream is fixed (the base seed) and only the
        nemesis decision streams vary (nemesis_seed = base + i);
      - ``capacity``: the seed is fixed and cluster i offers rate * (i +
        1).

    Static shapes (node count, concurrency, capacities, fault packages)
    stay uniform: they define the one program every cluster shares.
    Cluster i's history equals the standalone run of `cluster_opts(i)`
    byte for byte."""

    fleet: int = 1
    sweep: str = "seed"

    SWEEPS = ("seed", "nemesis", "capacity")

    @classmethod
    def from_test(cls, test: dict) -> "FleetSpec":
        raw = test.get("fleet")
        fleet = 1 if raw is None else int(raw)
        sweep = str(test.get("fleet_sweep") or "seed")
        if fleet < 1:
            raise ValueError(f"--fleet must be >= 1, got {fleet}")
        if sweep not in cls.SWEEPS:
            raise ValueError(f"--fleet-sweep {sweep!r}: expected one of "
                             f"{list(cls.SWEEPS)}")
        return cls(fleet=fleet, sweep=sweep)

    def cluster_opts(self, test: dict, i: int) -> dict:
        """The option set whose standalone run cluster i replays: the
        base test's options plus this cluster's swept value, with the
        fleet-level mechanics (mesh, resume, per-message journaling, the
        static-audit block) stripped or forced off."""
        opts = {k: v for k, v in test.items() if k not in _BUILT_KEYS}
        opts.update(fleet=1, fleet_sweep=self.sweep, mesh=None, resume=None,
                    journal_rows=False, audit=False, audit_trace=False)
        base_seed = int(test.get("seed", 0) or 0)
        if self.sweep == "seed":
            opts["seed"] = base_seed + i
        elif self.sweep == "nemesis":
            opts["nemesis_seed"] = base_seed + i
        else:   # capacity: the offered-load ramp
            opts["rate"] = float(test.get("rate", DEFAULTS["rate"])) \
                * (i + 1)
        return opts


# the workloads the port runs, each on its built-in program: the module
# of `workloads` that builds it
WORKLOADS = {"broadcast": "broadcast", "lin-kv": "lin_kv", "echo": "echo",
             "unique-ids": "unique_ids", "g-set": "g_set",
             "pn-counter": "pn_counter", "g-counter": "g_counter",
             "kafka": "kafka", "broadcast-batched": "broadcast_batched",
             "lin-mutex": "lin_mutex", "txn-list-append": "txn_list_append",
             "txn-rw-register": "txn_rw_register", "lin-tso": "lin_tso"}


def parse_nodes(opts: dict) -> list[str]:
    """--node-count N overrides --nodes, generating n0..n(N-1)
    (reference `core.clj:197-204`). A role-partitioned family
    (`--node tpu:services`) derives its node count from its role spec
    when neither is given."""
    if opts.get("node_count"):
        return [f"n{i}" for i in range(opts["node_count"])]
    if opts.get("nodes"):
        return opts["nodes"]
    spec = str(opts.get("node") or "")
    if spec.startswith("tpu:"):
        from .nodes import partition_node_count
        n = partition_node_count(spec[len("tpu:"):], opts)
        if n:
            return [f"n{i}" for i in range(n)]
    return ["n0", "n1", "n2", "n3", "n4"]


def build_test(opts: dict) -> dict:
    opts = {**DEFAULTS, **opts}
    if opts.get("ordering"):
        # the ordering axis runs the composed engine x applier program; an
        # explicit conflicting --node is a config error
        node = opts.get("node")
        if node and str(node) != "tpu:ordered":
            raise ValueError(
                f"--ordering {opts['ordering']!r} selects the composed "
                f"program tpu:ordered; drop --node {node} (the engine "
                f"is the ordering axis, the applier is the workload)")
        opts["node"] = "tpu:ordered"
        # the engine and the applier are known before any store dir
        from .ordering import engine_program, get_applier
        engine_program(opts)
        get_applier(str(opts["workload"]), opts)
    nodes = parse_nodes(opts)
    opts["nodes"] = nodes
    if not opts.get("concurrency"):
        opts["concurrency"] = len(nodes)
    if opts.get("node") == "tpu:compartment" or (
            opts.get("ordering") == "compartment"):
        # the compartment's layout (and the JAX layout's refusals, word
        # for word) before any store dir
        from .nodes.compartment import Layout
        Layout(opts, len(nodes))
    name = opts.get("name") or str(opts["workload"])
    if opts["workload"] not in WORKLOADS:
        raise NotImplementedError(
            f"workload {opts['workload']!r} is ported with the other node "
            f"programs")
    workload = importlib.import_module(
        f"{__package__}.workloads.{WORKLOADS[opts['workload']]}"
    ).workload(opts)
    nemesis_pkg = nem.package(set(opts["nemesis"]),
                              interval_s=opts["nemesis_interval"])
    if opts.get("byz_attacks") is not None:
        # --byz-attacks: the byzantine package's attack pool
        from .byzantine import ATTACKS
        raw = opts["byz_attacks"]
        atks = tuple(s.strip() for s in str(raw).split(",")
                     if s.strip()) \
            if isinstance(raw, str) else tuple(raw)
        bad = [a for a in atks if a not in ATTACKS]
        if bad or not atks:
            raise ValueError(f"--byz-attacks: unknown attack(s) {bad}; "
                             f"expected any of {list(ATTACKS)}")
        opts["byz_attacks"] = atks

    # Generator composition (reference core.clj:58-71)
    rate = opts["rate"]
    if rate > 0:
        main = g.stagger(1.0 / rate, workload["generator"])
    else:
        main = g.sleep(opts["time_limit"])
    main = g.time_limit(opts["time_limit"],
                        g.nemesis_wrap(nemesis_pkg["generator"], main))
    # Final phases (reference core.clj:66-71): the nemesis heals every
    # fault type it injected; workloads with a final generator then get
    # their recovery window and final reads
    phase_list = [main]
    if nemesis_pkg["final_generator"] is not None:
        phase_list.append(g.nemesis_gen(nemesis_pkg["final_generator"]))
    if workload.get("final_generator") is not None:
        phase_list += [g.Log("Waiting for recovery..."),
                       g.sleep(opts.get("recovery_s", 10)),
                       g.clients(workload["final_generator"])]
    main = g.phases(*phase_list)

    checker = Compose({
        "perf": PerfChecker(),
        "timeline": TimelineChecker(),
        "exceptions": UnhandledExceptions(),
        "stats": Stats(),
        "net": None,        # the runner's device-counter net stats
        "workload": workload["checker"],
    })
    if "byzantine" in set(opts["nemesis"]):
        # the runner's device-evidence checker; Compose assembles the
        # `byzantine` results block from every checker's convictions
        checker.checkers["byzantine"] = None
    return {**opts, "name": name, "generator": main, "checker": checker,
            "nemesis_pkg": nemesis_pkg}


def run(opts: dict) -> dict:
    """Runs a complete test: build, drive, check, store. Returns the
    results map (with "valid")."""
    test = build_test(opts)
    node_spec = str(test.get("node") or "")
    if not node_spec.startswith("tpu:"):
        raise NotImplementedError(
            "external node binaries (--bin) run on the host network, "
            "which is not ported; use --node tpu:<program>")
    resolve_device(test.get("device") or "cuda")  # before the store dir
    test_dir = store.make_test_dir(test["store_root"], test["name"])
    test["store_dir"] = test_dir
    test["journal"] = Journal(dir=os.path.join(test_dir, "net-journal"))
    # persist the console log alongside the results (the reference's
    # jepsen.log, doc/results.md:17)
    log_handler = logging.FileHandler(os.path.join(test_dir, "run.log"))
    log_handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s [%(name)s] %(message)s"))
    logging.getLogger().addHandler(log_handler)
    try:
        from .runner.tpu_runner import run_tpu_test
        return run_tpu_test(test, test_dir)
    finally:
        logging.getLogger().removeHandler(log_handler)
        log_handler.close()
