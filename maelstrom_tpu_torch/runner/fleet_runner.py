"""Fleet execution: N independent test instances advancing in lockstep.

Counterpart of `maelstrom_tpu/runner/fleet_runner.py` (`FleetRunner`,
`_FleetClusterShell`, `run_fleet_test`) without the mesh. A campaign (a
seed, nemesis-schedule or capacity sweep, `core.FleetSpec`) is N
clusters: every leaf of one batched state (node state, flight pool, edge
channels, durable store, fault masks, keys) leads with the cluster axis
(`parallel.make_fleet_sims`, row i the standalone state of seed i), and
one fleet scan (`sim.make_fleet_scan_fn`) advances every cluster that
asks for rounds in one dispatch.

Each cluster is a full `TpuRunner` shell built from the options its
standalone run would use (`FleetSpec.cluster_opts`). The shells'
dispatch loops are the standalone `_loop_steps` coroutine; the fleet
answers their device requests in lockstep waves:

    quiet probes -> one probe of every cluster (K6's fleet form, [F]
                    flags)
    bumps        -> one batched round-counter add (0 holds a row)
    scans        -> one fleet scan; clusters between stretches are held
                    (K32), each live one appends to its own reply log
                    (K5's fleet form)

Every cluster's history is therefore byte-identical to its standalone
run with the same options: the fleet changes batching, never semantics.
Nemesis surgery rewrites one cluster's row of the fault leaves
(`apply_net_row`), and a crash-restart restores one cluster's masked
nodes (`restart_row`, a restore whose other rows are the identity).

The host side is the JAX package's vectorized host loop: one poll pass
a wave, one columnar session table for all shells (`ColumnarSessions`,
its wave pass K33 from 64 clusters on), the inject batch filled
numpy-columnar, and one packed fetch a dispatch for the whole fleet.

Refused, each naming the slice that brings it: a device mesh, continuous
mode and telemetry rings on the cluster axis, checkpoints, the overlap
pipeline, the byzantine adversary (in the JAX package's words), and
programs without a row step (kafka, the pool-path programs, the role
partitions, the batched broadcast)."""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from .. import core as core_mod
from .. import kernels as K
from .. import parallel
from .. import store
from ..checkers.netstats import TransferStats
from ..history import History
from ..net import tpu as T
from ..sim import make_fleet_scan_fn
from ..tree import tree_map
from .sessions import SESSION_MODES, ColumnarSessions
from .tpu_runner import TpuNetStats, TpuRunner, quiet_probe_fleet

log = logging.getLogger("maelstrom.fleet")

CHECKPOINT_SLICE = "checkpoint and resume"
OVERLAP_SLICE = "the overlap pipeline"


class _FleetClusterShell(TpuRunner):
    """One cluster of a fleet: a full TpuRunner whose device interactions
    go to its row of the fleet's batched state. Its `_loop_steps`
    coroutine is driven by the FleetRunner; the overrides cover every
    path that would touch a shell's own state."""

    def __init__(self, test: dict, fleet: "FleetRunner", idx: int):
        self.fleet = fleet
        self.idx = idx
        super().__init__(test)

    def _build_sim(self):
        # the fleet owns one batched state (row i == make_sim(seed_i))
        return None

    def _net_surgery(self, fn):
        self.fleet.apply_net_row(self.idx, fn)

    def restart_nodes(self, mask):
        self.fleet.restart_row(self.idx, mask)

    def _read_state(self, node_idx: int):
        return self.fleet.read_state(self.idx, node_idx)

    def _nodes_host(self):
        return self.fleet.nodes_host_row(self.idx)

    def _init_next_mid(self):
        self._next_mid = self.fleet.shell_next_mid(self.idx)


# the workloads a fleet runs, each on its program with a row step
FLEET_RUNS = {"broadcast": "tpu:broadcast", "lin-kv": "tpu:lin-kv"}


def check_fleet_scope(test: dict) -> None:
    """Refuses the fleet options this slice does not run, naming the
    slice that brings each: the byzantine adversary (a ValueError, in the
    JAX package's words), a mesh, continuous mode and telemetry rings,
    checkpoints, the overlap pipeline, and every program but broadcast
    and Raft lin-kv."""
    lead = "maelstrom_tpu_torch does not run it yet"
    if "byzantine" in TpuRunner._fault_set(test):
        raise ValueError(
            f"--fleet with --nemesis byzantine: {lead}; --nemesis "
            f"byzantine does not compose with --fleet yet: run the "
            f"adversary on a standalone cluster (--fleet 1)")
    node, workload = test.get("node"), test.get("workload")
    refusals = [
        (test.get("mesh"), "--mesh", parallel.MULTI_GPU_SLICE),
        (test.get("continuous"), "--continuous",
         parallel.FLEET_STREAM_SLICE),
        (test.get("telemetry") not in (None, "off"), "--telemetry",
         parallel.FLEET_STREAM_SLICE),
        (test.get("checkpoint_every") or test.get("resume"),
         "--checkpoint-every / --resume", CHECKPOINT_SLICE),
        ((test.get("check_workers") or 0) > 0, "--check-workers",
         OVERLAP_SLICE),
        (test.get("ordering") or FLEET_RUNS.get(workload) != node,
         f"-w {workload} --node {node}"
         + (f" --ordering {test['ordering']}" if test.get("ordering")
            else "") + " (its fleets run -w broadcast --node "
         "tpu:broadcast and -w lin-kv --node tpu:lin-kv)",
         parallel.FLEET_PROGRAMS_SLICE),
    ]
    for hit, what, slice_ in refusals:
        if hit:
            raise NotImplementedError(
                f"--fleet with {what}: {lead}; it comes with {slice_}")


class FleetRunner:
    """Drives `--fleet N`: N cluster shells in lockstep against one
    cluster-batched state, scanned, bumped and probed in single
    dispatches."""

    def __init__(self, test: dict):
        check_fleet_scope(test)
        self.test = test
        self.spec = core_mod.FleetSpec.from_test(test)
        F = self.spec.fleet
        self.shells: list[_FleetClusterShell] = []
        for i in range(F):
            t_i = core_mod.build_test(self.spec.cluster_opts(test, i))
            t_i["store_dir"] = test.get("store_dir")
            shell = _FleetClusterShell(t_i, fleet=self, idx=i)
            # the nemesis truthiness rewrite after construction, as
            # run_tpu_test orders it (programs size their edge rings from
            # the fault set)
            t_i["nemesis"] = (True if t_i["nemesis_pkg"]["generator"]
                              is not None else None)
            self.shells.append(shell)
        s0 = self.shells[0]
        self.program, self.cfg = s0.program, s0.cfg
        self.device = s0.device
        self.concurrency = s0.concurrency
        self.reply_log_cap = s0.reply_log_cap
        for sh in self.shells[1:]:
            # one program for every cluster: a sweep may not change the
            # static shapes
            if sh.cfg != s0.cfg:
                raise ValueError(
                    f"fleet clusters disagree on the network shape "
                    f"(cluster 0: {s0.cfg} vs cluster {sh.idx}: "
                    f"{sh.cfg}); sweeps may only vary seeds, schedules "
                    f"and rates")
        parallel.check_config(self.program, self.cfg)
        # row i is shell i's standalone initial state: its seed's key and
        # the loss probability and latency scale its _build_sim installs
        self.sim = parallel.make_fleet_sims(
            self.program, self.cfg,
            seeds=[sh.test.get("seed", 0) for sh in self.shells],
            device=self.device)
        net = self.sim.net
        if test.get("p_loss") is not None:
            net = net.replace(p_loss=torch.full_like(
                net.p_loss, float(test["p_loss"])))
        if test.get("latency_scale") is not None:
            net = net.replace(latency_scale=torch.full_like(
                net.latency_scale, float(test["latency_scale"])))
        self.sim = self.sim.replace(net=net)
        self.transfer = TransferStats()
        self._scan_fn = None
        self._pack = None
        self._rows: dict = {}            # host copies of clusters' nodes
        self._setup_mids = None
        self.final_rounds = [0] * F
        self.waves = 0
        self.passes = 0
        self.dispatches = 0
        self.quiet_probes = 0
        self.bumps = 0
        mode = test.get("sessions")
        mode = "columnar" if mode is None else str(mode)
        if mode not in SESSION_MODES:
            raise ValueError(f"--sessions {mode!r}: pick one of "
                             f"{'|'.join(SESSION_MODES)}")
        self.sessions_mode = mode
        self._session_table = None
        if mode == "columnar":
            # one [F, S] table for every shell, refreshed once a wave
            self._session_table = ColumnarSessions(
                F, self.concurrency, device=self.device)
            for i, sh in enumerate(self.shells):
                sh._fleet_sessions = (self._session_table, i)

    # --- device plumbing -------------------------------------------------

    def _invalidate(self):
        self._rows = {}

    def apply_net_row(self, i: int, fn):
        """Nemesis surgery on one cluster's row of the fault leaves: row i
        through the single-cluster fault API, written back into fresh
        copies of the leaves it changed (nothing changes in place)."""
        net = self.sim.net
        row = tree_map(lambda a: a[i], net)
        new = fn(row)

        def put(b, x_new, x_old):
            if x_new is x_old:
                return b
            b = b.clone()
            b[i] = x_new
            return b
        self.sim = self.sim.replace(net=tree_map(put, net, new, row))
        self._invalidate()

    def restart_row(self, i: int, mask):
        """Crash-restart for one cluster: the restore runs over the whole
        fleet with a mask False everywhere but row i (a False row is the
        identity)."""
        prog, sim = self.program, self.sim
        m = np.zeros((self.spec.fleet, self.cfg.n_nodes), bool)
        m[i] = np.asarray(mask, bool)
        m = torch.from_numpy(m).to(self.device)
        nodes = prog.restore(prog.init_state(), sim.durable, sim.nodes, m)
        self.sim = sim.replace(
            nodes=nodes, net=sim.net.replace(down=sim.net.down & ~m),
            durable=prog.durable_view(nodes))
        self._invalidate()

    def nodes_host_row(self, i: int):
        """Cluster i's node-state tree on the host, one drain of its row,
        cached until the next dispatch, surgery or restart."""
        if i not in self._rows:
            self._rows[i] = self.transfer.fetch(
                tree_map(lambda a: a[i], self.sim.nodes))
        return self._rows[i]

    def read_state(self, i: int, node_idx: int):
        return self.shells[i].program.state_row(self.nodes_host_row(i),
                                                node_idx)

    def shell_next_mid(self, i: int) -> int:
        if self._setup_mids is None:
            self._setup_mids = self.transfer.fetch(self.sim.net.next_mid)
        return int(self._setup_mids[i])

    def _probe_quiet(self) -> np.ndarray:
        """[F] quiescence flags in one probe (K6's fleet form) and one
        fetch; a program that is never quiescent (raft) launches
        nothing."""
        self.quiet_probes += 1
        F = self.spec.fleet
        if self.program.quiet_planes is None:
            return np.zeros(F, bool)
        sim = self.sim
        planes = [sim.net.pool.valid, sim.channels.valid]
        planes += self.program.quiet_planes(sim.nodes)
        return self.transfer.fetch(quiet_probe_fleet(planes))

    def _bump_rows(self, ks_by_idx: dict):
        ks = np.zeros(self.spec.fleet, np.int32)
        for i, k in ks_by_idx.items():
            ks[i] = k
        self.bumps += 1
        net = self.sim.net
        self.sim = self.sim.replace(net=net.replace(
            round=net.round + torch.from_numpy(ks).to(self.device)))
        self._invalidate()

    def _columnar_inject(self, fill, width: int) -> T.Msgs:
        """The fleet's [F, width] inject batch filled numpy-columnar
        (`fill(valid, src, dest, typ, a, b, c)` writes cluster rows into
        host buffers), then one copy a field to the device."""
        shape = (self.spec.fleet, width)
        cols = {"valid": np.zeros(shape, bool)}
        for f in ("src", "dest", "type", "a", "b", "c"):
            cols[f] = np.zeros(shape, np.int32)
        fill(cols["valid"], cols["src"], cols["dest"], cols["type"],
             cols["a"], cols["b"], cols["c"])
        inject = T.Msgs.empty(shape, self.device)
        return inject.replace(**{f: torch.from_numpy(v).to(self.device)
                                 for f, v in cols.items()})

    def _fetch_flag(self, t) -> int:
        return int(self.transfer.fetch(t))

    def _exec_fleet_scan(self, reqs: dict) -> dict:
        """One fleet-scan dispatch covering every cluster with a pending
        scan request; the rest are held. Returns {cluster: (k_executed,
        replies)}."""
        t0 = time.perf_counter()
        F = self.spec.fleet
        N, C = self.cfg.n_nodes, max(self.concurrency, 1)
        kmax = np.ones(F, np.int32)
        stop = np.ones(F, bool)
        active = np.zeros(F, bool)

        def fill(valid, src, dest, typ, a, b, c):
            for i, req in reqs.items():
                inject_rows, k_max, st, _r = req
                kmax[i], stop[i], active[i] = k_max, st, True
                m = len(inject_rows)
                if not m:
                    continue
                cols = np.asarray(
                    [(p, ni, t, aa, bb, cc) for (p, _o, ni, t, aa,
                                                 bb, cc) in inject_rows],
                    np.int64).T
                valid[i, :m] = True
                src[i, :m] = cols[0] + N
                dest[i, :m] = cols[1]
                typ[i, :m] = cols[2]
                a[i, :m] = cols[3]
                b[i, :m] = cols[4]
                c[i, :m] = cols[5]

        inject = self._columnar_inject(fill, C)
        if self._scan_fn is None:
            self._scan_fn = make_fleet_scan_fn(
                self.program, self.cfg, reply_cap=self.reply_log_cap,
                device=self.device, fetch=self._fetch_flag)
        self.transfer.host_poll_s += time.perf_counter() - t0
        self.sim, _cm, k, rl = self._scan_fn(self.sim, inject, kmax, stop,
                                             active)
        self.dispatches += 1
        self._invalidate()
        tree = (rl, k, self.sim.net.next_mid)
        if self._pack is None:
            self._pack = TpuRunner._make_packer(tree)
        pack, unpack = self._pack
        # one fetched array for the whole fleet a wave
        (rlog, rounds, plog, rn), k, next_mid = unpack(
            self.transfer.fetch(pack(tree)))
        out = {}
        for i in sorted(reqs):
            sh = self.shells[i]
            sh._next_mid = int(next_mid[i])
            row_log = tree_map(lambda a, i=i: a[i], rlog)
            out[i] = (int(k[i]), sh._decode_replies(
                row_log, rounds[i], None if plog is None else plog[i],
                int(rn[i])))
        return out

    # --- the wave scheduler ----------------------------------------------

    def run(self) -> list[History]:
        """Runs the whole fleet to completion; returns one History a
        cluster (index-aligned with the shells)."""
        F = self.spec.fleet
        self._setup_mids = None
        steps: list = [None] * F
        states: list = [None] * F
        for i, sh in enumerate(self.shells):
            states[i] = sh._setup_run()
            steps[i] = sh._loop_steps(**states[i])
        self._waves(steps)
        histories = []
        for i, sh in enumerate(self.shells):
            sh.final_round = self.final_rounds[i]
            histories.append(states[i]["history"])
        log.info("fleet run finished: %d clusters, rounds %d..%d, %d "
                 "history ops total, %d waves, %d host drains (%d bytes)",
                 F, min(self.final_rounds), max(self.final_rounds),
                 sum(len(h) for h in histories), self.waves,
                 self.transfer.drains, self.transfer.host_bytes)
        return histories

    def _waves(self, steps):
        """Advances every live cluster's coroutine to its next scan
        request (answering quiet probes and bumps in batched sub-waves),
        then answers all scans with one fleet-scan dispatch. Repeats
        until the whole fleet is done."""
        F = self.spec.fleet
        ready = [(i, None) for i in range(F)]
        while True:
            scan_reqs: dict = {}
            # one host poll pass a wave: one refresh of the shared session
            # table, then every ready cluster's coroutine
            poll_t0 = time.perf_counter()
            self.passes += 1
            if self._session_table is not None:
                self._session_table.encode_wave()
            while ready:
                quiet_wait, bump_wait = [], {}
                for i, resp in ready:
                    try:
                        req = steps[i].send(resp)
                    except StopIteration as e:
                        self.final_rounds[i] = e.value
                        continue
                    kind = req[0]
                    if kind == "quiet":
                        quiet_wait.append(i)
                    elif kind == "bump":
                        bump_wait[i] = req[1]
                    else:
                        scan_reqs[i] = req[1:]
                ready = []
                if bump_wait:
                    self._bump_rows(bump_wait)
                    ready += [(i, None) for i in sorted(bump_wait)]
                if quiet_wait:
                    qs = self._probe_quiet()
                    ready += [(i, bool(qs[i])) for i in sorted(quiet_wait)]
            if scan_reqs:
                self.transfer.record_poll(time.perf_counter() - poll_t0)
                self.waves += 1
                results = self._exec_fleet_scan(scan_reqs)
                ready += [(i, results[i]) for i in sorted(scan_reqs)]
            if not ready:
                return

    def timing(self) -> dict:
        """The fleet's own counters (timing.json in the store dir): waves
        (poll passes that dispatch a scan) and poll passes, dispatches, the
        fleet scan's lockstep rounds and host syncs, the bytes a held lane
        copies a round, probes and bumps."""
        scan = self._scan_fn
        return {"fleet": self.spec.fleet, "waves": self.waves,
                "poll-passes": self.passes, "dispatches": self.dispatches,
                "scan-rounds": 0 if scan is None else scan.rounds,
                "scan-host-syncs": 0 if scan is None else scan.host_syncs,
                "hold-row-bytes": 0 if scan is None else scan.row_bytes,
                "lane-rounds": int(sum(self.final_rounds)),
                "quiet-probes": self.quiet_probes, "bumps": self.bumps,
                "session-device-waves": (
                    0 if self._session_table is None
                    else self._session_table.device_waves)}


def run_fleet_test(test: dict, test_dir: str) -> dict:
    """Executes a `--fleet N` test end to end: run the fleet, check every
    cluster with its own checker tree, store each cluster's history and
    results under `cluster-XXXX/`, and write the fleet's results, merged
    history and timing.json. Routed from `run_tpu_test`."""
    t0 = time.perf_counter()
    test["store_dir"] = test_dir
    # the fleet re-derives each cluster's options from the original ones
    # (FleetSpec.cluster_opts), so the runner is built before the nemesis
    # truthiness rewrite
    runner = FleetRunner(test)
    test["nemesis"] = (True if test["nemesis_pkg"]["generator"] is not None
                       else None)
    histories = runner.run()
    t_run = time.perf_counter()
    F = runner.spec.fleet
    cluster_results = []
    all_valid = True
    from ..checkers.availability import AvailabilityChecker
    for i, sh in enumerate(runner.shells):
        # the shell's row back: the per-cluster checkers (device counters,
        # invalid-state counters) read runner.sim
        sh.sim = tree_map(lambda a, i=i: a[i], runner.sim)
        t_i = sh.test
        cdir = os.path.join(test_dir, f"cluster-{i:04d}")
        os.makedirs(cdir, exist_ok=True)
        t_i["store_dir"] = cdir
        t_i["checker"].checkers["net"] = TpuNetStats(sh)
        t_i["checker"].checkers["availability"] = AvailabilityChecker(sh)
        res_i = t_i["checker"].check(t_i, histories[i], {})
        res_i["cluster"] = i
        res_i["seed"] = t_i.get("seed")
        if runner.spec.sweep == "nemesis":
            res_i["nemesis-seed"] = t_i.get("nemesis_seed")
        if runner.spec.sweep == "capacity":
            res_i["rate"] = t_i.get("rate")
        store.write_history(cdir, histories[i])
        store.write_results(cdir, res_i)
        all_valid = all_valid and bool(res_i.get("valid"))
        cluster_results.append(res_i)
    results = {
        "fleet": F,
        "fleet-sweep": runner.spec.sweep,
        "mesh": None,
        "continuous": False,
        "sessions": runner.sessions_mode,
        "valid": all_valid,
        "clusters": cluster_results,
        "final-rounds": list(runner.final_rounds),
        **runner.transfer.as_dict(),
    }
    store.write_history(test_dir, histories[0] if F == 1 else
                        _merged_history(histories))
    store.write_results(test_dir, results)
    from ..core import DEFAULTS
    store.write_test(test_dir, {k: str(test[k]) for k in DEFAULTS
                                if k in test})
    timing = runner.timing()
    timing.update({"run-s": t_run - t0,
                   "check-store-s": time.perf_counter() - t_run,
                   "drains": runner.transfer.drains,
                   "kernel-launches": {k: v for k, v in
                                       K.launch_counts().items() if v}})
    with open(os.path.join(test_dir, "timing.json"), "w") as f:
        json.dump(timing, f, indent=2)
    store.mark_complete(test_dir)
    log.info("Fleet results valid? %s (%d clusters, store: %s)",
             results["valid"], F, test_dir)
    return results


def _merged_history(histories) -> History:
    """The fleet-level history for the store dir: every cluster's ops
    concatenated with the process tagged `c<cluster>:<process>`.
    Checking always runs per cluster."""
    merged = History()
    for i, h in enumerate(histories):
        for o in h:
            merged.append_row(o.type, o.f, o.value, f"c{i}:{o.process}",
                              o.time, o.error, o.final)
    return merged
