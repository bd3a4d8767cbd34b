"""The single-cluster test runner: a virtual-time lockstep generator
interpreter over the port's simulation.

Counterpart of `maelstrom_tpu/runner/tpu_runner.py` (`TpuRunner`,
`run_tpu_test`) for one cluster and the round-synchronous loop: each
iteration polls the (pure, virtual-time) generators for client ops,
encodes them into the injection batch, runs one scan-ahead dispatch
(`sim.make_scan_fn`) to the next host-relevant round, decodes the client
replies its device-resident log collected into history completions, and
applies timeouts. A program may route an op to a node of its choosing
(`node_for_op`), and its completions may read node state at the host
(`_read_state`: one drain of the node state, cached until the next
dispatch, restart or fault surgery). Nemesis ops run at stretch
boundaries: they rewrite the network's fault masks and scalars between
dispatches (`TpuCombinedNemesis`). Quiescent stretches (empty flight
pool, drained edge channels, idle node program: the fused probe K6) are
fast-forwarded in one round-counter bump.

Time is virtual: 1 round = `ms_per_round` milliseconds (default 1), so
the same generators and checkers read it as the JAX package's runner
does, and a seed fixes the history byte for byte.

Continuous mode (`continuous`, `_loop_steps_continuous`) pre-schedules
the generator's client ops onto their offered-rate rounds and injects
them inside one scan window (the sched-inject scan, kernel K18), so
traffic lands while the faults installed at the window's start are
live. The flight recorder (`telemetry`) folds a metric ring into every
round (kernel K19), drained on each dispatch's packed fetch, and writes
phase spans and a per-window record through a `TelemetrySession`.

Role-targeted faults (`--nemesis-targets`) resolve against the
program's `fault_groups` (a role partition's role ranges) and literal
node names; the dynamic group "sequencer" resolves to the elected
compartment's live leader when the fault fires.

A leader redirect (error 31 with a hint, from a sequencer that does not
lead) re-issues the same op, in its open invoke window, to the hinted
node after a seeded exponential backoff in rounds (`_backoff_rounds`),
up to `--client-retries` hops (16 when unset); programs with a
client-side routing lease see the round at each boundary
(`observe_round`), every reply (`note_reply`) and every timeout
(`note_timeout`).

Under `--nemesis byzantine` the nemesis installs each drawn attack plan
in the adversary's carry (`_byz_surgery`, at a dispatch boundary as kill
and pause land), `TpuByzantine` reads the program's evidence, and the
injection ledger is read once at the end into `test["byz_injected"]`.

A fleet (`--fleet N`, `runner/fleet_runner.py`) drives N of these
runners as shells: the hooks `_build_sim`, `_net_surgery`,
`restart_nodes`, `_read_state`, `_nodes_host`, `_init_next_mid` and the
`_fleet_sessions` seat point a shell at its row of the fleet's batched
state and session table, and its `_loop_steps` coroutine is the one a
standalone run drives.

Not ported here (their options are refused by the CLI, naming the slice
that brings each): checkpoint/resume and preemption, the overlapped
analysis pipeline, meshes, and the static-audit and cost blocks of the
results."""

from __future__ import annotations

import json
import logging
import math
import os
import time

import numpy as np
import torch

from .. import byzantine as BZ
from .. import generators as g
from .. import kernels as K
from .. import store
from .. import telemetry as TM
from ..checkers import Checker
from ..checkers.netstats import TransferStats
from ..errors import ERROR_REGISTRY
from ..history import History
from ..nemesis import NemesisDecisions, grudge_matrix, resolve_targets
from ..net import tpu as T
from ..nodes import HOST, EncodeCapacityError, Intern, get_program, \
    wire_name_table
from ..sim import make_scan_fn, make_sim
from ..tree import leaves, resolve_device, tree_map
from .sessions import make_sessions

log = logging.getLogger("maelstrom.tpu")


# --- the fused quiescence probe (K6) -----------------------------------------

def quiet_probe_plain(planes) -> torch.Tensor:
    """True (a device bool) when no byte of any bool plane is set: the
    JAX runner's `_quiet` reduction over the flight pool's valid, the
    channels' valid and the program's `quiet_planes`."""
    busy = torch.zeros((), dtype=torch.bool, device=planes[0].device)
    for p in planes:
        busy = busy | p.any()
    return ~busy


def quiet_probe(planes) -> torch.Tensor:
    """The runner's fused quiescence probe (see `quiet_probe_plain`); the
    kernel is K6 `quiet_probe` in `csrc/scan.cu`: one launch over every
    plane."""
    if not K.use_kernel(planes[0]):
        return quiet_probe_plain(planes)
    dev = planes[0].device
    for p in planes:
        if p.dtype != torch.bool or p.device != dev:
            raise ValueError(f"quiet_probe: planes must be bool on {dev}")
    quiet = torch.ones((), dtype=torch.bool, device=dev)
    flat = [p.contiguous() for p in planes]
    K.QUIET_PROBE.launch(flat + [quiet], [p.numel() for p in flat], dev)
    return quiet


def quiet_probe_fleet_plain(planes) -> torch.Tensor:
    """bool [F]: True where no byte of cluster f's row of any F-led bool
    plane is set (the JAX fleet's vmapped `_quiet`)."""
    F = planes[0].shape[0]
    busy = torch.zeros(F, dtype=torch.bool, device=planes[0].device)
    for p in planes:
        busy = busy | p.reshape(F, -1).any(dim=1)
    return ~busy


def quiet_probe_fleet(planes) -> torch.Tensor:
    """The fleet's quiescence probe, one flag a cluster (see
    `quiet_probe_fleet_plain`); the kernel is K6's fleet form
    `quiet_probe_fleet` in `csrc/fleet.cu`: one launch over every plane,
    one block a cluster."""
    if not K.use_kernel(planes[0]):
        return quiet_probe_fleet_plain(planes)
    dev = planes[0].device
    F = planes[0].shape[0]
    for p in planes:
        if p.dtype != torch.bool or p.device != dev or p.shape[0] != F:
            raise ValueError(f"quiet_probe_fleet: planes must be bool [F, "
                             f"...] on {dev}")
    flat = [p.contiguous() for p in planes]
    quiet = torch.empty(F, dtype=torch.bool, device=dev)
    K.QUIET_PROBE_FLEET.launch(flat + [quiet],
                               [F] + [p.numel() // max(F, 1) for p in flat],
                               dev)
    return quiet


# the scan's own counters, by their names in timing.json
SCAN_COUNTS = ("scan-host-syncs", "scan-replayed-rounds",
               "scan-rolled-back-rounds")


def _scan_counts(scan) -> tuple:
    return scan.host_syncs, scan.replayed, scan.rolled_back


def _np_dtype(dt: torch.dtype):
    return torch.empty(0, dtype=dt).numpy().dtype


class TpuCombinedNemesis(NemesisDecisions):
    """Applies the combined fault packages to the simulated network's
    masks (the JAX runner's executor of the same name): partitions
    install directional block matrices, kill and pause set the per-node
    down and paused masks, duplicate sets the duplication probability,
    weather the loss probability and latency scale, stop-kill restarts
    killed nodes from the durable store (`NodeProgram.restore`), and
    start-byzantine installs a drawn attack plan in the adversary's
    carry (stop-byzantine turns injection off). Decisions come from the
    seeded streams of `NemesisDecisions`, so a seed gives the JAX
    runner's fault schedule, op for op."""

    def __init__(self, runner, nodes, seed=0, targets=None, attacks=None,
                 byz_rate=1.0):
        super().__init__(nodes, seed, targets=targets, attacks=attacks)
        self.runner = runner
        self.byz_rate = float(byz_rate)
        self.killed: list = []
        self.paused_nodes: list = []
        self._idx = {n: i for i, n in enumerate(self.nodes)}

    def _mask(self, targets):
        m = np.zeros(len(self.nodes), bool)
        for t in targets:
            m[self._idx[t]] = True
        return m

    def invoke(self, op):
        f = op["f"]
        r = self.runner
        if f == "start-partition":
            name, grudge = self.next_grudge()
            groups, matrix = grudge_matrix(self.nodes, grudge)
            r._net_surgery(
                lambda net: T.partition_grudge(net, groups, matrix))
            return {**op, "type": "info", "value": name}
        if f == "stop-partition":
            r._net_surgery(T.heal)
            return {**op, "type": "info", "value": "healed"}
        if f == "start-kill":
            # a node both paused and killed is down until both lift
            targets = self.next_kill_targets()
            self.killed = sorted(set(self.killed) | set(targets))
            mask = self._mask(self.killed)
            r._net_surgery(lambda net: T.set_down(net, mask))
            return {**op, "type": "info", "value": f"killed {targets}"}
        if f == "stop-kill":
            restarted, self.killed = self.killed, []
            r.restart_nodes(self._mask(restarted))
            return {**op, "type": "info",
                    "value": f"restarted {restarted}"}
        if f == "start-pause":
            targets = self.next_pause_targets()
            self.paused_nodes = sorted(set(self.paused_nodes)
                                       | set(targets))
            mask = self._mask(self.paused_nodes)
            r._net_surgery(lambda net: T.set_paused(net, mask))
            return {**op, "type": "info", "value": f"paused {targets}"}
        if f == "stop-pause":
            resumed, self.paused_nodes = self.paused_nodes, []
            mask = self._mask([])
            r._net_surgery(lambda net: T.set_paused(net, mask))
            return {**op, "type": "info", "value": f"resumed {resumed}"}
        if f == "start-duplicate":
            p = self.next_dup_prob()
            r._net_surgery(lambda net: T.set_duplication(net, p))
            return {**op, "type": "info", "value": f"duplicate p={p}"}
        if f == "stop-duplicate":
            r._net_surgery(lambda net: T.set_duplication(net, 0.0))
            return {**op, "type": "info", "value": "duplicate off"}
        if f == "start-weather":
            name, p, scale = self.next_weather()
            r._net_surgery(lambda net: T.set_weather(net, p, scale))
            return {**op, "type": "info",
                    "value": f"weather {name} p_loss={p} scale={scale}"}
        if f == "stop-weather":
            # the run's configured baseline, so the final heal leaves the
            # network the test asked for
            base_p = float(r.test.get("p_loss") or 0.0)
            base_s = float(r.test.get("latency_scale") or 1.0)
            r._net_surgery(lambda net: T.set_weather(net, base_p, base_s))
            return {**op, "type": "info", "value": "weather cleared"}
        if f == "start-byzantine":
            attack, culprit, delta = self.next_byz_plan()
            ci, rate = self._idx[culprit], self.byz_rate
            r._byz_surgery(
                lambda byz: BZ.start_state(byz, attack, ci, delta, rate))
            return {**op, "type": "info",
                    "value": f"byzantine {attack} culprit={culprit}"}
        if f == "stop-byzantine":
            r._byz_surgery(BZ.stop_state)
            return {**op, "type": "info", "value": "byzantine cleared"}
        raise ValueError(f"unknown nemesis op {f!r}")


class TpuNetStats(Checker):
    """Net statistics from the on-device counters, shaped like the journal
    fold output (`net/checker.clj:28-41`). Unique msg-count equals the send
    count because the simulated network assigns globally unique ids."""

    name = "net"

    def __init__(self, runner):
        self.runner = runner

    def check(self, test, history, opts=None):
        c = T.stats_dict(self.runner.sim.net, transfer=self.runner.transfer)
        op_count = sum(1 for o in history
                       if o.type == "invoke" and o.process != "nemesis")
        groups = {
            "all": {"send-count": c["sent_all"], "recv-count": c["recv_all"],
                    "msg-count": c["sent_all"]},
            "servers": {"send-count": c["sent_servers"],
                        "recv-count": c["recv_servers"],
                        "msg-count": c["sent_servers"]},
            "clients": {
                "send-count": c["sent_all"] - c["sent_servers"],
                "recv-count": c["recv_all"] - c["recv_servers"],
                "msg-count": c["sent_all"] - c["sent_servers"]},
        }
        if op_count:
            groups["all"]["msgs-per-op"] = (
                groups["all"]["msg-count"] / op_count)
            groups["servers"]["msgs-per-op"] = (
                groups["servers"]["msg-count"] / op_count)
        out = dict(groups)
        if self.runner.cfg.unit_words:
            # client-op units transported beside the raw message counts
            out["sent-units"] = c["sent_units"]
            out["recv-units"] = c["recv_units"]
            if c["recv_all"]:
                out["units-per-msg"] = round(
                    c["recv_units"] / c["recv_all"], 3)
        out["lost"] = c["lost"]
        out["dropped-partition"] = c["dropped_partition"]
        out["dropped-overflow"] = c["dropped_overflow"]
        out["dropped-down"] = c["dropped_down"]
        out["duplicated"] = c["duplicated"]
        # per-RPC-type send breakdown; wire codes name themselves through
        # the program module's T_* constants
        by_type = c.get("sent_by_type") or {}
        if by_type:
            import sys
            mod = sys.modules.get(type(self.runner.program).__module__)
            names = wire_name_table(mod)
            out["send-count-by-type"] = {
                names.get(t, f"type-{t}"): n
                for t, n in sorted(by_type.items())}
        ch = self.runner.sim.channels
        overwrites = 0
        lat_clipped = 0
        if ch is not None:
            overwrites = int(ch.overwrites)
            out["channel-overwrites"] = overwrites
            lat_clipped = int(ch.lat_clipped)
            out["latency-clipped"] = lat_clipped
        # silently destroyed messages invalidate the run: pool overflow
        # always; ring overwrites are a bounded-channel drop of the same
        # class (legal only if the program retransmits or the test opts
        # in), clipped latency draws a distortion of the latency model
        # (gated unless the test or the program accepts it)
        prog = self.runner.program
        tolerated = (test.get("allow_channel_overwrites")
                     or getattr(prog, "tolerates_channel_overwrites",
                                False))
        clip_tolerated = (test.get("allow_latency_clipping")
                          or getattr(prog, "tolerates_latency_clipping",
                                     False))
        ok = (c["dropped_overflow"] == 0
              and (overwrites == 0 or tolerated)
              and (lat_clipped == 0 or clip_tolerated))
        # program-state capacity failures (raft's log-overflow) are the
        # same class of silent degradation as pool overflow
        for name, arr in prog.invalid_counters(
                self.runner.sim.nodes).items():
            n_bad = int(arr.sum())
            out[name] = n_bad
            ok = ok and n_bad == 0
        # the flight recorder's ring beside the counters it refines (off
        # by default: results keep their shape)
        ring = self.runner._ring_dict()
        if ring is not None:
            out["telemetry"] = ring
        # host-transfer accounting: drains must stay O(host-relevant
        # rounds), not O(simulated rounds)
        out.update(self.runner.transfer.as_dict())
        journal = self.runner.journal
        if journal is not None:
            out["journal"] = journal.counts()
        out["valid"] = bool(ok)
        return out


class TpuRunner:
    def __init__(self, test: dict):
        self.test = test
        nodes = test["nodes"]
        self.nodes = nodes
        self.device = resolve_device(test.get("device") or "cuda")
        spec = str(test["node"]).split(":", 1)[1]   # "tpu:<program>"
        self.concurrency = int(test.get("concurrency") or len(nodes))
        self.ms_per_round = float(test.get("ms_per_round", 1.0))
        test.setdefault("ms_per_round", self.ms_per_round)
        self.program = get_program(spec, test, nodes, device=self.device)
        # scans cross whole reply-bearing stretches, so a completion that
        # reads node state at the host reads it at the stretch's end: sound
        # only where the reads are final (kafka's append-only logs, sliced
        # to the reply-round lengths) or the reply carries its payload
        crossing_ok = (not self.program.needs_state_reads
                       or getattr(self.program, "state_reads_final", False)
                       or getattr(self.program, "reply_payload_words", 0))
        # continuous mode: client ops are pre-scheduled onto their
        # offered-rate rounds and injected inside the scan window
        self.continuous = bool(test.get("continuous"))
        if self.continuous and not (crossing_ok and test.get(
                "collect_replies", True)):
            # the window crosses reply-bearing stretches by construction
            raise ValueError(
                f"--continuous: program {self.program.name!r} cannot "
                f"cross reply-bearing stretches (needs_state_reads "
                f"without state_reads_final or a reply payload); run it "
                f"round-synchronous")
        if not crossing_ok:
            raise NotImplementedError(
                f"{self.program.name}: completions that read node state "
                f"at the reply's own round come with the other node "
                f"programs")
        lat = test.get("latency") or {}
        mean_rounds = float(lat.get("mean", 0)) / self.ms_per_round
        n = len(nodes)
        if getattr(self.program, "is_edge", False):
            # edge programs route node<->node traffic over static
            # channels; the pool only ever holds in-flight client requests
            default_pool = max(8 * self.concurrency, 64)
        else:
            default_pool = max(4096, 4 * n * self.program.outbox_cap)
        pool_cap = int(test.get("pool_cap") or default_pool)
        # fault capabilities are static config: a run without a fault
        # package pays nothing for its round-path work
        faults = self._fault_set(test)
        self.faults = faults
        # the flight recorder: --telemetry turns on the metric ring (a
        # static config capability: off costs nothing); run_tpu_test
        # attaches the session
        self.telemetry_rings = TM.enabled(test)
        self.telemetry = None
        self._ring_host = None
        self.cfg = T.NetConfig(
            n_nodes=n, n_clients=self.concurrency, pool_cap=pool_cap,
            inbox_cap=self.program.inbox_cap,
            client_cap=max(2 * self.concurrency, 8),
            latency_mean_rounds=mean_rounds,
            latency_dist=lat.get("dist", "constant"),
            ms_per_round=self.ms_per_round,
            partition_groups=n if "partition" in faults else 1,
            enable_stall=bool({"kill", "pause"} & faults),
            enable_duplication="duplicate" in faults,
            enable_byz="byzantine" in faults,
            # batch rows (broadcast-batched) carry several client ops a
            # message: the net books units beside the message counts
            unit_words=tuple(getattr(self.program, "unit_words", ())
                             or ()),
            telemetry=self.telemetry_rings,
            telemetry_roles=(TM.role_bounds(self.program)
                             if self.telemetry_rings else ()))
        # per-message journal rows: on by default for small clusters,
        # where the per-round pull is cheap; large runs keep only the
        # on-device counters. Continuous windows keep only the counters:
        # the journaled scan is a per-round debugging aid
        self.journal_rows = bool(test.get("journal_rows", n <= 64)) \
            and not self.continuous
        self.journal = test.get("journal") if self.journal_rows else None
        self.sim = self._build_sim()
        # host-transfer accounting: every device->host read is booked
        self.transfer = TransferStats()
        self._scan_fn = None         # built lazily
        self._pack = None            # one packed fetch a dispatch
        self._state_cache = None     # host copy of the node state
        self.max_scan = int(test.get("max_scan", 65536))
        self.journal_scan_cap = int(test.get("journal_scan_cap", 256))
        self.reply_log_cap = int(test.get("reply_log_cap", 256))
        # the continuous window's length in rounds: windows cross
        # replies, and the stride bounds how long a freed worker waits
        # for the generator's next poll
        self.continuous_stride = max(1, int(
            float(test.get("continuous_window_ms", 250.0))
            / self.ms_per_round))
        self._cscan_fn = None        # the continuous scan, built lazily
        self._cpack = None           # its packed fetch
        self.intern = Intern()
        self.timeout_rounds = max(
            int(float(test.get("timeout_ms", 5000)) / self.ms_per_round), 10)
        self.node_names = list(nodes) + [f"c{i}"
                                         for i in range(self.concurrency)]
        self._dispatches = 0
        self.final_round = 0
        # the leader-redirect requeue's session table (built a run) and
        # its hop budget: client_retries 0, the default, means unset
        self._sessions = None
        self._redirect_budget = int(test.get("client_retries") or 0) or 16
        # wall seconds by phase of the run (timing.json in the store dir)
        self.nemesis = None
        self.timing = {"scan-s": 0.0, "drain-s": 0.0, "poll-s": 0.0,
                       "replies-s": 0.0, "journal-s": 0.0, "quiet-s": 0.0,
                       "nemesis-s": 0.0, "nemesis-ops": 0,
                       "rounds-executed": 0, "rounds-bumped": 0,
                       "dispatches": 0, "quiet-probes": 0, "bumps": 0,
                       "scan-host-syncs": 0, "scan-replayed-rounds": 0,
                       "scan-rolled-back-rounds": 0}

    def _build_sim(self):
        """This runner's initial simulation state: the seeded key, and
        --p-loss and --latency-scale installed as the JAX runner installs
        them (an explicit 0.0 too)."""
        sim = make_sim(self.program, self.cfg,
                       seed=self.test.get("seed", 0),
                       track_edge_send_round=self.journal_rows,
                       device=self.device)
        if self.test.get("p_loss") is not None:
            sim = sim.replace(
                net=T.flaky(sim.net, float(self.test["p_loss"])))
        if self.test.get("latency_scale") is not None:
            sim = sim.replace(net=T.set_latency_scale(
                sim.net, float(self.test["latency_scale"])))
        return sim

    @staticmethod
    def _fault_set(test: dict) -> set:
        """The nemesis fault packages this run can see (static config,
        known before the first round)."""
        pkg = test.get("nemesis_pkg") or {}
        faults = set(pkg.get("faults") or ())
        if not faults:
            nm = test.get("nemesis")
            if isinstance(nm, (set, frozenset, list, tuple)):
                faults = set(nm)
        return faults

    def _net_surgery(self, fn):
        """Applies a host-side fault update `net -> net'` (grudges,
        down and paused masks, duplication, weather) between dispatches."""
        self.sim = self.sim.replace(net=fn(self.sim.net))
        self._state_cache = None

    def _byz_surgery(self, fn):
        """Applies a host-side adversary update `byz -> byz'` (the start-
        and stop-byzantine plans) between dispatches. `fn` builds new
        scalar tensors: the carry is never changed in place, so a
        snapshot the scan holds keeps its values."""
        if self.sim.byz is None:
            raise ValueError(
                "byzantine nemesis op without enable_byz: the fault set "
                "is static compile capability (TpuRunner._fault_set)")
        self.sim = self.sim.replace(byz=fn(self.sim.byz))

    def restart_nodes(self, mask):
        """Crash-restart (stop-kill): masked nodes come back with their
        volatile state rebuilt from the durable store
        (`NodeProgram.restore`), and their down flag clears."""
        prog, sim = self.program, self.sim
        m = torch.as_tensor(np.asarray(mask, bool)).to(self.device)
        nodes = prog.restore(prog.init_state(), sim.durable, sim.nodes, m)
        self.sim = sim.replace(
            nodes=nodes, net=sim.net.replace(down=sim.net.down & ~m),
            durable=prog.durable_view(nodes))
        self._state_cache = None

    def _read_state(self, node_idx: int):
        """One node's state rows at the current round, copied out of the
        host copy of the node state (one drain, cached until the next
        dispatch, restart or fault surgery). A completion's `read_state`
        reads the replying node unless it names another (the ordering
        engines read replicas in turn)."""
        return self.program.state_row(self._nodes_host(), node_idx)

    def _nodes_host(self):
        """A host copy of the whole node-state tree at the current round
        (cached as `_read_state`'s)."""
        if self._state_cache is None:
            self._state_cache = self.transfer.fetch(self.sim.nodes)
        return self._state_cache

    def _resolve_dynamic_target(self, token: str) -> list:
        """Expands one dynamic nemesis target group against live cluster
        state (`NemesisDecisions._expand_pool`): "sequencer" is the
        program's elected leader (`current_leader_host`), the one group
        the JAX package defines."""
        if token == "sequencer":
            fn = getattr(self.program, "current_leader_host", None)
            if fn is None:
                raise ValueError(
                    f"program {self.program.name!r} has no movable "
                    f"sequencer to target")
            return [self.nodes[int(fn(self._nodes_host()))]]
        raise ValueError(f"unknown dynamic nemesis target {token!r}")

    # --- the flight recorder ---

    def _tel_span(self, name, t0, t1, args=None):
        """One phase span, when a telemetry session is attached."""
        if self.telemetry is not None:
            self.telemetry.span(name, t0, t1, args=args)

    def _ring_dict(self):
        """The ring as a plain dict: the copy the last dispatch's packed
        fetch brought (nothing runs a round after it), or None with the
        ring off. A run that never dispatched reads the ring once."""
        if not self.telemetry_rings:
            return None
        if self._ring_host is None:
            self._ring_host = self.transfer.fetch(self.sim.telemetry)
        return TM.ring_dict(self._ring_host,
                            role_labels=TM.role_names(self.program))

    def _tel_wave(self, history, r):
        """One telemetry.jsonl window record (no session: nothing)."""
        if self.telemetry is not None:
            self.telemetry.wave(
                history, r,
                ring=None if self._ring_host is None else self._ring_dict(),
                transfer=self.transfer)

    def _bump(self, k: int):
        """Fast-forward: round += k (a torch op on the round counter)."""
        self.sim = self.sim.replace(net=self.sim.net.replace(
            round=self.sim.net.round + k))

    def _time_ns(self, r: int) -> int:
        return int(r * self.ms_per_round * 1e6)

    def _backoff_rounds(self, process, attempt: int) -> int:
        """The leader-redirect requeue's seeded truncated-exponential
        backoff in rounds: full jitter under min(cap, base * 2^attempt)
        (`--client-backoff-ms`, `--client-backoff-cap-ms`), drawn from an
        md5 of (seed, process, attempt), so a seed fixes the schedule."""
        import hashlib

        from .sessions import trunc_exp_bound
        bo_ms = self.test.get("client_backoff_ms")
        cap_ms = self.test.get("client_backoff_cap_ms")
        base = max(1, int(float(50.0 if bo_ms is None else bo_ms)
                          / self.ms_per_round))
        cap = max(base, int(float(2000.0 if cap_ms is None else cap_ms)
                            / self.ms_per_round))
        bound = trunc_exp_bound(base, cap, attempt)
        h = int.from_bytes(hashlib.md5(
            f"{self.test.get('seed', 0)}:{process}:{attempt}"
            .encode()).digest()[:4], "big")
        return 1 + (h % bound)

    def _complete(self, history, gen, ctx, process, completed, free):
        history.append_row(completed.get("type", "info"),
                           completed.get("f"), completed.get("value"),
                           process, ctx["time"], completed.get("error"),
                           completed.get("final", False))
        free.add(process)
        # the op's redirect-retry chain (if any) ends with its window
        if self._sessions is not None:
            self._sessions.close_retry(process)
        return gen.update(ctx, completed)

    def _free_rotated(self, free):
        return g.rotate_free(free, self._dispatches)

    @staticmethod
    def _make_packer(example):
        """(pack, unpack) shipping a tree of bool/int32 tensors as ONE
        int32 array: one `torch.cat` on the device, one copy to the
        host. `unpack` rebuilds the tree as numpy arrays."""
        shapes = [(tuple(t.shape), _np_dtype(t.dtype))
                  for _p, t in leaves(example)]

        def pack(tree):
            return torch.cat([t.to(torch.int32).reshape(-1)
                              for _p, t in leaves(tree)])

        def unpack(flat: np.ndarray):
            it, off = iter(shapes), [0]

            def take(_t):
                shape, dt = next(it)
                n_el = int(np.prod(shape))
                out = flat[off[0]:off[0] + n_el].reshape(shape).astype(dt)
                off[0] += n_el
                return out
            return tree_map(take, example)
        return pack, unpack

    def _stop_on_reply(self, gen, ctx, sessions) -> bool:
        """True = the scan must EXIT at the first client reply; False =
        it may cross whole reply-bearing stretches. Crossing is safe iff
        a completion cannot move the generator's next emission earlier
        than the scan bound: a finite `next_interesting_time` means
        purely time-gated; +inf means only a completion can unblock.
        Worker starvation is checked directly as well. (Reply payloads
        are snapshotted at the reply's own round inside the scan, so
        crossing never skews a completion's value.)"""
        if not sessions:
            return False            # nothing in flight: no replies at all
        if not any(p != g.NEMESIS for p in ctx["free"]):
            return True             # starved: a completion enables emission
        return gen.next_interesting_time(ctx) == math.inf

    def _scan_bound(self, gen, ctx, sessions, r, max_rounds) -> int:
        """How many injection-free rounds may run in one dispatch without
        the host needing to look: bounded by the generator's next
        interesting time, the earliest RPC timeout deadline and
        max_rounds. Always >= 1."""
        ns_pr = self.ms_per_round * 1e6
        bound = r + self.max_scan
        nt = gen.next_interesting_time(ctx)
        if nt != math.inf:
            bound = min(bound, int(math.ceil(nt / ns_pr)))
        dl = sessions.min_deadline()
        if dl is not None:
            bound = min(bound, dl)
        due = sessions.requeue_min_due()
        if due is not None:
            # a redirect retry becomes injectable at its due round
            bound = min(bound, due)
        bound = min(bound, max_rounds)
        return max(bound - r, 1)

    # --- main loop ---

    def _setup_run(self) -> dict:
        """The host-side run state the dispatch loop consumes (the JAX
        runner's `_setup_run`): the generator, the nemesis executor, the
        worker bookkeeping, the session table and the history. Returns
        the keyword dict `_loop_steps` takes. Shared by `run` and the
        fleet, which calls it on every cluster shell."""
        test = self.test
        C = self.concurrency
        gen = g.to_gen(test["generator"])
        nem_seed = test.get("nemesis_seed")
        if nem_seed is None:
            nem_seed = test.get("seed", 0)
        # role-targeted faults (--nemesis-targets): group tokens resolve
        # against the program's fault groups plus literal node names;
        # dynamic groups stay symbolic and expand when the fault fires
        prog = self.program
        targets = resolve_targets(
            test.get("nemesis_targets"),
            getattr(prog, "fault_groups", lambda: {})(), self.nodes,
            dynamic=getattr(prog, "dynamic_fault_groups", lambda: ())())
        if (test.get("nemesis_pkg") or {}).get("generator") is not None:
            # not `or 1.0`: an explicit --byz-rate 0 sticks (detectors
            # armed on honest traffic)
            byz_rate = test.get("byz_rate")
            self.nemesis = TpuCombinedNemesis(
                self, self.nodes, nem_seed, targets=targets,
                attacks=test.get("byz_attacks"),
                byz_rate=1.0 if byz_rate is None else float(byz_rate))
            self.nemesis.resolve_dynamic = self._resolve_dynamic_target
        processes = list(range(C)) + ([g.NEMESIS] if self.nemesis else [])
        free = g.FreeSet(processes)
        for p in processes:
            free.add(p)
        # a fleet shell gets its view of the fleet's one columnar table;
        # a standalone run builds the backend --sessions names (the same
        # bytes either way)
        shared = getattr(self, "_fleet_sessions", None)
        if shared is not None:
            sessions = shared[0].view(shared[1])
        else:
            sessions = make_sessions(test, C, device=self.device)
        self._sessions = sessions
        history = History()
        max_rounds = int(test.get("max_rounds", 2_000_000))
        # host mirror of the device message-id counter (refreshed by
        # every dispatch's packed fetch)
        self._init_next_mid()
        return dict(gen=gen, processes=processes, free=free,
                    sessions=sessions, history=history,
                    max_rounds=max_rounds)

    def _init_next_mid(self):
        self._next_mid = int(self.transfer.fetch(self.sim.net.next_mid))

    def run(self) -> History:
        st = self._setup_run()
        loop = (self._loop_steps_continuous if self.continuous
                else self._loop_steps)
        r = self._drive(loop(**st))
        max_rounds = st["max_rounds"]
        history = st["history"]
        if r >= max_rounds:
            log.warning("runner hit max_rounds=%d", max_rounds)
        self.final_round = r
        log.info("run finished at virtual round %d (%.1f virtual s), "
                 "%d history ops, %d host drains (%d bytes, %.3fs "
                 "blocked)", r, r * self.ms_per_round / 1e3, len(history),
                 self.transfer.drains, self.transfer.host_bytes,
                 self.transfer.blocked_s)
        return history

    def _drive(self, steps) -> int:
        """Device driver for the `_loop_steps` coroutine: answers quiet
        probes, performs bumps on self.sim, and executes scan requests
        as single dispatches."""
        resp = None
        tm = self.timing
        while True:
            try:
                req = steps.send(resp)
            except StopIteration as e:
                return e.value
            kind = req[0]
            if kind == "scan":
                resp = self._exec_scan(*req[1:])
            elif kind == "cscan":
                resp = self._exec_cscan(*req[1:])
            elif kind == "bump":
                self._bump(req[1])
                tm["rounds-bumped"] += req[1]
                tm["bumps"] += 1
                resp = None
            else:                   # "quiet"
                t0 = time.perf_counter()
                resp = self._quiet()
                tm["quiet-s"] += time.perf_counter() - t0
                tm["quiet-probes"] += 1

    def _loop_steps(self, gen, processes, free, sessions, history,
                    max_rounds):
        """The host-side dispatch loop as a coroutine. Device interaction
        happens through three yielded request kinds: ``("quiet",) ->
        bool``, ``("bump", k) -> None`` and ``("scan", inject_rows,
        k_max, stop, r) -> (k_executed, replies)``. Returns the final
        virtual round."""
        program = self.program
        r = 0
        exhausted = False
        observe_round = getattr(program, "observe_round", None)
        while r < max_rounds:
            if observe_round is not None:
                # a routing lease reads the round before this boundary's
                # ops are routed
                observe_round(r)
            # one host poll pass per stretch boundary
            _poll_t0 = time.perf_counter()
            ctx = {"time": self._time_ns(r), "free": self._free_rotated(free),
                   "processes": processes}
            inject_rows = []
            while True:
                res, gen = gen.op(ctx)
                if res is None:
                    exhausted = True
                    break
                exhausted = False
                if res == g.PENDING:
                    break
                if res["process"] == g.NEMESIS:
                    # fault surgery between dispatches
                    gen = self._run_nemesis_op(gen, res, history, free,
                                               processes, r)
                    ctx = {"time": self._time_ns(r),
                           "free": self._free_rotated(free),
                           "processes": processes}
                    continue
                process = res["process"]
                self._dispatches += 1
                free.discard(process)
                op = {k: v for k, v in res.items() if k != "time"}
                history.append_row("invoke", op.get("f"), op.get("value"),
                                   process, ctx["time"],
                                   final=op.get("final", False))
                node_idx = self._route(op, process)
                body = program.request_for_op(op)
                try:
                    t, a, b, c = program.encode_body(body, self.intern)
                except EncodeCapacityError as e:
                    # encode-capacity exhaustion fails the op definitely
                    # instead of crashing the run
                    completed = {**op, "type": "fail",
                                 "error": ["encode-error", str(e)]}
                    gen = self._complete(history, gen, ctx, process,
                                         completed, free)
                else:
                    inject_rows.append((process, op, node_idx, t, a, b, c))
                ctx = {"time": self._time_ns(r),
                       "free": self._free_rotated(free),
                       "processes": processes}
            _poll_t1 = time.perf_counter()
            self.transfer.record_poll(_poll_t1 - _poll_t0)
            self._tel_span("schedule-encode", _poll_t0, _poll_t1)
            self.timing["poll-s"] += _poll_t1 - _poll_t0

            # leader-redirect retries whose backoff elapsed re-inject now
            # (their invoke windows are open: no new history rows)
            inject_rows += sessions.take_due_requeues(r)

            if exhausted and not sessions and not sessions.has_requeue() \
                    and len(free) == len(processes):
                break

            # fast-forward quiescent stretches (nothing in flight, nothing
            # to inject, program idle): jump straight to the generator's
            # next interesting round in ONE bump, never overshooting
            if not inject_rows and not sessions and (yield ("quiet",)):
                k = self._scan_bound(gen, ctx, sessions, r, max_rounds)
                yield ("bump", k)
                r += k
                continue

            if inject_rows:
                # next_mid is mirrored on the host (refreshed in every
                # dispatch's packed fetch)
                base_mid = self._next_mid
                for j, (p, o, ni, *_rest) in enumerate(inject_rows):
                    sessions.register(base_mid + j, p, o, ni,
                                      r + self.timeout_rounds)

            # one dispatch: this round's injections (possibly none) plus
            # the scan to the next host-relevant round, every reply
            # collected into the device log
            k_max = self._scan_bound(gen, ctx, sessions, r, max_rounds)
            stop = self._stop_on_reply(gen, ctx, sessions)
            k, replies = yield ("scan", inject_rows, k_max, stop, r)
            r += k
            t0 = time.perf_counter()
            ctx = {"time": self._time_ns(r), "free": self._free_rotated(free),
                   "processes": processes}

            # one table pass pops this wave's reply sessions (None =
            # stale), then each completion folds in
            entries = sessions.absorb_results([rep[5] for rep in replies])
            for rep, entry in zip(replies, entries):
                gen = self._apply_reply(program, gen, history, sessions,
                                        free, processes, rep, entry)

            # timeouts -> indefinite :info (client.clj:214-233); a
            # timed-out node may be a dead leader: the program may rotate
            # its routing guess
            nt = getattr(program, "note_timeout", None)
            for process, op, ni in sessions.take_expired(r):
                if nt is not None:
                    nt(ni)
                completed = {**op, "type": "info", "error": "net-timeout"}
                gen = self._complete(history, gen, ctx, process, completed,
                                     free)
            # one telemetry record a stretch, its replies folded in
            self._tel_wave(history, r)
            self.timing["replies-s"] += time.perf_counter() - t0
        return r

    def _route(self, op, process) -> int:
        """The node an op goes to: the worker's bound node, unless the
        program routes the op (smart-client routing: kafka sends go to
        the key's owner, commits and lists to the coordinator)."""
        N = self.cfg.n_nodes
        routed = self.program.node_for_op(op)
        if routed is None:
            return process % N
        node_idx = int(routed)
        if not 0 <= node_idx < N:
            raise ValueError(f"{self.program.name}.node_for_op returned "
                             f"{routed} for a {N}-node cluster")
        return node_idx

    def _run_nemesis_op(self, gen, nop, history, free, processes, r):
        """One nemesis op at round r: host-side fault surgery between
        dispatches (in continuous mode a window boundary: the scan
        cannot rewrite its own masks mid-flight)."""
        ctx = {"time": self._time_ns(r), "free": self._free_rotated(free),
               "processes": processes}
        process = nop["process"]
        self._dispatches += 1
        free.discard(process)
        op = {k: v for k, v in nop.items() if k != "time"}
        history.append_row("invoke", op.get("f"), op.get("value"),
                           process, self._time_ns(r),
                           final=op.get("final", False))
        t_n = time.perf_counter()
        completed = self.nemesis.invoke(op)
        self.timing["nemesis-s"] += time.perf_counter() - t_n
        self.timing["nemesis-ops"] += 1
        return self._complete(history, gen, ctx, process, completed, free)

    def _encode_events(self, evs, carry_sched, carry_host, history, gen,
                       free, processes):
        """Encodes pre-scheduled client ops into carry_sched rows (round,
        process, op, node_idx, t, a, b, c). Host-routed ops become window
        boundaries; an encode-capacity failure completes as a definite
        fail on the spot, as on the round-synchronous path."""
        program = self.program
        for rd, res in evs:
            op = {k: v for k, v in res.items() if k != "time"}
            process = res["process"]
            node_idx = self._route(op, process)
            body = program.request_for_op(op)
            if body is HOST:
                carry_host.append((rd, process, op, node_idx))
                continue
            try:
                t, a, b, c = program.encode_body(body, self.intern)
            except EncodeCapacityError as e:
                ctx = {"time": self._time_ns(rd),
                       "free": self._free_rotated(free),
                       "processes": processes}
                history.append_row("invoke", op.get("f"), op.get("value"),
                                   process, self._time_ns(rd),
                                   final=op.get("final", False))
                completed = {**op, "type": "fail",
                             "error": ["encode-error", str(e)]}
                gen = self._complete(history, gen, ctx, process, completed,
                                     free)
                continue
            carry_sched.append((rd, process, op, node_idx, t, a, b, c))
        return gen

    def _loop_steps_continuous(self, gen, processes, free, sessions,
                               history, max_rounds):
        """The continuous dispatch loop (the JAX runner's
        `_loop_steps_continuous`). At each window boundary the host
        pre-schedules the next stretch of client ops onto their rounds
        (`generators.schedule_ahead`) and one sched-inject scan lands
        them inside the window, while the faults installed at the
        boundary are live. Nemesis ops and host-routed ops stay window
        boundaries. Yields the `_loop_steps` request kinds plus
        ``("cscan", rows, k_max, stop, r) -> (k, replies, inj_mids)``.

        Scheduling reads only generator state and earlier windows'
        (deterministic) reply timing, so a seed fixes the history byte
        for byte. Rows a window did not reach carry with their rounds;
        an op enters the history once the drain's `inj_mids` confirms its
        injection."""
        program = self.program
        ns_pr = self.ms_per_round * 1e6
        carry_sched: list = []
        carry_nem = None
        carry_host: list = []
        r = 0
        observe_round = getattr(program, "observe_round", None)
        while r < max_rounds:
            if observe_round is not None:
                observe_round(r)
            # boundary work due now
            while carry_nem is not None and carry_nem[0] <= r:
                nop = carry_nem[1]
                carry_nem = None
                gen = self._run_nemesis_op(gen, nop, history, free,
                                           processes, r)
            while carry_host and carry_host[0][0] <= r:
                _rd, process, op, node_idx = carry_host.pop(0)
                ctx = {"time": self._time_ns(r),
                       "free": self._free_rotated(free),
                       "processes": processes}
                history.append_row("invoke", op.get("f"), op.get("value"),
                                   process, self._time_ns(r),
                                   final=op.get("final", False))
                completed = program.host_op(
                    op, lambda i=node_idx: self._read_state(i), self.intern)
                gen = self._complete(history, gen, ctx, process, completed,
                                     free)

            def horizon():
                h = min(r + self.max_scan, max_rounds)
                if carry_nem is not None:
                    h = min(h, carry_nem[0])
                if carry_host:
                    h = min(h, carry_host[0][0])
                return max(h, r + 1)

            # pre-schedule the window (one host poll pass): a nemesis op
            # due now runs at once and scheduling resumes with its fault
            # installed
            _poll_t0 = time.perf_counter()
            while True:
                gen, evs, nem, _end, end_kind = g.schedule_ahead(
                    gen, processes, free, r, horizon(), ns_pr,
                    self._dispatches)
                self._dispatches += len(evs)
                for _rd, res in evs:
                    free.discard(res["process"])
                gen = self._encode_events(evs, carry_sched, carry_host,
                                          history, gen, free, processes)
                if nem is not None and nem[0] <= r:
                    gen = self._run_nemesis_op(gen, nem[1], history, free,
                                               processes, r)
                    continue
                if nem is not None:
                    carry_nem = nem
                break
            exhausted = end_kind == "exhausted"
            # leader-redirect retries join the scheduled rows (their due
            # rounds clamp to this window's start)
            carry_sched += sessions.drain_requeues(r)
            # stable by round: carried rows precede same-round new ones
            carry_sched.sort(key=lambda rw: rw[0])
            _poll_t1 = time.perf_counter()
            self.transfer.record_poll(_poll_t1 - _poll_t0)
            self._tel_span("schedule-encode", _poll_t0, _poll_t1)
            self.timing["poll-s"] += _poll_t1 - _poll_t0

            if exhausted and not sessions and not carry_sched \
                    and carry_nem is None and not carry_host \
                    and len(free) == len(processes):
                break

            # fast-forward quiescent gaps before the first due row
            first_due = carry_sched[0][0] if carry_sched else None
            h = horizon()
            if not sessions and (first_due is None or first_due > r) \
                    and (yield ("quiet",)):
                target = h if first_due is None else min(first_due, h)
                k = max(target - r, 1)
                yield ("bump", k)
                r += k
                continue

            # one window, bounded by the stride, the horizon and every
            # timeout deadline (pending and scheduled); it crosses
            # replies, which fold in at its close
            k_abs = min(h, r + self.continuous_stride)
            dl = sessions.min_deadline()
            if dl is not None:
                k_abs = min(k_abs, dl)
            for rw in carry_sched:
                k_abs = min(k_abs, rw[0] + self.timeout_rounds)
            k_max = max(k_abs - r, 1)
            k, replies, inj_mids = yield ("cscan", carry_sched, k_max,
                                          False, r)
            t0 = time.perf_counter()

            injected = [(j, rw) for j, rw in enumerate(carry_sched)
                        if rw[0] - r < k]
            carry_sched = [rw for rw in carry_sched if rw[0] - r >= k]
            # confirmed injections and replies in time order, completions
            # first at equal rounds (a reply is stamped after its
            # injection's round, so registration precedes it)
            events = [(rw[0], 1, j, rw) for j, rw in injected]
            events += [(int(rep[0]), 0, i, rep)
                       for i, rep in enumerate(replies)]
            events.sort(key=lambda e: (e[0], e[1], e[2]))
            r += k
            for rd, kind, seq, item in events:
                if kind == 1:
                    _rd0, process, op, node_idx = item[:4]
                    mid = int(inj_mids[seq])
                    if mid < 0:
                        raise RuntimeError(
                            f"continuous scan executed {k} rounds but "
                            f"reported no mid for row {seq} at round {rd}")
                    if not sessions.retry_is_open(process):
                        # a redirect retry keeps its original invoke
                        history.append_row("invoke", op.get("f"),
                                           op.get("value"), process,
                                           self._time_ns(rd),
                                           final=op.get("final", False))
                    sessions.register(mid, process, op, node_idx,
                                      rd + self.timeout_rounds)
                else:
                    entry = sessions.absorb_results([int(item[5])])[0]
                    gen = self._apply_reply(program, gen, history,
                                            sessions, free, processes,
                                            item, entry)

            # timeouts -> indefinite :info (client.clj:214-233)
            ctx = {"time": self._time_ns(r), "free": self._free_rotated(free),
                   "processes": processes}
            nt = getattr(program, "note_timeout", None)
            for process, op, ni in sessions.take_expired(r):
                if nt is not None:
                    nt(ni)
                completed = {**op, "type": "info", "error": "net-timeout"}
                gen = self._complete(history, gen, ctx, process, completed,
                                     free)
            self._tel_wave(history, r)
            self.timing["replies-s"] += time.perf_counter() - t0
        return r

    def _apply_reply(self, program, gen, history, sessions, free,
                     processes, rep, entry):
        """Decodes one drained reply row — (round_stamp, type, a, b, c,
        reply_to, payload) — and folds its completion into the
        history and generator state, or requeues a redirected op.
        Returns the rebound generator."""
        stamp, t_, a_, b_, c_, _rt, payload = rep
        if entry is None:
            return gen              # stale reply (client.clj:167-168)
        process, op, node_idx, _dl = entry
        body = program.decode_body(t_, a_, b_, c_, self.intern)
        # any reply proves the contacted node alive (a routing lease)
        nr = getattr(program, "note_reply", None)
        if nr is not None:
            nr(node_idx, int(stamp))
        if body.get("type") == "error":
            # a leader redirect is definite (the op did not execute):
            # re-issue the same op, in its open invoke window, to the
            # hinted node under seeded backoff; an exhausted budget falls
            # through to the ordinary definite fail
            hint_fn = getattr(program, "redirect_hint", None)
            h = hint_fn(body) if hint_fn is not None else None
            attempt = sessions.attempt(process)
            if h is not None and attempt < self._redirect_budget:
                target = int(h)
                if not 0 <= target < self.cfg.n_nodes:
                    # no live leader known: probe the tier
                    target = int(program.next_probe(node_idx))
                note = getattr(program, "note_leader", None)
                if note is not None:
                    note(target)
                t2, a2, b2, c2 = program.encode_body(
                    program.request_for_op(op), self.intern)
                sessions.open_retry(process, attempt + 1)
                due = int(stamp) + self._backoff_rounds(process, attempt)
                sessions.requeue(due, process, op, target, t2, a2, b2, c2)
                return gen
            err = ERROR_REGISTRY.get(body.get("code"))
            definite = err.definite if err else False
            completed = {**op,
                         "type": "fail" if definite else "info",
                         "error": [err.name if err
                                   else body.get("code"),
                                   body.get("text")]}
        elif payload is not None:
            # state snapshotted at the reply round, on the device
            completed = program.completion_payload(
                op, body, payload, self.intern)
        else:
            completed = program.completion(
                op, body, lambda i=node_idx: self._read_state(i),
                self.intern)
        cctx = {"time": self._time_ns(stamp),
                "free": self._free_rotated(free), "processes": processes}
        return self._complete(history, gen, cctx, process, completed, free)

    def _encode_inject(self, inject_rows) -> T.Msgs:
        """Encodes this stretch's pending client ops into the [C] inject
        batch the scan takes (an all-invalid batch when there are
        none)."""
        C, N = max(self.concurrency, 1), self.cfg.n_nodes
        dev = self.device
        inject = T.Msgs.empty(C, dev)
        if not inject_rows:
            return inject
        M = len(inject_rows)
        proc, _, nidx, ts, as_, bs, cs = zip(*inject_rows)

        def col(xs):
            out = np.zeros(C, np.int32)
            out[:M] = xs
            return torch.from_numpy(out).to(dev)
        return inject.replace(
            valid=torch.arange(C, device=dev) < M,
            src=col(np.asarray(proc) + N), dest=col(nidx), type=col(ts),
            a=col(as_), b=col(bs), c=col(cs))

    def _fetch_flag(self, t) -> int:
        return int(self.transfer.fetch(t))

    def _exec_scan(self, inject_rows, k_max, stop, r):
        """One dispatch: encode the injections, run the scan
        (journal-collecting when journaling), drain the device-resident
        log (and journal buffer) as ONE packed fetch, and decode the
        reply rows. Returns (k_executed, replies), replies rows being
        (round_stamp, type, a, b, c, reply_to, payload)."""
        tm = self.timing
        program, cfg = self.program, self.cfg
        inject = self._encode_inject(inject_rows)
        journaled = self.journal is not None
        if self._scan_fn is None:
            self._scan_fn = make_scan_fn(
                program, cfg, reply_cap=self.reply_log_cap,
                journal_cap=self.journal_scan_cap if journaled else None,
                device=self.device, fetch=self._fetch_flag,
                first_chunk=None if getattr(program, "is_edge", False)
                else 1)
        scan = self._scan_fn
        before = _scan_counts(scan)
        t0 = time.perf_counter()
        out = scan(self.sim, inject, k_max, stop)
        self.sim, k, rl = out[0], out[2], out[3]
        self._state_cache = None
        buf = out[4] if journaled else ()
        # ONE fetched array a dispatch: next_mid and the metric ring (an
        # empty tuple with the ring off) ride the packed buffer
        tree = (buf, rl, self.sim.net.next_mid, self._ring_tree())
        if self._pack is None:
            self._pack = self._make_packer(tree)
        pack, unpack = self._pack
        packed = pack(tree)
        t1 = time.perf_counter()
        self._tel_span("dispatch", t0, t1)
        flat = self.transfer.fetch(packed)
        t2 = time.perf_counter()
        self._tel_span("device-get", t1, t2,
                       args={"drains": self.transfer.drains,
                             "host-bytes": self.transfer.host_bytes})
        buf, (rlog, rounds, plog, rn), next_mid, ring = unpack(flat)
        self._next_mid = int(next_mid)
        if self.telemetry_rings:
            self._ring_host = ring
        rn = int(rn)
        self._book_scan(scan, t0, t1, t2, k, before)
        if journaled:
            t3 = time.perf_counter()
            for i in range(k):
                self._journal_round(tree_map(lambda b, i=i: b[i], buf),
                                    r + i)
            if rn:
                # reply recv rows at their true rounds (stamps are
                # post-round: the producing round is stamp-1)
                self.journal.log_batch(
                    "recv", rlog.mid[:rn],
                    np.asarray([self._time_ns(int(s) - 1)
                                for s in rounds[:rn]]),
                    rlog.src[:rn], rlog.dest[:rn],
                    node_names=self.node_names)
            tm["journal-s"] += time.perf_counter() - t3
        return k, self._decode_replies(rlog, rounds, plog, rn)

    def _ring_tree(self):
        return self.sim.telemetry if self.telemetry_rings else ()

    def _book_scan(self, scan, t0, t1, t2, k, before):
        """scan-s: the rounds' dispatch, their chunk-flag reads and the
        pack; drain-s: the packed fetch."""
        tm = self.timing
        tm["scan-s"] += t1 - t0
        tm["drain-s"] += t2 - t1
        tm["rounds-executed"] += k
        tm["dispatches"] += 1
        for name, now, was in zip(SCAN_COUNTS, _scan_counts(scan), before):
            tm[name] += now - was

    def _exec_cscan(self, rows, k_max, stop, r):
        """One continuous dispatch: the scheduled rows as a [Q] inject
        batch with their window offsets, the sched-inject scan, and ONE
        packed fetch of the replies, the mids stamped on the rows (-1
        for rows the window did not reach), next_mid and the ring.
        Returns (k_executed, replies, inj_mids)."""
        program, cfg = self.program, self.cfg
        N, Q = cfg.n_nodes, max(self.concurrency, 1)
        dev = self.device
        cols = g.sched_columns(rows, r, Q, N)
        inject = T.Msgs.empty(Q, dev)
        if rows:
            inject = inject.replace(**{
                f: torch.from_numpy(cols[f]).to(dev)
                for f in ("valid", "src", "dest", "type", "a", "b", "c")})
        at = torch.from_numpy(cols["at"]).to(dev)
        if self._cscan_fn is None:
            self._cscan_fn = make_scan_fn(
                program, cfg, reply_cap=self.reply_log_cap,
                device=dev, fetch=self._fetch_flag, sched_inject=True)
        scan = self._cscan_fn
        before = _scan_counts(scan)
        t0 = time.perf_counter()
        self.sim, _cm, k, rl, im = scan(self.sim, inject, at, k_max, stop)
        self._state_cache = None
        tree = (rl, im, self.sim.net.next_mid, self._ring_tree())
        if self._cpack is None:
            self._cpack = self._make_packer(tree)
        pack, unpack = self._cpack
        packed = pack(tree)
        t1 = time.perf_counter()
        self._tel_span("dispatch", t0, t1)
        flat = self.transfer.fetch(packed)
        t2 = time.perf_counter()
        self._tel_span("device-get", t1, t2,
                       args={"drains": self.transfer.drains,
                             "host-bytes": self.transfer.host_bytes})
        (rlog, rounds, plog, rn), im, next_mid, ring = unpack(flat)
        self._next_mid = int(next_mid)
        if self.telemetry_rings:
            self._ring_host = ring
        self._book_scan(scan, t0, t1, t2, k, before)
        return k, self._decode_replies(rlog, rounds, plog, int(rn)), im

    def _decode_replies(self, rlog, rounds, plog, rn: int) -> list:
        """The drained reply-log rows as plain tuples for the loop's
        completion pass."""
        return [(int(rounds[j]), int(rlog.type[j]),
                 int(rlog.a[j]), int(rlog.b[j]),
                 int(rlog.c[j]), int(rlog.reply_to[j]),
                 None if plog is None else plog[j])
                for j in range(rn)]

    def _journal_round(self, io, r: int):
        """This round's device messages as journal rows (the analogue of
        the send!/recv! hooks, reference `net.clj:207,243`). The round's
        client replies are journaled from the reply log instead."""
        inject_sent, outbox_sent, inbox = io[0], io[1], io[2]
        t_ns = self._time_ns(r)
        for batch, typ in ((inject_sent, "send"), (outbox_sent, "send"),
                           (inbox, "recv")):
            valid = np.asarray(batch.valid).reshape(-1)
            if not valid.any():
                continue
            mid = np.asarray(batch.mid).reshape(-1)[valid]
            src = np.asarray(batch.src).reshape(-1)[valid]
            dest = np.asarray(batch.dest).reshape(-1)[valid]
            self.journal.log_batch(typ, mid, np.full(mid.shape, t_ns),
                                   src, dest, node_names=self.node_names)
        if len(io) >= 5:
            self._journal_edges(io[3], io[4], r)

    def _journal_edges(self, edge_out, edge_in, r: int):
        """Journal rows for static edge-channel traffic. Ids are
        deterministic functions of (send round, edge, send lane): the send
        side stamps round * LANE_STRIDE + lane, the channels carry it with
        the message (`EdgeChannels.sent`), so every recv row pairs exactly
        to its send. The high id bit keeps edge ids disjoint from pool
        message ids."""
        from ..net.static import LANE_STRIDE
        prog = self.program
        N, D = self.cfg.n_nodes, prog.D
        L = prog.lanes
        if not hasattr(self, "_edge_topo"):
            self._edge_topo = (prog.neighbors.cpu().numpy(),
                               prog.rev.cpu().numpy())
        nb, rev = self._edge_topo
        base = 1 << 40

        ov = np.asarray(edge_out.valid)              # [N, D, L]
        if ov.any():
            n_i, d_i, l_i = np.nonzero(ov)
            ids = base + (r * (N * D * L)
                          + (n_i * D + d_i) * L + l_i).astype(np.int64)
            self.journal.log_batch(
                "send", ids, np.full(ids.shape, self._time_ns(r)),
                n_i.astype(np.int32), nb[n_i, d_i].astype(np.int32),
                node_names=self.node_names)
        iv = np.asarray(edge_in.valid)               # [N, D, Lc] (receiver)
        if iv.any():
            m_i, e_i, l_i = np.nonzero(iv)
            senders = nb[m_i, e_i]
            send_d = rev[m_i, e_i]
            packed = np.asarray(edge_in.sent)[m_i, e_i, l_i]
            send_round = packed // LANE_STRIDE
            send_lane = packed % LANE_STRIDE
            ids = base + (send_round.astype(np.int64) * (N * D * L)
                          + (senders * D + send_d) * L + send_lane
                          ).astype(np.int64)
            self.journal.log_batch(
                "recv", ids, np.full(ids.shape, self._time_ns(r)),
                senders.astype(np.int32), m_i.astype(np.int32),
                node_names=self.node_names)

    def _quiet(self) -> bool:
        """Fused quiescence probe, one launch (K6): pool empty AND edge
        channels drained (ring cells are addressed by round % ring, so
        rings must empty before virtual time may skip) AND the node
        program idle. One host read. A program that is never quiescent
        (raft's timers tick) launches nothing."""
        if self.program.quiet_planes is None:
            return False
        sim = self.sim
        planes = [sim.net.pool.valid]
        if sim.channels is not None:
            planes.append(sim.channels.valid)
        planes += self.program.quiet_planes(sim.nodes)
        return bool(self.transfer.fetch(quiet_probe(planes)))


def run_tpu_test(test: dict, test_dir: str) -> dict:
    """Executes a full test: run, check, store (the JAX package's
    `run_tpu_test` for one cluster). Writes history.jsonl, history.txt,
    results.json, test.json, the network journal and timing.json (wall
    seconds by phase, the port's own) into `test_dir`. `--fleet N` (N >
    1) routes to the fleet runner: N independent clusters in lockstep,
    each checked and stored on its own."""
    if int(test.get("fleet") or 1) > 1:
        from .fleet_runner import run_fleet_test
        return run_fleet_test(test, test_dir)
    t_run0 = time.perf_counter()
    runner = TpuRunner(test)
    test["store_dir"] = test_dir
    if runner.telemetry_rings:
        # the flight recorder's session (spans and telemetry.jsonl)
        runner.telemetry = TM.TelemetrySession(
            TM.resolve_dir(test.get("telemetry"), test_dir),
            ms_per_round=runner.ms_per_round)
    # the device-counter net stats and the availability block
    from ..checkers.availability import AvailabilityChecker
    test["checker"].checkers["net"] = TpuNetStats(runner)
    test["checker"].checkers["availability"] = AvailabilityChecker(runner)
    if "byzantine" in runner.faults:
        # convictions come from the program's evidence leaves
        from ..checkers.byzantine import TpuByzantine
        test["checker"].checkers["byzantine"] = TpuByzantine(runner)
    test["nemesis"] = (True if (test.get("nemesis_pkg") or {}).get(
        "generator") is not None else None)
    try:
        history = runner.run()
        t_run1 = time.perf_counter()
        if runner.telemetry is not None:
            # the final record: cumulative quantiles over the whole
            # history and the cumulative ring
            runner.telemetry.flush(history, runner.final_round,
                                   ring=runner._ring_dict())
        test["transfer"] = runner.transfer
        if runner.cfg.enable_byz and runner.sim.byz is not None:
            # the run's injection ledger, read once off the device: the
            # convictions are graded against what the kernels rewrote
            inj = runner.transfer.fetch(runner.sim.byz["injected"])
            test["byz_injected"] = {a: int(inj[i])
                                    for i, a in enumerate(BZ.ATTACKS)}
        results = test["checker"].check(test, history, {})
    finally:
        # the trace lands even when the run fails (close is idempotent)
        if runner.telemetry is not None:
            runner.telemetry.close()
    net_block = results.get("net")
    if isinstance(net_block, dict) and "drains" in net_block:
        # the net block renders before the workload checker runs:
        # refresh the transfer ledger so check-time fetches are reported
        net_block.update(runner.transfer.as_dict())
    t_check = time.perf_counter()
    if runner.journal is not None:
        runner.journal.close()
    store.write_history(test_dir, history)
    store.write_results(test_dir, results)
    from ..core import DEFAULTS
    store.write_test(test_dir, {k: str(test[k]) for k in DEFAULTS
                                if k in test})
    t_store = time.perf_counter()
    timing = dict(runner.timing)
    timing.update({"run-s": t_run1 - t_run0, "check-s": t_check - t_run1,
                   "store-s": t_store - t_check,
                   "final-round": runner.final_round,
                   "drains": runner.transfer.drains,
                   "history-ops": len(history)})
    with open(os.path.join(test_dir, "timing.json"), "w") as f:
        json.dump(timing, f, indent=2)
    store.mark_complete(test_dir)
    log.info("Results valid? %s (store: %s)", results["valid"], test_dir)
    return results
