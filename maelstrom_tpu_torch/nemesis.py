"""Fault packages: the nemesis's schedules and decisions.

A copy of `maelstrom_tpu/nemesis.py` without the host-path executor (the
port runs no host network): the grudge shapes, `grudge_matrix`, the
role-targeted scoping (`parse_targets`, `resolve_targets`:
`--nemesis-targets`), the seeded decision streams of `NemesisDecisions`
(the byzantine attack plans too) and the generator schedules of
`package`.
The decision streams are the JAX package's, draw for draw, so a seed
gives the same fault schedule and the same history in both packages;
the runner applies the decisions (`runner/tpu_runner.py`
`TpuCombinedNemesis`).

Packages: ``partition`` (grudge shapes: random halves, one isolated node,
a bridge, majorities-ring, one-way halves), ``kill`` (a minority crashes
and restarts from its durable store), ``pause`` (a minority stops
stepping), ``duplicate`` (server-to-server messages re-sent with an
independent latency draw with probability p) and ``weather`` (seeded
loss and latency-scale fronts; stop-weather restores the run's
configured --p-loss and --latency-scale) and ``byzantine`` (a seeded
attack plan, `next_byz_plan`: the kind, the lying node and the nonce;
`byzantine.py`)."""

from __future__ import annotations

import random

from . import generators as g

FAULTS = ("partition", "kill", "pause", "duplicate", "weather",
          "byzantine")

# duplication probabilities the duplicate package cycles through
DUP_PROBS = (0.1, 0.25, 0.5)

# weather fronts the weather package draws from: (name, p_loss,
# latency_scale). Scales stay within the edge-ring headroom budget
# (`nodes.edge_timing` sizes rings for max_latency_scale, default 10);
# loss stays moderate because it also eats CLIENT RPCs (like the
# reference's flaky!, net.clj:213-214) and each lost client message
# parks a worker for the full RPC timeout
WEATHER_FRONTS = (("drizzle", 0.02, 2.0),
                  ("storm", 0.1, 5.0),
                  ("monsoon", 0.25, 10.0))


# --- partition grudges -----------------------------------------------------
#
# A grudge maps dest -> set of blocked srcs (directional: src->dest
# messages are consumed and dropped). Symmetric grudges list both
# directions explicitly.


def split_half(nodes, rng: random.Random):
    """Random majority/minority split; returns (name, grudge) where grudge
    maps dest -> set of blocked srcs (both directions blocked)."""
    nodes = list(nodes)
    rng.shuffle(nodes)
    k = len(nodes) // 2
    a, b = set(nodes[:k]), set(nodes[k:])
    grudge = {}
    for d in a:
        grudge[d] = set(b)
    for d in b:
        grudge[d] = set(a)
    return f"halves {sorted(a)} | {sorted(b)}", grudge


def isolate_node(nodes, rng: random.Random):
    """Cuts one node off from everyone else."""
    nodes = list(nodes)
    n = rng.choice(nodes)
    rest = set(nodes) - {n}
    grudge = {n: set(rest)}
    for d in rest:
        grudge[d] = {n}
    return f"isolated {n}", grudge


def bridge(nodes, rng: random.Random):
    """Two halves joined only through one bridge node (jepsen
    nemesis/bridge): the halves cannot talk directly, but both talk to
    the bridge, so no component separation exists — this grudge needs
    the directional pair representation."""
    nodes = list(nodes)
    rng.shuffle(nodes)
    mid = nodes[len(nodes) // 2]
    a = set(nodes[: len(nodes) // 2])
    b = set(nodes) - a - {mid}
    grudge = {}
    for d in a:
        grudge[d] = set(b)
    for d in b:
        grudge[d] = set(a)
    return f"bridge {mid} between {sorted(a)} | {sorted(b)}", grudge


def majorities_ring(nodes, rng: random.Random):
    """Every node receives only from a majority-sized window starting at
    itself in (shuffled) ring order — overlapping majorities, directional
    (i hears i..i+m-1; i+m-1 does not hear i). The jepsen
    nemesis/majorities-ring grudge."""
    ring = list(nodes)
    rng.shuffle(ring)
    n = len(ring)
    m = n // 2 + 1
    grudge = {}
    for i, d in enumerate(ring):
        visible = {ring[(i + j) % n] for j in range(m)}
        grudge[d] = set(ring) - visible
    return f"majorities-ring {ring}", grudge


def one_way_halves(nodes, rng: random.Random):
    """Asymmetric split: half A's messages reach half B, but B's never
    reach A — the stale-leader/one-way-link shape symmetric partitions
    cannot express."""
    nodes = list(nodes)
    rng.shuffle(nodes)
    k = len(nodes) // 2
    a, b = set(nodes[:k]), set(nodes[k:])
    grudge = {d: set(b) for d in a}     # B -> A blocked; A -> B flows
    return f"one-way {sorted(b)} -/-> {sorted(a)}", grudge


GRUDGES = [split_half, isolate_node, bridge, majorities_ring,
           one_way_halves]


def isolate_set(nodes, cut):
    """Role-targeted partition: the `cut` subset is severed from every
    other node, both directions (`--nemesis-targets partition=<group>`).
    Deterministic: no RNG draw."""
    cs = set(cut)
    cut = [n for n in nodes if n in cs]
    rest = [n for n in nodes if n not in cs]
    grudge = {d: set(cut) for d in rest}
    grudge.update({d: set(rest) for d in cut})
    return f"isolated {cut}", grudge


# --- role-targeted fault scoping ------------------------------------------

# faults whose decisions pick nodes and can therefore be scoped;
# duplicate and weather are cluster-global knobs, so a target spec for
# them is refused
TARGETABLE_FAULTS = ("kill", "pause", "partition", "byzantine")


def parse_targets(spec) -> dict:
    """`--nemesis-targets kill=lww-kv,pause=lin-tso` -> {fault: [group
    tokens]} ('+' joins several groups for one fault)."""
    if not spec:
        return {}
    if isinstance(spec, dict):
        items = {f: (list(v) if isinstance(v, (list, tuple))
                     else str(v).split("+"))
                 for f, v in spec.items()}
    else:
        items = {}
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            f, sep, val = part.partition("=")
            if not sep or not val.strip():
                raise ValueError(
                    f"--nemesis-targets: expected fault=group, got "
                    f"{part!r}")
            items[f.strip()] = [t.strip() for t in val.split("+")
                                if t.strip()]
    for f in items:
        if f not in TARGETABLE_FAULTS:
            raise ValueError(
                f"--nemesis-targets: {f!r} is not a targetable fault "
                f"(node-picking faults only: {list(TARGETABLE_FAULTS)})")
    return items


def resolve_targets(spec, groups: dict, nodes, dynamic=()) -> dict | None:
    """Resolves a target spec's group tokens against the program's fault
    groups (`fault_groups`: role names, ...) plus literal node names.
    Returns {fault: [node names]} for `NemesisDecisions`, or None when
    no targeting was asked for. Tokens naming a `dynamic` group (resolved
    against live cluster state when the fault fires) stay symbolic, as
    "@<token>"."""
    parsed = parse_targets(spec)
    if not parsed:
        return None
    node_set = set(nodes)
    dynamic = set(dynamic or ())
    out: dict = {}
    for fault, tokens in parsed.items():
        names: list = []
        for tok in tokens:
            if tok in dynamic:
                members = [f"@{tok}"]
            elif tok in groups:
                members = groups[tok]
            elif tok in node_set:
                members = [tok]
            else:
                raise ValueError(
                    f"--nemesis-targets: unknown group {tok!r} for "
                    f"{fault!r}; known groups: "
                    f"{sorted(set(groups) | dynamic)} "
                    f"(or a literal node name)")
            names += [n for n in members if n not in names]
        if not names:
            raise ValueError(f"--nemesis-targets: empty target set for "
                             f"{fault!r}")
        out[fault] = names
    return out


def grudge_matrix(nodes, grudge):
    """Converts a dest -> blocked-srcs grudge map into the directional
    block representation the network installs (`net/tpu.py
    partition_grudge`): every node is its own group, matrix[src, dest]
    blocks that direction. Expresses one-way, bridge, and
    majorities-ring grudges exactly."""
    import numpy as np
    idx = {n: i for i, n in enumerate(nodes)}
    n = len(nodes)
    groups = np.arange(n, dtype=np.int32)
    matrix = np.zeros((n, n), bool)
    for dest, srcs in grudge.items():
        for src in srcs:
            matrix[idx[src], idx[dest]] = True
    return groups, matrix


# --- shared fault decisions ------------------------------------------------


class NemesisDecisions:
    """The random choices a nemesis makes: one independent RNG stream per
    fault package, keyed by (seed, fault), so the decision sequence of
    each package does not depend on how the packages interleave.

    `targets` ({fault: [node names]}, from `resolve_targets`) scopes the
    node-picking packages: kill and pause sample their minority of the
    named pool, and a targeted partition isolates the pool. "@<group>"
    entries expand at invoke time through `resolve_dynamic`, which the
    executing runner sets. `attacks` (`--byz-attacks`) restricts the
    attack kinds the byzantine package draws; None draws from all of
    `byzantine.ATTACKS`."""

    def __init__(self, nodes, seed: int = 0, targets: dict | None = None,
                 attacks=None):
        self.nodes = list(nodes)
        self.seed = seed
        self.rngs = {f: random.Random(f"{seed}:{f}") for f in FAULTS}
        self.byz_attacks = tuple(attacks) if attacks else None
        self.targets = dict(targets or {})
        self.resolve_dynamic = None

    def _expand_pool(self, pool):
        """Expands dynamic "@group" markers against live cluster state."""
        if pool is None:
            return None
        out: list = []
        for t in pool:
            if isinstance(t, str) and t.startswith("@"):
                if self.resolve_dynamic is None:
                    raise ValueError(
                        f"dynamic nemesis target {t!r} needs a live "
                        f"runner to resolve it (TPU path only)")
                out += [n for n in self.resolve_dynamic(t[1:])
                        if n not in out]
            elif t not in out:
                out.append(t)
        return out

    def next_grudge(self):
        tg = self._expand_pool(self.targets.get("partition"))
        if tg:
            return isolate_set(self.nodes, tg)
        rng = self.rngs["partition"]
        return rng.choice(GRUDGES)(self.nodes, rng)

    def _minority(self, fault: str):
        """A non-empty set of target nodes: at most (n-1)//2 — a strict
        minority, so clusters of n >= 3 keep quorum through the fault
        window. Degenerate clusters (n <= 2) have no non-empty strict
        minority; there the package still targets one node, accepting a
        transient quorum loss that heals at the stop op. With a targeted
        pool the minority is taken of the pool."""
        rng = self.rngs[fault]
        pool = self._expand_pool(self.targets.get(fault)) or self.nodes
        k = rng.randint(1, max(1, (len(pool) - 1) // 2))
        return sorted(rng.sample(pool, k))

    def next_kill_targets(self):
        return self._minority("kill")

    def next_pause_targets(self):
        return self._minority("pause")

    def next_dup_prob(self) -> float:
        return self.rngs["duplicate"].choice(DUP_PROBS)

    def next_weather(self) -> tuple:
        """(name, p_loss, latency_scale) for the next weather front."""
        return self.rngs["weather"].choice(WEATHER_FRONTS)

    def next_byz_plan(self) -> tuple:
        """(attack, culprit, delta) for the next byzantine window: the
        attack kind, the lying node (of the targeted pool, if any) and
        the corruption nonce, from the byzantine package's own stream."""
        from .byzantine import ATTACKS
        rng = self.rngs["byzantine"]
        pool = self._expand_pool(self.targets.get("byzantine")) \
            or self.nodes
        culprit = rng.choice(sorted(pool))
        attack = rng.choice(list(self.byz_attacks or ATTACKS))
        delta = rng.randint(1, 0x7FFF)
        return attack, culprit, delta


# --- schedules -------------------------------------------------------------


def fault_schedule(fault: str, interval_s: float, offset_s: float):
    """One package's generator: wait out its stagger offset, then cycle
    start -> hold an interval -> stop -> rest an interval, forever (the
    outer time-limit cuts it; the final generator heals leftovers).
    Seq never mutates the pristine Sleep instances it re-yields each
    lap."""
    return g.Seq([
        g.sleep(offset_s),
        g.Seq(g.cycle([
            {"f": f"start-{fault}", "type": "invoke"},
            g.sleep(interval_s),
            {"f": f"stop-{fault}", "type": "invoke"},
            g.sleep(interval_s),
        ])),
    ])


def package(faults: set, interval_s: float = 10.0):
    """Builds {generator, final_generator, faults} for the requested
    fault set — any subset of ``partition``, ``kill``, ``pause``,
    ``duplicate``, ``weather``, ``byzantine`` (the reference CLI stops at
    partition, `core.clj:40-42`). Packages compose: each keeps its own
    schedule, staggered across the interval so a ``kill,pause,partition`` run
    overlaps faults rather than synchronizing them. The final generator
    emits a stop op for every selected package so ALL fault types heal
    before recovery grading."""
    faults = set(faults)
    unknown = faults - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown nemesis fault(s) {sorted(unknown)}; "
                         f"expected any of {list(FAULTS)}")
    ordered = [f for f in FAULTS if f in faults]
    if not ordered:
        return {"generator": None, "final_generator": None, "faults": ()}

    n = len(ordered)
    gens = [fault_schedule(f, interval_s, interval_s * (i + 1) / n)
            for i, f in enumerate(ordered)]
    sched = gens[0]
    for sub in gens[1:]:
        sched = g.Any2(sched, sub)

    final = g.Seq([{"f": f"stop-{f}", "type": "invoke"}
                   for f in ordered])
    return {"generator": sched, "final_generator": final,
            "faults": tuple(ordered)}
