"""Fault packages: the nemesis's schedules and decisions.

A copy of `maelstrom_tpu/nemesis.py` without the byzantine package (the
adversary slice brings it), the role-targeted scoping (it comes with the
role-partitioned programs) and the host-path executor (the port runs no
host network): the grudge shapes, `grudge_matrix`, the seeded decision
streams of `NemesisDecisions` and the generator schedules of `package`.
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
configured --p-loss and --latency-scale)."""

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
    each package does not depend on how the packages interleave."""

    def __init__(self, nodes, seed: int = 0):
        self.nodes = list(nodes)
        self.seed = seed
        self.rngs = {f: random.Random(f"{seed}:{f}") for f in FAULTS}

    def next_grudge(self):
        rng = self.rngs["partition"]
        return rng.choice(GRUDGES)(self.nodes, rng)

    def _minority(self, fault: str):
        """A non-empty set of target nodes: at most (n-1)//2 — a strict
        minority, so clusters of n >= 3 keep quorum through the fault
        window. Degenerate clusters (n <= 2) have no non-empty strict
        minority; there the package still targets one node, accepting a
        transient quorum loss that heals at the stop op."""
        rng = self.rngs[fault]
        k = rng.randint(1, max(1, (len(self.nodes) - 1) // 2))
        return sorted(rng.sample(self.nodes, k))

    def next_kill_targets(self):
        return self._minority("kill")

    def next_pause_targets(self):
        return self._minority("pause")

    def next_dup_prob(self) -> float:
        return self.rngs["duplicate"].choice(DUP_PROBS)

    def next_weather(self) -> tuple:
        """(name, p_loss, latency_scale) for the next weather front."""
        return self.rngs["weather"].choice(WEATHER_FRONTS)


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
    ``duplicate``, ``weather`` (the reference CLI stops at partition,
    `core.clj:40-42`). Packages compose: each keeps its own schedule,
    staggered across the interval so a ``kill,pause,partition`` run
    overlaps faults rather than synchronizing them. The final generator
    emits a stop op for every selected package so ALL fault types heal
    before recovery grading."""
    faults = set(faults)
    unknown = faults - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown nemesis fault(s) {sorted(unknown)}; "
                         f"expected any of {list(FAULTS)}")
    if "byzantine" in faults:
        raise NotImplementedError(
            "the byzantine nemesis comes with the adversary slice")
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
