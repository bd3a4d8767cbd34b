#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (`maelstrom_tpu_torch`).

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `maelstrom_tpu_torch/csrc`, holds
each kernel against its plain PyTorch version on the card (exact equality:
they compute on int32 and bool), drives the 1024-node graft path through
the kernels and through the plain versions, runs the broadcast bench
(`maelstrom_tpu_torch.bench.run_broadcast_bench`) at 16,384 nodes against
the JAX reference's message counts and at 100,000 nodes (slice 1's main
path), then the port's CLI (`python -m maelstrom_tpu_torch test`): small
runs whose history.jsonl must hash to the JAX runner's (`PINNED_CLI`),
and the 100,000-node broadcast test at the CLI's defaults (slice 2's main
path). Then the fault slice: K7-K9 and K3 with its stall mask against
their plain versions at the shapes of the fault runs, K7's draws against
hashes of `jax.random`'s, the CLI under faults on runs whose histories
must hash to the JAX runner's (`PINNED_FAULTS`), and the 100,000-node
test under loss, uniform latency and the kill, pause and duplicate
nemeses (slice 3's main path, cut in depth). Then the Raft slice: K10
raft_step (with and without its stall mask), K7 on a batch of keys and K4
on batched segments against their plain versions, the Raft bench at
10,000 5-node clusters on the cluster axis (`python -m
maelstrom_tpu_torch.bench --raft`) with clusters 0-63 held to a hash of
the JAX run's state (`PINNED_RAFT`) and the JAX package's golden raft
scenario (`PINNED_RAFT_GOLDEN`), and the lin-kv CLI, fault-free and
under faults, whose histories must hash to the JAX runner's
(`PINNED_LINKV`). Then the pool-path and CRDT slice: K11 echo_step, K12
unique_ids_step and K13 pn_counter_step (with and without their stall
masks) and K5's int32 payload form against their plain versions, echo
and unique-ids on the CLI (`PINNED_POOL`), g-set, pn-counter and
g-counter runs whose histories must hash to the JAX runner's
(`PINNED_CRDT`), and the 1,000-node g-set (gossip fanout 3, 5% loss),
pn-counter (with partitions) and g-counter runs, with a profile of the
pn-counter round. Then the kafka slice: K14 kafka_step (classic and
group mode, with and without its stall mask, up to a 50 MB log) against
its plain version, kafka through `core.run` and the CLI on the JAX
package's e2e configs and Gossip Glomers' challenge 5b, whose histories
must hash to the JAX runner's (`PINNED_KAFKA`), the kafka fault sweep
(`fuzz.fuzz_kafka`), and the broadcast fuzz, BASELINE config 5: its
sweep at 4,096 nodes equal to the JAX package's rows (`PINNED_FUZZ`),
then at 100,000 nodes. Then the batched-broadcast slice: K15
broadcast_batched_step (with and without its stall mask, up to a
100,000-node grid and a 70,000-value table whose proof sums wrap)
against its plain version, the JAX package's batched-broadcast runs and
the ordering axis (lin-kv over the batched engine, kafka over the raft
engine) through `core.run`, whose histories must hash to the JAX
runner's (`PINNED_BATCHED`), and bench.py's batched-vs-eager record at
4,096 nodes, whose rounds and message counts must equal the JAX
package's (`PINNED_BATCHED_BENCH`). Then the transaction slice: the
txn-list-append runs (the Elle checker's device path on, and one whose
1,158 ok transactions engage it under `auto`), txn-rw-register and
lin-mutex through `core.run`, whose histories and Elle `device` blocks
must equal the JAX runner's (`PINNED_TXN`), with K16 and K17 launched on
the device-checker runs; bench.py's checker-throughput record at
1,000,000 lin-kv rows and 1,000,000 Elle micro-ops (`python -m
maelstrom_tpu_torch.bench --checkers`: edge sets equal, the screen
deciding at least 90% of its fixtures); and K16 elle_edges and K17
elle_screen against their plain versions on the fixture histories,
random histories of 150 transactions and the bench's full-width set,
with and without its realtime inputs. Then the stream slice: K18
sched_inject (the continuous scan's select and fold) and K19 ring_update
(the flight recorder's fold) against their plain versions at the stream
runs' shapes, at 100,000 clients and at the 100,000-node CLI run's
shape, and the continuous runs through `core.run` (streaming kafka with
two consumer groups and lin-kv under the five-package soup, echo at 300
ops/s), whose histories and rings must hash to the JAX runner's
(`PINNED_STREAM`), with the ring also on the lin-kv and echo runs of
earlier slices, whose histories keep their pins and whose rings hash to
JAX's (`PINNED_TELEMETRY`). Then the role-partition slice: K20 tso_step,
K21 seq_kv_step and K22 lww_kv_step (with and without their stall
masks, K22 up to 100,000 replicas x 256 keys) against their plain
versions, the lin-tso runs on the in-cluster services (`--node
tpu:services`: plain, under role-targeted kills, pauses and partitions
with the ring on, and 1,022 lww-kv replicas) whose histories and ring
must hash to the JAX runner's (`PINNED_SERVICES`), and two pinned runs
of earlier slices again with their program wrapped as a one-role
partition (`--node tpu:solo:<program>`), held to their existing pins.
Then the compartment slice: K23 compartment_sequencer_step, K24
compartment_proxy_step, K25 compartment_acceptor_step and K26
compartment_replica_step (with and without their stall masks, at the
CLI's and the bench's shapes and up to 4,096 acceptors x 32,256 slots)
against their plain versions, the compartment's lin-kv runs (`--node
tpu:compartment`: plain, under role-targeted kills and a grid-column
partition with the ring on, the leader's shed) and kafka over the
compartment engine, whose histories and ring must hash to the JAX
runner's (`PINNED_COMPARTMENT`), and bench.py's proxy-scaling sweep at
full width (`python -m maelstrom_tpu_torch.bench --compartment`), whose
ok ops must equal the JAX runner's (`PINNED_COMPARTMENT_BENCH`). Then
the election slice: K27 compartment_sequencer_elect, K28
compartment_proxy_elect, K29 compartment_acceptor_elect and K26 at the
elected learn packing (with and without their stall masks, at the CLI's
and bench.py's failover shapes and at the elected layout's limits)
against their plain versions, the elected compartment's runs (`--roles
sequencers=2`: the kill=sequencer soup, a partitioned grid column with
the ring on, --continuous, two redirect hops with the lease off) whose
histories, ring and election blocks must equal the JAX runner's
(`PINNED_ELECTION`), and bench.py's failover record at full width
(`python -m maelstrom_tpu_torch.bench --failover`), whose counts must
equal the JAX runner's (`PINNED_FAILOVER_BENCH`). Then the byzantine
slice: K30 byz_corrupt_pool and K31 byz_corrupt_edge (every attack, the
gate open and closed, culprits out of range, both round parities)
and the conviction forms of K24 and K28 (and K23, K27 on E_BYZANTINE
NACK lanes) against their plain versions, the adversary's runs
(`--nemesis byzantine`: the equivocating sequencer at two candidates
and at one, stale ballots, forged batch proofs, the armed detectors on
honest traffic) whose histories, verdicts and `byzantine` blocks must
equal the JAX runner's (`PINNED_BYZANTINE`), and bench.py's conviction
record at full width (`python -m maelstrom_tpu_torch.bench
--byzantine`), whose windows, ledger, convictions, latency and ok ops
must equal the JAX runner's (`PINNED_BYZANTINE_BENCH`). Then the fleet
slice: K32 fleet_hold over the 10,000-cluster lin-kv carry and the fleet
bench's, K33 wave_reduce at 64, 512 and 10,000 clusters, and the fleet
forms of K1/K2/K9 ([F] rounds), K3 (rows, with the stall mask), K5, K6,
K7 ([F, 2] keys) and K8 (F-led) at 10,000 x 5 nodes against their plain
versions; five fleets through `core.run` (64 broadcast clusters, the
lin-kv nemesis sweep under partitions, broadcast and lin-kv under the
soup, a capacity sweep) whose every cluster's history must hash to the
JAX fleet runner's (`PINNED_FLEET`), with K32 twice a lockstep round,
K33 once a poll pass of the 64-cluster run, and one cluster of three
runs equal to its standalone run;
and bench.py's fleet record at 1 to 10,000 clusters (`python -m
maelstrom_tpu_torch.bench --fleet`), every size converged, the message
counts JAX's where the CPU pins them (`PINNED_FLEET_BENCH`), with a
profile of its dispatch at 64 and 10,000 clusters.
The runs (the CLI, the benches and the sweeps) go in eight groups side
by side, seven of them in worker processes the script starts and waits
for (`--worker`), each phase counting the launches of its own runs; the
profiles and the kernel times come after, with the card to themselves.
Every phase prints one JSON line; any failed check exits non-zero. The line before the last lists every kernel
with its launches on its path, its time, its plain version's time and
its bound; the last line is `{"ok": true, "device": {...}}`.

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
# int32 operations a second outside the tensor cores: 132 SMs x 64 INT32
# lanes x 1.98 GHz boost (H100 SXM; NVIDIA's Hopper architecture paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations of one threefry2x32 hash: 20 rounds of add, rotate
# (one funnel shift) and xor, 5 key injections of 3 adds, 2 initial adds
# and the 2 xors of the third key word; a draw adds 4 (the xor of the two
# words, the shift and or of the float bits, the subtraction)
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 2
DRAW_OPS = THREEFRY_OPS + 4

# K7's uniform bits and latency rounds for key PRNGKey(42) over 100,003
# draws: sha256 of the little-endian uint32 bits, of the int32 rounds of
# uniform latency (mean 5, scale 1) and of exponential latency (mean 3),
# from jax.random on the CPU (jax 0.9.0):
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_prng.py -k pins
PRNG_PIN_N = 100_003
PINNED_PRNG = {
    "bits": "5403048bd34ae1e0bd70df9dcb31c0c65c28f4735a0b9756f84902ff6a968f81",
    "uniform_rounds":
        "ba1343854879234f1ecc8b821adb59917e410a1bd41489119fd6daf7f15d5e9f",
    "exponential_rounds":
        "125a1fdfb04629bf079951498eb5d2c4fbe2a0aa424c82b5315368e924ff44e0",
}


# the smoke's start on the monotonic clock, which every process of the
# machine shares: a worker process (`--worker`) gets its parent's, so its
# phases' `at_s` count from the same start
T_START = float(os.environ.get("CHIP_SMOKE_T0") or time.perf_counter())
WORKER = os.environ.get("CHIP_SMOKE_WORKER")

# why the runs cut to pay for the role-partition slice were cut (their
# `reduced` records)
WHY_SERVICES = ("to pay for the role-partition slice (its cli_services "
                "runs add 12,534 executed rounds)")


def emit(obj) -> None:
    """One JSON line; a phase's line carries the smoke's seconds so far
    (`at_s`)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START,
               **({"worker": int(WORKER)} if WORKER else {})}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# --- helpers ----------------------------------------------------------------

# traces taken, those taken again with what they held (`traced`), the
# device records found missing in traces accepted (`cuda_ms`, the
# profile windows), the sentinel records missing, the timings made by
# CUDA events (`event_ms`) and the windows kept short, reported by the
# `profiler` line
PROFILER = {"traces": 0, "retaken": 0, "incomplete": [], "short": 0,
            "records_missing": 0, "sentinels_missing": 0, "event_timed": [],
            "kept_short": []}
SENTINEL = "spin_kernel"      # torch.cuda._sleep's kernel
SENTINELS = 8                 # sentinel kernels before and after a window
GUARD_S = 0.02
SPIN_CYCLES = 100_000_000     # some 50 ms of the card's clock


def traced(run, complete, what: str, attempts: int = 3,
           keep_last: bool = False):
    """The device events (`key_averages` rows of device type) of `run()`
    under `torch.profiler`, from a trace that `complete(events)` accepts.
    The profiler drops device records now and then: all of a trace's or
    some, about one trace in a hundred on plain torch ops as on the
    port's kernels, with or without CUPTI torn down between traces, and
    late in a run of some fifteen minutes one or two records of a trace,
    the same number each time it is taken again, whatever the host time
    around the window (20 to 320 ms). Each trace therefore runs with the
    allocator's cache emptied, holds `SENTINELS` sentinel kernels, left
    out of the events, before and after `run()` and `GUARD_S` of host
    time around it; a trace that is empty or fails `complete` is taken
    again, up to `attempts` traces. Then the smoke fails, or with
    `keep_last` the last trace is returned (the caller says what it
    lacks)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(attempts):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SENTINELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(GUARD_S)
            run()
            torch.cuda.synchronize()
            for _ in range(SENTINELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(GUARD_S)
        PROFILER["traces"] += 1
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        evs = [e for e in dev if SENTINEL not in e.key]
        PROFILER["sentinels_missing"] += 2 * SENTINELS - sum(
            e.count for e in dev if SENTINEL in e.key)
        if evs and complete(evs):
            return evs
        PROFILER["retaken"] += 1
        seen.append({e.key[:40]: e.count for e in evs})
        if len(PROFILER["incomplete"]) < 20:
            PROFILER["incomplete"].append({
                "what": what, "held": seen[-1],
                "free_gb": torch.cuda.mem_get_info()[0] / 2**30})
    if keep_last:
        return evs
    fail(f"{what}: no complete trace in {attempts} ({seen})")


def event_ms(fn, iters: int) -> float:
    """Mean time of one call of `fn` on the card by CUDA events around
    `iters` calls, queued behind a spin kernel so that the events
    bracket the device's work and not the host's dispatch (a call that
    waits on the device, as a plain version's host reads do, counts the
    gaps it leaves)."""
    import torch
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            only: str | tuple = ()) -> float:
    """Mean device time of one call of `fn`: the kernels, copies and fills
    it runs on the card, summed from a `torch.profiler` trace of `iters`
    calls. Host dispatch and the idle gaps it leaves are not counted (a
    wrapper call costs more host time than its kernel takes, so events
    around back-to-back calls would time the host). Every call launches
    the same device work, c times a device function, so a trace holds
    each function c x `iters` times unless it lost records (`traced`).
    A trace that lost at most one record of a function in twenty (c =
    the count over `iters`, rounded), or one, is kept: the function's
    time is its mean recorded duration times c; one that lost more is
    taken again. When no trace is whole, the time is `event_ms`'s, and
    the `profiler` line says so. With `only` (a name or a tuple of
    names), the time is that of the device functions whose name holds
    one of them (a kernel's, where each call first resets the kernel's
    inputs)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    def per_call(e):
        return round(e.count / iters)

    names = (only,) if isinstance(only, str) else only

    def pick(evs):
        return [e for e in evs
                if not names or any(k in e.key for k in names)]

    def whole(evs):
        evs = pick(evs)
        return bool(evs) and all(
            per_call(e) >= 1 and 0 <= per_call(e) * iters - e.count
            <= max(1, per_call(e) * iters // 20) for e in evs)

    evs = traced(run, whole, "timing", keep_last=True)
    if not evs or not whole(evs):
        ms = event_ms(fn, iters)
        PROFILER["event_timed"].append({
            "held": {e.key[:40]: e.count for e in evs}, "iters": iters,
            "ms": ms, "only": only})
        return ms
    evs = pick(evs)
    missing = sum(per_call(e) * iters - e.count for e in evs)
    PROFILER["short"] += missing > 0
    PROFILER["records_missing"] += missing
    us = sum(e.self_device_time_total / e.count * per_call(e) for e in evs)
    check(us > 0, "timing: the trace holds no device time")
    return us / 1e3


def anchored(count_launches, anchor: str):
    """A window's `complete` test for `traced`: the trace holds the
    `anchor` kernel (a kernel its wrapper launches once a call) as often
    as `count_launches()` grew over the window, or one time less (one
    dropped record: busy time short by at most a round's share). Returns
    (run wrapper, complete, note): `note(what)`, called on the trace
    `traced` returned with `keep_last`, records in the `profiler` line
    how many anchor records it lacks when no trace was whole."""
    got = {}

    def wrap(run):
        def counted():
            n0 = count_launches()
            run()
            got["launches"] = count_launches() - n0
        return counted

    def complete(evs):
        n = got.get("launches", 0)
        miss = got["miss"] = n - sum(e.count for e in evs if anchor in e.key)
        got["whole"] = n > 0 and 0 <= miss <= 1
        if got["whole"]:
            PROFILER["short"] += miss
            PROFILER["records_missing"] += miss
        return got["whole"]

    def note(what):
        if not got.get("whole"):
            PROFILER["kept_short"].append({
                "what": what, "anchor": anchor,
                "launches": got.get("launches", 0),
                "anchor_missing": got.get("miss")})
    return wrap, complete, note


def _append_launches():
    from maelstrom_tpu_torch import kernels as K
    return K.REPLY_LOG_APPEND.launches + K.REPLY_LOG_APPEND_I32.launches


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: int) -> float:
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def bound_of(n_bytes: int, n_ops: int) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the int32 operations over the int32 rate."""
    by, op = bound_ms(n_bytes), 1e3 * n_ops / INT32_OPS_PER_S
    return (by, "bytes") if by >= op else (op, "operations")


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


def _program(n, V, per_nb, eager=False, naive=False, latency=0):
    from maelstrom_tpu_torch.nodes import get_program
    return get_program("broadcast",
                       {"topology": "grid", "max_values": V,
                        "gossip_per_neighbor": per_nb,
                        "latency": {"mean": latency}, "eager_resend": eager,
                        "naive_broadcast": naive},
                       [f"n{i}" for i in range(n)], device="cuda")


def _random_channels(g, cfg, sent=False):
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
        lat_clipped=torch.zeros((), dtype=torch.int32, device="cuda"),
        sent=ints() if sent else None)


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


def _random_client(g, N, K, V, p_valid=0.01):
    import torch
    from maelstrom_tpu_torch.net.tpu import Msgs

    def ints(lo, hi):
        return torch.randint(lo, hi, (N, K), generator=g, device="cuda",
                             dtype=torch.int32)
    typ = torch.tensor([10, 10, 12, 0], dtype=torch.int32, device="cuda")[
        torch.randint(0, 4, (N, K), generator=g, device="cuda")]
    return Msgs(valid=torch.rand((N, K), generator=g, device="cuda")
                < p_valid,
                src=ints(N, N + 1), dest=ints(0, N), due=ints(0, 99),
                mid=ints(0, 9999), reply_to=ints(-1, 0), type=typ,
                a=ints(-1, V + 2), b=ints(0, 9), c=ints(0, 9))


def kernel_checks(shape_name, n, V, per_nb, timed, cc=2, p_client=0.01):
    """K1-K4 against their plain versions on random inputs at one shape
    (client requests in a node's inbox with probability `p_client`, K4
    compacting into `cc` slots); returns {kernel: {max_abs_err, ms,
    plain_ms, bound_ms}} (times only when `timed`)."""
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
        cin = _random_client(g, N, Kc, V, p_client)
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

    # K4 reply compaction: a dense round and a sparse one (the main
    # path's); timed on the last
    CC = cc
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


def edge_sent_checks(n=4096, latency=5):
    """K1 and K2 with the `sent` plane tracked, at the ring depth a
    5 ms-latency cluster of up to 4096 nodes gets (10 * 5 + 2 = 52):
    the uniform-arrival form the round calls, with the latency's scalar
    broadcast, and the per-lane form. Exactness only (the journaled path
    runs on clusters of 64 nodes or fewer)."""
    import torch
    from maelstrom_tpu_torch.net import static
    g = torch.Generator(device="cuda")
    g.manual_seed(52)
    prog = _program(n, 64, 4, latency=latency)
    cfg = prog.edge_cfg
    check(cfg.ring == 52 and cfg.uniform_arrival,
          f"the {latency} ms program's channels are {cfg}, not ring 52")
    N, D, L = n, prog.D, cfg.lanes
    rnd = torch.tensor(123, dtype=torch.int32, device="cuda")
    err = 0
    ch = _random_channels(g, cfg, sent=True)
    ck, cp = clone(ch), clone(ch)
    ck, ink = static.edge_read(cfg, ck, prog.neighbors, prog.rev, rnd)
    cp, inp = static.edge_read_plain(cfg, cp, prog.neighbors, prog.rev, rnd)
    torch.cuda.synchronize()
    check(ink.sent is not None, "edge_read dropped the sent plane")
    err = max(err, max_abs_err(ck, cp), max_abs_err(ink, inp))
    per_lane = static.EdgeConfig(n_nodes=N, degree=D, lanes=L, ring=52)
    for wcfg, lat in (
            (cfg, torch.full((), latency, dtype=torch.int32,
                             device="cuda").expand(N, D, L)),
            (per_lane, torch.randint(0, 60, (N, D, L), generator=g,
                                     device="cuda", dtype=torch.int32))):
        ch = _random_channels(g, wcfg, sent=True)
        eo = _random_edge_msgs(g, (N, D, L), 64, 1)
        mask = (torch.rand((N, D, 1), generator=g, device="cuda")
                < 0.9).expand(N, D, L)
        ck, cp = clone(ch), clone(ch)
        static.edge_write(wcfg, ck, eo, rnd, lat, mask)
        static.edge_write_plain(wcfg, cp, eo, rnd, lat, mask)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(ck, cp))
    check(err == 0, f"edge_read / edge_write with the sent plane at ring "
          f"52 differ from their plain versions (max abs err {err})")
    return {"nodes": n, "ring": cfg.ring, "lanes": L, "max_abs_err": err}


LARGE_V = {"nodes": 5, "values": 40_000}


def k3_large_v_checks():
    """K3 past the shared-memory masks of its first design (which refused
    to launch above some 33,000 values): 5 nodes at 40,000 values, every
    mode, with and without the stall mask, against its plain version on
    the card. Returns {kernel@v40000: {max_abs_err, bound_ms}}."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    n, V = LARGE_V["nodes"], LARGE_V["values"]
    g = torch.Generator(device="cuda")
    g.manual_seed(V)
    out = {}
    for mode in ("efficient", "eager", "naive", "naive-all"):
        p = _program(n, V, 4, eager=mode == "eager",
                     naive=mode.startswith("naive"))
        p.skip_sender = mode != "naive-all"
        D, W, Kc = p.D, p.n_windows, p.inbox_cap
        state = {"seen": torch.rand((n, V), generator=g, device="cuda") < .3,
                 "owed": torch.rand((n, D, W), generator=g,
                                    device="cuda") < .3,
                 **{k: torch.rand((n, D, V), generator=g, device="cuda") < .2
                    for k in ("pending", "inflight", "inflight_old")}}
        ein = _random_edge_msgs(g, (n, D, p.edge_cfg.lanes), V, W)
        cin = _random_client(g, n, Kc, V, 0.5)
        stall = torch.rand(n, generator=g, device="cuda") < 0.4
        for ctx in ({"round": torch.tensor(p.retry_rounds * 3 + 1,
                                           dtype=torch.int32,
                                           device="cuda")},
                    {"round": torch.tensor(p.retry_rounds * 3,
                                           dtype=torch.int32,
                                           device="cuda"),
                     "stall": stall}):
            got = p.edge_step(state, ein, cin, ctx)
            with K.forced_plain():
                ref = p.edge_step(state, ein, cin, ctx)
            torch.cuda.synchronize()
            err = max_abs_err(got, ref)
            name = ("broadcast_step_stall" if "stall" in ctx
                    else "broadcast_step")
            check(err == 0, f"{name} ({mode}) at {V} values on {n} nodes "
                  f"differs from its plain version (max abs err {err})")
            r = out.setdefault(f"{name}@v{V}", {"max_abs_err": 0,
                                                "modes": []})
            r["modes"].append(mode)
    return out


def scan_kernel_checks(timed):
    """K5 reply_log_append and K6 quiet_probe against their plain
    versions at the 100,000-node CLI run's shapes: client messages CW =
    400,000 (the pool's 200,000 client rows and the 200,000 compacted
    replies), a log of rcap = 800,000 rows with W = 32 payload words of
    a [100,000, 1024] seen plane; the quiescence planes of the flight
    pool (800,000), the channels ([100,000, 4, 2, 5]) and the program
    (3 x [100,000, 4, 1024]). Returns {kernel: {max_abs_err, ms,
    plain_ms, bound_ms}} (times only when `timed`), K5 timed on a round
    with a handful of replies (the main path's common round) and K6 on
    a quiet state (it reads every byte)."""
    import torch
    from maelstrom_tpu_torch import sim as S
    from maelstrom_tpu_torch.net.tpu import Msgs
    from maelstrom_tpu_torch.runner.tpu_runner import (quiet_probe,
                                                       quiet_probe_plain)
    g = torch.Generator(device="cuda")
    g.manual_seed(400_000)
    N, V, W, CW = 100_000, 1024, 32, 400_000
    rcap = 2 * CW
    seen = torch.rand((N, V), generator=g, device="cuda") < 0.5
    rnd = torch.tensor(4321, dtype=torch.int32, device="cuda")
    out = {}

    def cm_of(p_valid):
        def ints(lo, hi):
            return torch.randint(lo, hi, (CW,), generator=g, device="cuda",
                                 dtype=torch.int32)
        return Msgs(valid=torch.rand(CW, generator=g, device="cuda")
                    < p_valid, src=ints(-5, N + 5), dest=ints(N, 2 * N),
                    due=ints(0, 999), mid=ints(0, 1 << 30),
                    reply_to=ints(-1, 1 << 30), type=ints(0, 20),
                    a=ints(-9, 9), b=ints(-2**31, 2**31 - 1),
                    c=ints(-2**31, 2**31 - 1))

    def fresh(rn0):
        log = S.empty_reply_log(rcap, W, "cuda")
        return log[:3] + (torch.tensor(rn0, dtype=torch.int32,
                                       device="cuda"),)

    err = 0
    # the final reads' round (100,000 of 400,000 valid), one past the
    # log's end (rows dropped), and the common sparse round
    for p_valid, rn0, k, k_max, stop in ((0.25, 0, 3, 9, True),
                                         (0.25, 700_000, 5, 9, False),
                                         (5.0 / CW, 1234, 9, 9, False)):
        cm = cm_of(p_valid)
        logs, exits, rns = [], [], []
        for fn in (S.append_replies, S.append_replies_plain):
            log = fresh(rn0)
            ek = torch.full((), 2**31 - 1, dtype=torch.int32, device="cuda")
            rns.append(fn(log, cm, seen, N, rnd, k, k_max, stop, ek))
            logs.append(log[:3])
            exits.append(ek)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(logs[0], logs[1]),
                  max_abs_err(rns[0], rns[1]),
                  max_abs_err(exits[0], exits[1]))
    check(err == 0, f"reply_log_append differs from its plain version "
          f"(max abs err {err})")
    n_valid = int(cm.valid.sum())
    r = {"max_abs_err": err,
         # cm's valid bytes, then for each valid row its 9 int fields
         # read, its log row written (1 + 9 * 4 + 4 stamp + 4 W payload)
         # and its seen row read
         "bound_ms": bound_ms(CW + n_valid * (36 + 41 + 4 * W + V)),
         "valid_rows": n_valid}
    if timed:
        log, ek = fresh(1234), torch.zeros((), dtype=torch.int32,
                                           device="cuda")
        r["ms"] = cuda_ms(lambda: S.append_replies(
            log, cm, seen, N, rnd, 9, 9, False, ek))
        r["plain_ms"] = cuda_ms(lambda: S.append_replies_plain(
            log, cm, seen, N, rnd, 9, 9, False, ek))
    out["reply_log_append"] = r

    planes = [torch.zeros(800_000, dtype=torch.bool, device="cuda"),
              torch.zeros((N, 4, 2, 5), dtype=torch.bool, device="cuda")] + [
        torch.zeros((N, 4, V), dtype=torch.bool, device="cuda")
        for _ in range(3)]
    err = 0
    for i, p in enumerate(planes):
        for at in (0, p.numel() // 3 + 7, p.numel() - 1):
            p.view(-1)[at] = True
            got, ref = quiet_probe(planes), quiet_probe_plain(planes)
            torch.cuda.synchronize()
            err = max(err, int(got) != int(ref), int(got) != 0)
            p.view(-1)[at] = False
    got, ref = quiet_probe(planes), quiet_probe_plain(planes)
    torch.cuda.synchronize()
    err = max(err, int(got) != int(ref), int(got) != 1)
    check(err == 0, "quiet_probe differs from its plain version")
    r = {"max_abs_err": err, "bound_ms": bound_ms(nbytes(*planes))}
    if timed:
        r["ms"] = cuda_ms(lambda: quiet_probe(planes))
        r["plain_ms"] = cuda_ms(lambda: quiet_probe_plain(planes))
    out["quiet_probe"] = r
    return out


# name, nodes, values, gossip per neighbour, K4 slots, client density
BENCH_SHAPE = ("bench", 100_000, 64, 1, 2, 0.01)
GRAFT_SHAPE = ("graft", 1024, 32, 4, 2, 0.01)
# the 100,000-node CLI run at its defaults: 1024 values, 4 gossip lanes,
# client_cap 200,000; the final reads put a request in every node's
# inbox
CLI_SHAPE = ("cli100k", 100_000, 1024, 4, 200_000, 0.5)


def phase_kernels(shapes, timed, with_scan=False):
    res = {}
    for shape_name, n, V, per_nb, cc, p_client in shapes:
        t0 = time.perf_counter()
        r = kernel_checks(shape_name, n, V, per_nb, timed, cc, p_client)
        if with_scan and shape_name == "cli100k":
            r.update(scan_kernel_checks(timed))
        line = {"phase": "kernels_vs_plain", "shape": shape_name,
                "nodes": n, "values": V, "gossip_per_neighbor": per_nb,
                "client_slots": cc, "timed": timed,
                "seconds": time.perf_counter() - t0, "kernels": r}
        if not timed and shape_name == "graft":
            line["edge_sent"] = edge_sent_checks()
            r.update(k3_large_v_checks())
            line["large_v"] = LARGE_V
        emit(line)
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
    grew = {k: K.launch_counts()[k] - before[k] for k in ROUND_KERNELS}
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
          f"graft path did not launch every round kernel: {grew}")
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
    """Slice 1's main path: the 100,000-node bench in both modes, with
    every launch counter set to 0 just before and read just after; it
    runs the round's kernels K1-K4."""
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch.bench import run_broadcast_bench
    K.reset_launches()
    rec = run_broadcast_bench(n_nodes=100_000, values=64, rounds=700,
                              gossip=1, pool=8192, eager=True, seed=1)
    launches = K.launch_counts()
    _bench_checks(rec)
    check(all(launches[k] > 0 for k in ROUND_KERNELS),
          f"the bench did not launch every round kernel: {launches}")
    emit({"phase": "bench_100k", **_bench_line(rec, smi,
                                               {"launches": launches})})
    return launches


# the round's kernels (K1-K4); the CLI runner adds K5 and K6
ROUND_KERNELS = ("edge_read", "edge_write", "broadcast_step",
                 "reply_compact")
CLI_KERNELS = ROUND_KERNELS + ("reply_log_append", "quiet_probe")

# The port's CLI on the three parity configurations of
# tests/test_torch_runner.py (the e2e tests' grid and line runs, the
# README's tree4 run without its nemesis), here at the default 1024-value
# table, and a 1024-node run (64 values, to keep its JAX reference short
# on the CPU) whose client_cap (2048) fills the kernels' 4096-row client
# batches, at 5 ms a round (its 10 s recovery window, which the CLI has
# no flag for, was 10,000 of its 11,002 rounds; `CLI_SMALL_REDUCED`)
CLI_BASE = ["test", "-w", "broadcast", "--node", "tpu:broadcast", "--seed",
            "7", "--rate", "20"]
CLI_SMALL = [
    ("grid5", CLI_BASE + ["--node-count", "5", "--topology", "grid",
                          "--time-limit", "1"]),
    ("line8-latency5", CLI_BASE + ["--node-count", "8", "--topology",
                                   "line", "--latency", "5",
                                   "--time-limit", "1"]),
    ("tree4-25-latency10", CLI_BASE + ["--node-count", "25", "--topology",
                                       "tree4", "--latency", "10",
                                       "--time-limit", "1"]),
    ("grid1024", CLI_BASE + ["--node-count", "1024", "--topology", "grid",
                             "--time-limit", "1", "--max-values", "64",
                             "--ms-per-round", "5"]),
]
CLI_SMALL_REDUCED = {
    "grid5": {"time_limit_s": 1.0, "from": 2.0, "rounds_executed_from": 2002,
              "why": WHY_SERVICES + ": the main phase halved, its 10 s "
                     "recovery window (bumped, not executed) kept"},
    "line8-latency5": {"time_limit_s": 1.0, "from": 2.0,
                       "rounds_executed_from": 2002,
                       "why": WHY_SERVICES + ": the main phase halved"},
    "grid1024": {
    "ms_per_round": 5.0, "from": 1.0,
    "model_change": "more than a cut in depth: a gossip hop, one round, "
                    "takes 5 ms of virtual time (was 1 ms), so the stagger "
                    "and the recovery window span a fifth of the rounds"}}
# sha256 of the JAX runner's history.jsonl for each run above, on the
# CPU (`python -m maelstrom_tpu <args> --no-audit`); re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_runner.py -m slow
PINNED_CLI = {
    "grid5": "4d95556c47fba422610288961c70b2183304e1d264beb2b0dfb782669f48b1ad",
    "line8-latency5":
        "c0118dbcaa402ac83871f34dcb48ee5688b1d499af4419fb0b0def4668e4e5ae",
    "tree4-25-latency10":
        "631347a029cbc7d046645531e9c91b64d854c99726752f17eeccc12b2e1f01f3",
    "grid1024":
        "b165f83d1e9b950de7e039a017f1f1e84a324f82d47f915e4a231f7b45796cf6",
}

# The port's CLI under faults on runs small enough for the JAX runner on a
# CPU (64-value tables, journaled but the 1024-node run): the README's
# tree4 run with its partition nemesis, a 5-node grid storm (exponential
# latency, loss and all five fault packages) and a 1024-node grid run
# under uniform latency, loss and four fault packages (its spill write is
# K9's main path), at 2 ms a round (`CLI_FAULTS_SMALL_REDUCED`:
# half the rounds of its 10 s recovery window; latency 5 ms is 3 rounds).
# The storm and the 1024-node run with a 1 s client timeout (from the
# CLI's 5 s, where stragglers held both runs; `CLI_FAULTS_SMALL_REDUCED`).
# tests/test_torch_runner_faults.py holds the first two against the JAX
# runner on the CPU.
CLI_FAULT_BASE = CLI_BASE + ["--max-values", "64"]
CLI_FAULTS_SMALL = [
    ("tree4-25-partition", CLI_FAULT_BASE + [
        "--node-count", "25", "--topology", "tree4", "--latency", "10",
        "--nemesis", "partition", "--nemesis-interval", "0.5",
        "--time-limit", "1"]),
    ("grid5-storm", CLI_FAULT_BASE + [
        "--node-count", "5", "--topology", "grid", "--seed", "23",
        "--latency", "3", "--latency-dist", "exponential", "--p-loss",
        "0.02", "--nemesis", "partition,kill,pause,duplicate,weather",
        "--nemesis-interval", "0.5", "--time-limit", "4",
        "--timeout-ms", "1000"]),
    ("grid1024-faults", CLI_FAULT_BASE + [
        "--node-count", "1024", "--topology", "grid", "--latency", "5",
        "--latency-dist", "uniform", "--p-loss", "0.01", "--nemesis",
        "partition,kill,pause,duplicate", "--nemesis-interval", "1",
        "--time-limit", "2", "--ms-per-round", "2", "--timeout-ms",
        "1000"]),
]
CLI_FAULTS_SMALL_REDUCED = {
    "tree4-25-partition": {
        "time_limit_s": 1.0, "from": 2.0, "rounds_executed_from": 2258,
        "why": WHY_SERVICES + ": the 0.5 s nemesis interval kept, so "
               "one partition (0.5-1 s) where there were two; "
               "dropped-partition still shows"},
    "grid5-storm": {
    "timeout_ms": 1000, "from": 5000, "rounds_executed": 4805,
    "rounds_from": 10982,
    "why": "to pay for the stream slice: two stragglers (an op of the "
           "main phase to a paused node, a final read) each held the run "
           "5 s at their timeout, 10,000 of its 10,982 executed rounds "
           "waiting; at 1 s the five packages still cycle four times and "
           "every fault counter still shows (the time limit, 4 s, and "
           "the 0.5 s nemesis interval kept: cutting the time limit "
           "removes no executed round)"},
    "grid1024-faults": {
    "ms_per_round": 2.0, "from": 1.0,
    "model_change": "more than a cut in depth: the uniform 5 ms latency "
                    "is drawn over a 2.5-round mean (was 5 rounds), and "
                    "K9's ring follows it (244, was 404): the network "
                    "modelled differs from the run at 1 ms a round",
    "timeout_ms": 1000, "timeout_from": 5000, "rounds_executed": 1748,
    "rounds_from": 5748,
    "why": "to pay for the stream slice: stragglers held the run at "
           "their 5 s timeouts, 4,000 of its 5,748 executed rounds; the "
           "time limit and the nemesis interval kept, every fault "
           "counter and the spill write still show"}}
# sha256 of the JAX runner's history.jsonl for each run above, on the CPU
# (`python -m maelstrom_tpu <args> --no-audit`); re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_runner_faults.py \
#       -m slow
PINNED_FAULTS = {
    "tree4-25-partition":
        "c65e46afb14055667fa4c0c1f45a72b39ec597fd479da627337ed3007956f6ed",
    "grid5-storm":
        "4abdb44c147eda668ab41e9670e45e090c5dc53e76f89215537046c86cab99c2",
    "grid1024-faults":
        "92c185cbf733468db432401888a504b69906f3f9a8d86f74bda21f62615b1007",
}

# The slice's full-width run: the README's 100,000-node broadcast at the
# CLI's defaults (grid, latency 0, rate 5, concurrency = node count:
# client_cap 200,000, pool 800,000), on one card, through `core.run`
# (the CLI has no flag for the recovery window), cut in depth
# (`CLI_100K_REDUCED`: node count kept) so the smoke, which also runs the
# later slices, stays inside its own time limit: the time limit from
# 10 s to 2 s, and the recovery window, most of the run's 12,002
# rounds, from 10 s to 2 s and then to 1 s (to pay for the
# batched-broadcast phases; the grid's diameter is some 630 rounds of
# gossip; a 1 s run has a single broadcast to check).
CLI_100K = {"workload": "broadcast", "node": "tpu:broadcast",
            "node_count": 100_000, "time_limit": 2.0, "recovery_s": 1.0}
CLI_100K_REDUCED = {"time_limit_s": 2.0, "from": 10.0, "recovery_s": 1.0,
                    "recovery_from": 10.0}


def _cli_run(args, store):
    """The port's CLI in this process (its prints go to stderr); returns
    (exit code, store dir, results, timing, history bytes, wall s)."""
    import contextlib
    import hashlib
    from maelstrom_tpu_torch import cli
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main(args + ["--store", store])
    wall = time.perf_counter() - t0
    d = os.path.realpath(os.path.join(store, "latest"))
    with open(os.path.join(d, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(d, "timing.json")) as f:
        timing = json.load(f)
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return rc, d, results, timing, digest, wall


def _cli_checks(name, rc, results, timing):
    check(rc == 0 and results["valid"] is True,
          f"cli {name}: exit {rc}, valid {results.get('valid')}")
    check(results["net"]["dropped-overflow"] == 0,
          f"cli {name}: pool overflow")
    check(timing["drains"] < timing["final-round"] / 4,
          f"cli {name}: {timing['drains']} host drains for "
          f"{timing['final-round']} rounds")


def phase_cli_small():
    """The port's CLI through the kernels on the pinned runs: each
    history.jsonl must hash to the JAX runner's."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke")
    shutil.rmtree(store, ignore_errors=True)
    K.reset_launches()
    runs = {}
    for name, args in CLI_SMALL:
        rc, _d, res, tm, digest, wall = _cli_run(args, store)
        _cli_checks(name, rc, res, tm)
        check(digest == PINNED_CLI[name],
              f"cli {name}: history.jsonl sha256 {digest}, the JAX "
              f"runner's {PINNED_CLI[name]}")
        runs[name] = {"reduced": CLI_LINKV_REDUCED.get(name),
                      "wall_s": wall, "final_round": tm["final-round"],
                      "rounds_executed": tm["rounds-executed"],
                      "dispatches": tm["dispatches"], "drains": tm["drains"],
                      "history_sha256_equal": True,
                      "reduced": CLI_SMALL_REDUCED.get(name)}
    launches = K.launch_counts()
    check(all(launches[k] > 0 for k in CLI_KERNELS),
          f"cli_small did not launch every kernel: {launches}")
    emit({"phase": "cli_small", "runs": runs, "launches": launches})


def phase_cli_100k(smi):
    """Slice 2's main path: the 100,000-node test at the CLI's defaults
    (through `core.run`, cut in depth), with every launch counter set to
    0 just before and read just after."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_100k")
    shutil.rmtree(store, ignore_errors=True)
    K.reset_launches()
    rc, d, res, tm, _digest, wall = _core_run(CLI_100K, store)
    launches = K.launch_counts()
    _cli_checks("100k", rc, res, tm)
    check(res["workload"]["valid"] is True and res["workload"][
        "lost-count"] == 0, f"cli 100k: workload {res['workload']}")
    check(all(launches[k] > 0 for k in CLI_KERNELS),
          f"the 100,000-node CLI run did not launch every kernel: "
          f"{launches}")
    delivered = res["net"]["all"]["recv-count"]
    host_s = (tm["poll-s"] + tm["replies-s"] + tm["journal-s"]
              + tm["check-s"] + tm["store-s"])
    emit({"phase": "cli_100k", "opts": CLI_100K,
          "reduced": CLI_100K_REDUCED,
          "valid": res["valid"], "wall_s": wall,
          "scan_s": tm["scan-s"], "drain_s": tm["drain-s"],
          "quiet_s": tm["quiet-s"], "host_s": host_s,
          "generator_s": tm["poll-s"], "replies_s": tm["replies-s"],
          "check_s": tm["check-s"], "store_s": tm["store-s"],
          "final_round": tm["final-round"],
          "rounds_executed": tm["rounds-executed"],
          "rounds_bumped": tm["rounds-bumped"],
          "ms_per_executed_round": 1e3 * tm["scan-s"]
          / max(tm["rounds-executed"], 1),
          "dispatches": tm["dispatches"], "drains": tm["drains"],
          "quiet_probes": tm["quiet-probes"], "bumps": tm["bumps"],
          "scan_host_syncs": tm["scan-host-syncs"],
          "scan_replayed_rounds": tm["scan-replayed-rounds"],
          "history_ops": tm["history-ops"],
          "messages_delivered": delivered,
          "msgs_per_sec": delivered / wall,
          "dropped_overflow": res["net"]["dropped-overflow"],
          "stable_latencies": res["workload"]["stable-latencies"],
          "stable_count": res["workload"]["stable-count"],
          "launches": launches, "nvidia_smi": smi})
    shutil.rmtree(store, ignore_errors=True)
    return launches


def phase_cli_profile(faults=False):
    """Device busy time of the 100,000-node CLI run's scan rounds: the
    runner's own program, config and scan fn (reply log, CC 200,000,
    pool 800,000), 50 broadcasts injected, 200 rounds untraced so gossip
    is in flight, then 40 rounds timed on the host clock and 40 traced
    with torch.profiler. Idle share = 1 - busy / host ms a round. Also
    times the runner's two torch-op helpers at this shape: the bump
    (round += k) and the packer (the dispatch's log and next_mid
    concatenated for one copy to the host), each against the bytes it
    must move. With `faults`, the run is CLI_FAULTS_100K's config with
    its faults installed as `_fault_net` makes them."""
    import torch
    from maelstrom_tpu_torch import core
    from maelstrom_tpu_torch.nodes.broadcast import T_BCAST
    from maelstrom_tpu_torch.runner.tpu_runner import TpuRunner
    from maelstrom_tpu_torch.sim import make_scan_fn
    from maelstrom_tpu_torch.tree import leaves
    opts = {"workload": "broadcast", "node": "tpu:broadcast",
            "node_count": 100_000, "journal_rows": False}
    if faults:
        opts.update(latency={"mean": 5, "dist": "uniform"}, p_loss=0.01,
                    nemesis={"kill", "pause", "duplicate"})
    runner = TpuRunner(core.build_test(opts))
    prog, cfg = runner.program, runner.cfg
    if faults:
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        fnet = _fault_net(cfg, "cuda", g)
        runner.sim = runner.sim.replace(net=runner.sim.net.replace(
            p_loss=fnet.p_loss, p_dup=fnet.p_dup, down=fnet.down,
            paused=fnet.paused))
    scan = make_scan_fn(prog, cfg, reply_cap=runner.reply_log_cap,
                        device=runner.device)
    rows = [(p, {}, (p * 2654435761) % cfg.n_nodes, T_BCAST, p, 0, 0)
            for p in range(50)]
    inject = runner._encode_inject(rows)
    empty = runner._encode_inject([])
    sim, _cm, _k, log = scan(runner.sim, inject, 200, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = scan(sim, empty, 40, False)[0]
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / 40
    state = {"sim": sim}

    def window():
        state["sim"] = scan(state["sim"], empty, 40, False)[0]
    # K5 appends once a round: the trace holds its kernel as often
    wrap, complete, note = anchored(_append_launches, "append_kernel")
    evs = traced(wrap(window), complete, "cli profile", keep_last=True)
    note("cli profile")
    sim = state["sim"]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3 / 40
    check(busy_ms > 0, "cli profile: the trace holds no device time")
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:12]
    runner.sim = sim
    tree = ((), log, sim.net.next_mid)
    pack, _unpack = runner._make_packer(tree)
    packed_bytes = nbytes(pack(tree))
    helpers = {
        "bump": {"ms": cuda_ms(lambda: runner._bump(1)),
                 "bound_ms": bound_ms(8)},
        "packer": {"ms": cuda_ms(lambda: pack(tree)),
                   # every leaf read once, the packed array written once
                   "bound_ms": bound_ms(nbytes(*[t for _p, t in
                                                 leaves(tree)])
                                        + packed_bytes),
                   "packed_bytes": packed_bytes}}
    emit({"phase": "cli_faults_profile" if faults else "cli_profile",
          "rounds": 40,
          "host_ms_per_round": host_ms,
          "device_busy_ms_per_round": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / host_ms),
          "top": [{"name": e.key[:60],
                   "ms_per_round": e.self_device_time_total / 1e3 / 40,
                   "calls_per_round": e.count / 40} for e in top],
          "helpers": helpers})


# --- the fault slice ---------------------------------------------------------

# The 100,000-node fault run's shapes (CLI_FAULTS_100K): grid, 1024
# values, 4 gossip lanes + the digest lane, concurrency 100,000, uniform
# latency (no spill past 4,096 nodes), duplication and stall compiled in;
# and the 1024-node spill shape of the pinned grid1024-faults run (at 2 ms
# a round: ring ceil(5 / 2) * 8 * 10 + 2 + 2 = 244, 10 channel lanes for 5
# out lanes)
FAULT_SHAPE = {"nodes": 100_000, "values": 1024, "lanes": 5,
               "clients": 100_000}
SPILL_SHAPE = {"nodes": 1024, "ring": 244, "channel_lanes": 10,
               "out_lanes": 5}


def _fault_net(cfg, dev, g):
    """A net with the fault run's faults installed: 1% loss, duplication
    at 0.25, about a third of the nodes killed or paused."""
    import torch
    from maelstrom_tpu_torch.net import tpu as T
    N = cfg.n_nodes
    net = T.set_duplication(T.flaky(T.make_net(cfg, dev), 0.01), 0.25)
    down = torch.rand(N, generator=g, device=dev) < 0.2
    paused = torch.rand(N, generator=g, device=dev) < 0.15
    return net.replace(down=down, paused=paused)


def fault_kernel_checks(timed):
    """K7, K8 and K3 with its stall mask at the 100,000-node fault run's
    shapes, K9 at the 1024-node spill shape, each against its plain
    version on the card (`forced_plain`). K7 is timed as one round's
    draws (the round's split of 7, the pool send's split of 4, and its
    four draws over the 100,000 client rows); K8 as the round's edge
    fault pass over [100,000, 4, 5] lanes. Returns {kernel:
    {max_abs_err, bound_ms, bound_by[, ms, plain_ms]}}."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch import sim as S
    from maelstrom_tpu_torch.net import static
    from maelstrom_tpu_torch.net import tpu as T
    g = torch.Generator(device="cuda")
    g.manual_seed(31)
    out = {}
    N, V, M = FAULT_SHAPE["nodes"], FAULT_SHAPE["values"], \
        FAULT_SHAPE["clients"]
    prog = _program(N, V, 4, latency=5)
    D, L = prog.D, prog.lanes
    cfg = T.NetConfig(n_nodes=N, n_clients=M, latency_mean_rounds=5.0,
                      latency_dist="uniform", enable_stall=True,
                      enable_duplication=True)
    net = _fault_net(cfg, "cuda", g)
    key = prng.PRNGKey(77, "cuda")

    def record(name, err, n_bytes, n_ops, fn_k, fn_p, extra=None):
        check(err == 0, f"{name} differs from its plain version (max abs "
              f"err {err})")
        b, by = bound_of(n_bytes, n_ops)
        r = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
             **(extra or {})}
        if timed:
            r["ms"] = cuda_ms(fn_k)
            with K.forced_plain():
                r["plain_ms"] = cuda_ms(fn_p)
        out[name] = r

    # K7: one round's draws on the pool path
    lat_spec = ("latency", "uniform", 5.0, net.latency_scale)

    def k7_round():
        keys = prng.split(key, 7)
        ks = prng.split(keys[1], 4)
        return (keys, ks) + tuple(prng.draws(
            ks, M, [lat_spec, ("mask", net.p_loss),
                    ("mask", net.p_dup), lat_spec]))
    got = k7_round()
    with K.forced_plain():
        ref = k7_round()
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    record("threefry", err, 11 * 8 + M * (4 + 1 + 1 + 4), (11 + 4 * M)
           * DRAW_OPS, k7_round, k7_round, {"draws": 4 * M + 11})

    # K8: the round's edge faults
    valid = torch.rand((N, D, L), generator=g, device="cuda") < 0.3
    keys = prng.split(key, 7)

    def k8():
        return S.edge_faults(cfg, prog.neighbors, net, valid, keys)
    got = k8()
    with K.forced_plain():
        ref = k8()
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    n_el = N * D * L
    # reads: valid lanes, neighbours, the component labels, down and
    # paused; writes: deliver, lat, dup, dup_lat
    record("edge_faults", err,
           n_el + N * D * 4 + N * 4 + 2 * N + n_el * (1 + 4 + 1 + 4) + 32,
           4 * n_el * DRAW_OPS, k8, k8, {"lanes": n_el})

    # K3 with the stall mask, efficient mode at V 1024
    p = _program(N, V, 4)
    W, Kc = p.n_windows, p.inbox_cap
    state = {"seen": torch.rand((N, V), generator=g, device="cuda") < .3,
             "owed": torch.rand((N, D, W), generator=g, device="cuda") < .3,
             **{k: torch.rand((N, D, V), generator=g, device="cuda") < .2
                for k in ("pending", "inflight", "inflight_old")}}
    ein = _random_edge_msgs(g, (N, D, p.edge_cfg.lanes), V, W)
    cin = _random_client(g, N, Kc, V, 0.01)
    stall = net.down | net.paused
    rnd = torch.tensor(p.retry_rounds * 3, dtype=torch.int32, device="cuda")
    ctx = {"round": rnd, "stall": stall}

    def k3():
        return p.edge_step(state, ein, cin, ctx)
    got = k3()
    with K.forced_plain():
        ref = k3()
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    so, eo, co = got
    io = (nbytes(*state.values(), stall, p.neighbors,
                 *[getattr(ein, f) for f in ("valid", "type", "a", "b",
                                             "c")],
                 *[getattr(cin, f) for f in ("valid", "src", "due", "mid",
                                             "type", "a", "b", "c")])
          + nbytes(*so.values(), *[getattr(eo, f) for f in
                                   ("valid", "type", "a", "b", "c")],
                   *[getattr(co, f) for f in ("valid", "src", "dest", "due",
                                              "mid", "reply_to", "type",
                                              "a", "b", "c")]))
    record("broadcast_step_stall", err, io, 0, k3, k3,
           {"stalled_nodes": int(stall.sum())})

    # K9 at the 1024-node spill shape
    sp = _program(SPILL_SHAPE["nodes"], 64, 4, latency=5)
    Ns, Ds = SPILL_SHAPE["nodes"], sp.D
    R, Lc, Lo = (SPILL_SHAPE["ring"], SPILL_SHAPE["channel_lanes"],
                 SPILL_SHAPE["out_lanes"])
    wcfg = static.EdgeConfig(n_nodes=Ns, degree=Ds, lanes=Lc, ring=R,
                             spill=True)
    occ = torch.randint(0, 3, (Ns, Ds, R, 1), generator=g, device="cuda")
    ch = _random_channels(g, wcfg, sent=True)
    ch.valid.copy_(torch.arange(Lc, device="cuda") < occ)
    eo = _random_edge_msgs(g, (Ns, Ds, Lo), 64, 1)
    lat = torch.randint(0, 11, (Ns, Ds, Lo), generator=g, device="cuda",
                        dtype=torch.int32)
    mask = torch.rand((Ns, Ds, 1), generator=g, device="cuda") < 0.9
    rnd = torch.tensor(321, dtype=torch.int32, device="cuda")
    ck, cp = clone(ch), clone(ch)
    static.edge_write(wcfg, ck, eo, rnd, lat, mask)
    with K.forced_plain():
        static.edge_write(wcfg, cp, eo, rnd, lat, mask)
    torch.cuda.synchronize()
    err = max_abs_err(ck, cp)
    ok_lanes = int((eo.valid & mask).sum())
    # out lanes read (valid, latency, mask), for each written lane its
    # cell's Lc valid bytes and 21 bytes written (valid, 4 fields, sent)
    # timed on the written channels again (in place: the cells fill up,
    # the work of a call stays the same)
    record("edge_write_spill", err,
           Ns * Ds * Lo * 5 + Ns * Ds + ok_lanes * (Lc + 21), 0,
           lambda: static.edge_write(wcfg, ck, eo, rnd, lat, mask),
           lambda: static.edge_write(wcfg, cp, eo, rnd, lat, mask))
    return out


def phase_fault_kernels(timed):
    t0 = time.perf_counter()
    r = fault_kernel_checks(timed)
    emit({"phase": "kernels_vs_plain", "shape": "faults", "timed": timed,
          "fault_shape": FAULT_SHAPE, "spill_shape": SPILL_SHAPE,
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


def phase_prng_pins():
    """K7's bits and latency rounds against the hashes of jax.random's."""
    import hashlib
    import numpy as np
    import torch
    from maelstrom_tpu_torch import prng
    key = prng.PRNGKey(42, "cuda")
    one = torch.ones((), dtype=torch.float32, device="cuda")
    n = PRNG_PIN_N
    got = {"bits": prng.random_bits(key, (n,)),
           "uniform_rounds": prng.latency_rounds(key, (n,), "uniform", 5.0,
                                                 one),
           "exponential_rounds": prng.latency_rounds(
               key, (n,), "exponential", 3.0, one)}
    dig = {}
    for k, t in got.items():
        a = t.cpu().numpy()
        a = a.astype("<u4" if k == "bits" else "<i4")
        dig[k] = hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                ).hexdigest()
        check(dig[k] == PINNED_PRNG[k], f"prng pin {k}: {dig[k]}, jax's "
              f"{PINNED_PRNG[k]}")
    emit({"phase": "prng_pins", "draws": n, "equal": True})


def phase_cli_faults_small():
    """The port's CLI under faults through the kernels on the pinned runs:
    each history.jsonl must hash to the JAX runner's. The 1024-node run
    is K9's path (randomized latency on 4,096 nodes or fewer); its launch
    counts are read here."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_faults")
    shutil.rmtree(store, ignore_errors=True)
    K.reset_launches()
    runs = {}
    for name, args in CLI_FAULTS_SMALL:
        rc, _d, res, tm, digest, wall = _cli_run(args, store)
        _cli_checks(name, rc, res, tm)
        check(digest == PINNED_FAULTS[name],
              f"cli {name}: history.jsonl sha256 {digest}, the JAX "
              f"runner's {PINNED_FAULTS[name]}")
        runs[name] = {"wall_s": wall, "final_round": tm["final-round"],
                      "rounds_executed": tm["rounds-executed"],
                      "dispatches": tm["dispatches"], "drains": tm["drains"],
                      "nemesis_ops": tm["nemesis-ops"],
                      "faults": {k: res["net"][k] for k in
                                 ("lost", "dropped-partition",
                                  "dropped-down", "duplicated",
                                  "channel-overwrites", "latency-clipped")},
                      "history_sha256_equal": True,
                      "reduced": CLI_FAULTS_SMALL_REDUCED.get(name)}
    launches = K.launch_counts()
    check(launches["edge_write_spill"] > 0,
          f"cli_faults_small did not launch the spill write: {launches}")
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_faults_small", "runs": runs, "launches": launches})
    return launches


# Slice 3's main path: the 100,000-node test under 1% loss, uniform
# latency of mean 5 ms and the kill, pause and duplicate nemeses, at the
# CLI's other defaults (grid, rate 5, 1024 values, concurrency 100,000),
# through `core.run` (the CLI has no flag for the recovery window), cut
# in depth to a 1 s time limit with a nemesis op every 0.25 s (from 10 s
# and 2 s; the same four ops of the same decision streams) and a 2 s
# recovery window (from 10 s, then 3 s; the last value was
# stable 344 ms after its send in a 2 s run), node count, faults and
# latency kept, so the smoke, which also runs the later slices, stays
# inside its time limit. No partition or weather at this size: the JAX
# package's partitions are an N x N block matrix built by Python loops,
# and weather's slow fronts need ring headroom it gives only to clusters
# of 4,096 nodes or fewer. A 1 s client timeout (from 5 s) since the
# stream slice: stragglers held the run at their timeouts, 10,390
# executed rounds of a 12,699-round run.
CLI_FAULTS_100K = {"workload": "broadcast", "node": "tpu:broadcast",
                   "node_count": 100_000,
                   "latency": {"mean": 5, "dist": "uniform"},
                   "p_loss": 0.01, "nemesis": {"kill", "pause", "duplicate"},
                   "nemesis_interval": 0.25, "time_limit": 1.0,
                   "recovery_s": 2.0, "timeout_ms": 1000}
CLI_FAULTS_100K_REDUCED = {"time_limit_s": 1.0, "from": 10.0,
                           "nemesis_interval_s": 0.25, "interval_from": 2.0,
                           "recovery_s": 2.0, "recovery_from": 10.0,
                           "timeout_ms": 1000, "timeout_from": 5000,
                           "rounds_from": 10390}
FAULT_PATH_KERNELS = ("threefry", "edge_faults", "broadcast_step_stall")


def phase_cli_faults_100k(smi):
    """The fault slice's main path, with every launch counter set to 0
    just before and read just after."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_faults_100k")
    shutil.rmtree(store, ignore_errors=True)
    K.reset_launches()
    rc, d, res, tm, _digest, wall = _core_run(CLI_FAULTS_100K, store)
    launches = K.launch_counts()
    _cli_checks("faults 100k", rc, res, tm)
    w, net = res["workload"], res["net"]
    check(w["valid"] is True and w["lost-count"] == 0,
          f"cli faults 100k: workload {w}")
    check(net["latency-clipped"] == 0, "cli faults 100k: clipped draws")
    for k in FAULT_PATH_KERNELS + ("edge_read", "edge_write"):
        check(launches[k] > 0, f"the 100,000-node fault run did not launch "
              f"{k}: {launches}")
    for k in ("lost", "dropped-down", "duplicated"):
        check(net[k] > 0, f"cli faults 100k: no {k}")
    fs = set()
    with open(os.path.join(d, "history.jsonl")) as f:
        for line in f:
            if '"nemesis"' in line:
                op = json.loads(line)
                if op.get("type") == "info":
                    fs.add(op["f"])
    check({"start-kill", "start-pause", "start-duplicate"} <= fs,
          f"cli faults 100k: nemesis ops {sorted(fs)}")
    host_s = (tm["poll-s"] + tm["replies-s"] + tm["journal-s"]
              + tm["check-s"] + tm["store-s"] + tm["nemesis-s"])
    emit({"phase": "cli_faults_100k",
          "opts": {**CLI_FAULTS_100K,
                   "nemesis": sorted(CLI_FAULTS_100K["nemesis"])},
          "reduced": CLI_FAULTS_100K_REDUCED,
          "valid": res["valid"], "wall_s": wall,
          "scan_s": tm["scan-s"], "drain_s": tm["drain-s"],
          "quiet_s": tm["quiet-s"], "host_s": host_s,
          "generator_s": tm["poll-s"], "replies_s": tm["replies-s"],
          "nemesis_s": tm["nemesis-s"], "nemesis_ops": tm["nemesis-ops"],
          "check_s": tm["check-s"], "store_s": tm["store-s"],
          "final_round": tm["final-round"],
          "rounds_executed": tm["rounds-executed"],
          "rounds_bumped": tm["rounds-bumped"],
          "ms_per_executed_round": 1e3 * tm["scan-s"]
          / max(tm["rounds-executed"], 1),
          "dispatches": tm["dispatches"], "drains": tm["drains"],
          "scan_host_syncs": tm["scan-host-syncs"],
          "scan_replayed_rounds": tm["scan-replayed-rounds"],
          "history_ops": tm["history-ops"],
          "nemesis_info_ops": sorted(fs),
          "faults": {k: net[k] for k in ("lost", "dropped-partition",
                                         "dropped-down", "duplicated",
                                         "dropped-overflow",
                                         "channel-overwrites",
                                         "latency-clipped")},
          "workload_lost_count": w["lost-count"],
          "stable_count": w["stable-count"],
          "stable_latencies": w["stable-latencies"],
          "availability": {k: res["availability"].get(k) for k in
                           ("longest-ok-gap-rounds", "dip-count",
                            "failover-recovery-rounds")},
          "messages_delivered": net["all"]["recv-count"],
          "launches": launches, "nvidia_smi": smi})
    shutil.rmtree(store, ignore_errors=True)
    return launches


# --- the Raft slice ----------------------------------------------------------

# The raft bench's state after 300 rounds (bench.py bench_raft_clusters'
# config: 5 nodes, latency 0, one client, pool 64, client_cap 4, no
# injections) of make_cluster_sims(seed=1): sha256
# (`parallel.cluster_digest`) of clusters 0-63, every node leaf, the
# keys, the per-cluster NetStats counters and the channels' overwrite
# and clipped-latency counters, from the JAX package's
# make_cluster_sims(F=64, seed=1) run on the CPU (cluster i's key does
# not depend on the cluster count); and sha256 (`parallel.nodes_digest`)
# of the final node state of tests/test_raft_golden.py's scenario (32
# clusters, 400 rounds, seed 7, its injection plan) from a live JAX run
# (jax 0.9.0; it equals that file's GOLDEN). Re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parallel.py -m slow
PINNED_RAFT = \
    "dd141748032ad24775b7c6f892bccaf5f33c7fa6089f6948f24e1ab52035822c"
PINNED_RAFT_GOLDEN = \
    "e88bcde5428c5e33594854d9a60fc5f5456a5adeb793581cb5c6b7a3fae059d2"
RAFT_BENCH = {"clusters": 10_000, "rounds": 300, "chunk": 100, "seed": 1}
RAFT_PINNED_CLUSTERS = 64

# The port's lin-kv CLI on one 5-node Raft cluster: fault-free, and under
# exponential latency, 2% loss and the kill, pause, partition and
# duplicate nemeses every 0.5 s (the faulted run's ring: 5 * 8 * 10 + 2
# + 2 = 404), cut from 2 s to 1 s (`CLI_LINKV_REDUCED`: every op kind
# still has an ok, so the stats checker passes; its 5 s client timeouts
# kept, where stragglers spend most of its rounds). sha256 of the JAX
# runner's history.jsonl for each, on the
# CPU (`python -m maelstrom_tpu <args> --no-audit`); re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_linkv.py -m slow
CLI_LINKV_BASE = ["test", "-w", "lin-kv", "--node", "tpu:lin-kv",
                  "--node-count", "5", "--rate", "20", "--seed", "7"]
CLI_LINKV = [
    ("linkv5", CLI_LINKV_BASE + ["--time-limit", "1"]),
    ("linkv5-faults", CLI_LINKV_BASE + [
        "--time-limit", "1", "--latency", "5", "--latency-dist",
        "exponential", "--p-loss", "0.02", "--nemesis",
        "kill,pause,partition,duplicate", "--nemesis-interval", "0.5"]),
]
CLI_LINKV_REDUCED = {"linkv5-faults": {
    "time_limit_s": 1.0, "from": 2.0, "rounds_executed_from": 6260,
    "why": WHY_SERVICES + ": the 0.5 s nemesis interval and the 5 s client "
           "timeouts kept; every fault counter still shows"}}
PINNED_LINKV = {
    "linkv5":
        "169dc9d20b2a6ffe58cbe79aefcb49d7593e18ebb19734acd859652e3dd85404",
    "linkv5-faults":
        "810f160a1cd940bd9f1996cfc8a07205fbdb837bbb4e1cf0b127bbb992edcf79",
}
# the kernels of the raft round on the cluster axis; the CLI path adds
# K5 (the scan's reply log) and K8 (the edge fault pass)
RAFT_KERNELS = ("raft_step", "threefry", "reply_compact", "edge_read",
                "edge_write")
LINKV_KERNELS = RAFT_KERNELS + ("reply_log_append", "edge_faults")


def _raft_program(n=5, **opts):
    from maelstrom_tpu_torch.nodes import get_program
    return get_program("lin-kv", {"latency": {"mean": 0}, **opts},
                       [f"n{i}" for i in range(n)], device="cuda")


def _random_raft_inputs(g, prog, F, rnd):
    """A random Raft state, lanes and client slots for F clusters of the
    program's nodes ([F * N, ...] rows), as the CPU tests draw them:
    small terms and indices, logs of packed entries, lanes of the types
    each lane carries, out-of-range corners mixed in."""
    import torch
    from maelstrom_tpu_torch.net.static import EdgeMsgs
    from maelstrom_tpu_torch.net.tpu import Msgs
    from maelstrom_tpu_torch.nodes import raft as R
    N, D, C, E, KEYS = prog.n_nodes, prog.D, prog.cap, prog.E, prog.keys
    L, K, T = prog.lanes, prog.inbox_cap, 6
    rows = F * N

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, (rows,) + shape, generator=g,
                             device="cuda", dtype=torch.int32)

    def entry_a(*shape):
        return (ints(0, T, *shape) << 16) | (ints(0, KEYS + 3, *shape)
                                             << 4) | ints(0, 5, *shape)

    def entry_b(*shape):
        return (ints(0, 6, *shape) << 16) | (ints(0, 7, *shape) << 8) | \
            ints(0, 7, *shape)
    log_len = ints(0, C + 1)
    commit = torch.minimum(ints(-1, C), log_len - 1)
    state = {
        "role": ints(0, 3), "term": ints(0, T), "voted_for": ints(-1, N),
        "votes": torch.rand((rows, N), generator=g, device="cuda") < 0.4,
        "log_a": entry_a(C), "log_b": entry_b(C), "log_c": ints(0, 1000, C),
        "log_len": log_len, "commit": commit,
        "applied": torch.clamp(commit - ints(0, 6), min=-1),
        "next": ints(0, C + 1, D), "match": ints(-1, C, D),
        "kv": ints(0, 7, KEYS), "deadline": rnd + ints(-6, 30),
        "leader_hint": ints(-1, D), "log_overflow": ints(0, 3)}
    lane_types = torch.tensor([[R.T_RV, R.T_AE, 0],
                               [R.T_RV_REPLY, R.T_AE_REPLY, 0],
                               [R.T_PROXY, R.T_PROXY, 0]], dtype=torch.int32,
                              device="cuda")
    typ = torch.full((rows, D, L), R.T_ENTRY, dtype=torch.int32,
                     device="cuda")
    for j in range(3):
        typ[..., j] = lane_types[j][ints(0, 3, D).long()]
    typ[..., 3:] = torch.where(torch.rand((rows, D, E), generator=g,
                                          device="cuda") < 0.9, R.T_ENTRY, 0)
    drift = torch.tensor([-1, 0, 0, 0, 1], dtype=torch.int32, device="cuda")
    term = state["term"][:, None]
    prev = ints(-1, C + 2, D)
    ae = typ[..., 0] == R.T_AE
    a = torch.stack([term + drift[ints(0, 5, D).long()],
                     term + drift[ints(0, 5, D).long()],
                     (ints(0, KEYS + 3, D) << 4) | ints(0, 5, D)], dim=2)
    b = torch.stack([torch.where(ae, ((prev + 1) << 16) | ints(0, T, D),
                                 ints(-1, C + 1, D)),
                     ints(0, 2, D), entry_b(D)], dim=2)
    c = torch.stack([torch.where(ae, ((ints(-1, C, D) + 1) << 4)
                                 | ints(0, E + 2, D), ints(0, T, D)),
                     ints(-2, C + 1, D), ints(0, 1000, D)], dim=2)
    edge_in = EdgeMsgs(
        valid=torch.rand((rows, D, L), generator=g, device="cuda") < 0.6,
        type=typ, a=torch.cat([a, entry_a(D, E)], dim=2),
        b=torch.cat([b, entry_b(D, E)], dim=2),
        c=torch.cat([c, ints(0, 1000, D, E)], dim=2))
    ctype = torch.tensor([R.T_READ, R.T_WRITE, R.T_CAS, R.T_TXN, 0],
                         dtype=torch.int32, device="cuda")
    client_in = Msgs(
        valid=torch.rand((rows, K), generator=g, device="cuda") < 0.5,
        src=N + ints(0, 6, K), dest=ints(0, N, K), due=ints(0, 99, K),
        mid=ints(0, 9999, K), reply_to=torch.full((rows, K), -1,
                                                  dtype=torch.int32,
                                                  device="cuda"),
        type=ctype[ints(0, 5, K).long()], a=ints(-1, KEYS + 2, K),
        b=ints(0, 5, K), c=ints(0, 5, K))
    return state, edge_in, client_in


def raft_edge_checks():
    """K1, K2, K8 and K5 at the shapes the Raft paths give them, exact
    against their plain versions on the card (`forced_plain`):

      - the cluster axis (the bench): K1 over the 50,000 node rows of
        10,000 clusters with the global neighbour table, K2 there with one
        overwrite and one clipped-latency counter a cluster (the kernel's
        per-cluster atomics): at the round's form (ring 2, uniform
        arrival, latency 0), then with an edge-shared [rows, D, 1]
        latency draw reaching past the ring, at ring 2 uniform and at
        ring 4 per lane, on channels a third full, so overwrites and
        clipped draws both count in every cluster;
      - the lin-kv CLI's faulted run (5 nodes, ring 404, exponential
        latency, loss, grudges, kill, pause, duplication): K8 with the
        edge-shared draw shape of `edge_atomic_rpc`, K2 with its deliver
        mask and latencies (and the duplicate's), plus draws past the
        ring, and K5 at the run's reply log (no payload words).

    Returns {kernel@shape: {max_abs_err, ...}}."""
    import dataclasses

    import numpy as np
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch import sim as S
    from maelstrom_tpu_torch.net import static
    from maelstrom_tpu_torch.net import tpu as T
    from maelstrom_tpu_torch.parallel import global_neighbors
    g = torch.Generator(device="cuda")
    g.manual_seed(50_000)
    out = {}
    F = RAFT_BENCH["clusters"]
    prog = _raft_program()
    N, D, L = prog.n_nodes, prog.D, prog.lanes
    R = F * N
    gcfg = dataclasses.replace(prog.edge_cfg, n_nodes=R)
    nb, rev = global_neighbors(prog.neighbors, F), prog.rev.repeat(F, 1)
    rnd = torch.tensor(301, dtype=torch.int32, device="cuda")

    def cluster_channels(cfg):
        ch = _random_channels(g, cfg)
        return ch.replace(
            overwrites=torch.randint(0, 9, (F,), generator=g, device="cuda",
                                     dtype=torch.int32),
            lat_clipped=torch.randint(0, 9, (F,), generator=g,
                                      device="cuda", dtype=torch.int32))

    ch = cluster_channels(gcfg)
    ck, cp = clone(ch), clone(ch)
    ck, ink = static.edge_read(gcfg, ck, nb, rev, rnd)
    with K.forced_plain():
        cp, inp = static.edge_read(gcfg, cp, nb, rev, rnd)
    torch.cuda.synchronize()
    err = max(max_abs_err(ck, cp), max_abs_err(ink, inp))
    check(err == 0, f"edge_read at the cluster axis ({R} rows, the global "
          f"table) differs from its plain version (max abs err {err})")
    out["edge_read@clusters"] = {"max_abs_err": err, "rows": R}

    shared = (R, D, 1)
    forms = (
        ("round", gcfg,
         torch.zeros((), dtype=torch.int32, device="cuda").expand(R, D, L),
         torch.ones((), dtype=torch.bool, device="cuda").expand(R, D, L)),
        ("shared-uniform", gcfg,
         torch.randint(0, 4, shared, generator=g, device="cuda",
                       dtype=torch.int32),
         torch.rand(shared, generator=g, device="cuda") < 0.9),
        ("shared-per-lane",
         static.EdgeConfig(n_nodes=R, degree=D, lanes=L, ring=4),
         torch.randint(0, 8, shared, generator=g, device="cuda",
                       dtype=torch.int32),
         torch.rand(shared, generator=g, device="cuda") < 0.9))
    err, counts = 0, {}
    for form, wcfg, lat, mask in forms:
        ch = cluster_channels(wcfg)
        eo = _random_edge_msgs(g, (R, D, L), 256, 1)
        before = clone(ch)
        ck, cp = clone(ch), clone(ch)
        static.edge_write(wcfg, ck, eo, rnd, lat, mask)
        with K.forced_plain():
            static.edge_write(wcfg, cp, eo, rnd, lat, mask)
        torch.cuda.synchronize()
        e = max_abs_err(ck, cp)
        check(e == 0, f"edge_write ({form}) at the cluster axis differs "
              f"from its plain version (max abs err {e})")
        err = max(err, e)
        ow = ck.overwrites - before.overwrites
        cl = ck.lat_clipped - before.lat_clipped
        counts[form] = {"overwrites": int(ow.sum()),
                        "lat_clipped": int(cl.sum()),
                        "clusters_with_overwrites": int((ow > 0).sum())}
        check(int((ow > 0).sum()) > F // 2,
              f"edge_write ({form}): overwrites in only "
              f"{int((ow > 0).sum())} of {F} clusters")
        if form != "round":
            check(int((cl > 0).sum()) > F // 2,
                  f"edge_write ({form}): clipped draws in only "
                  f"{int((cl > 0).sum())} of {F} clusters")
    out["edge_write@clusters"] = {"max_abs_err": err, "rows": R,
                                  "counted": counts}

    # the lin-kv CLI's faulted run, its program and NetConfig as the
    # runner builds them (5 clients: the node count)
    cp_ = _raft_program(**{
        "latency": {"mean": 5, "dist": "exponential"}, "rate": 20,
        "time_limit": 2,
        "nemesis": {"kill", "pause", "partition", "duplicate"}})
    ccfg = cp_.edge_cfg
    check(ccfg.ring == 404 and cp_.edge_atomic_rpc,
          f"the faulted lin-kv program's channels are {ccfg}")
    n_cl = 5
    cfg = T.NetConfig(n_nodes=N, n_clients=n_cl, pool_cap=max(8 * n_cl, 64),
                      inbox_cap=cp_.inbox_cap, client_cap=max(2 * n_cl, 8),
                      latency_mean_rounds=5.0, latency_dist="exponential",
                      partition_groups=N, enable_stall=True,
                      enable_duplication=True)
    err8 = err2 = 0
    n_ok = n_dup = n_clip = 0
    rng = np.random.default_rng(404)
    for t in range(64):
        # the fault API takes host values, as the nemesis gives them
        net = _fault_net(cfg, "cuda", g)
        net = T.partition_grudge(
            T.partition_components(net, rng.integers(0, 2, N)),
            rng.integers(0, N, N), rng.random((N, N)) < 0.3)
        valid = torch.rand((N, D, L), generator=g, device="cuda") < 0.5
        keys = prng.split(prng.PRNGKey(1000 + t, "cuda"), 7)
        fk = S.edge_faults(cfg, cp_.neighbors, net, valid, keys, True)
        with K.forced_plain():
            fp = S.edge_faults(cfg, cp_.neighbors, net, valid, keys, True)
        torch.cuda.synchronize()
        err8 = max(err8, max_abs_err(fk, fp))
        faults = fk[0]
        n_ok += int((valid & faults.deliver).sum())
        n_dup += int((valid & faults.dup).sum())
        past = torch.randint(0, 2 * ccfg.ring, (N, D, 1), generator=g,
                             device="cuda", dtype=torch.int32)
        eo = _random_edge_msgs(g, (N, D, L), 256, 1)
        eo = eo.replace(valid=valid)
        rnd_c = torch.tensor(1000 + 7 * t, dtype=torch.int32, device="cuda")
        for lat, mask in ((faults.lat, faults.deliver),
                          (faults.dup_lat, faults.dup), (past,
                                                        faults.deliver)):
            ch = _random_channels(g, ccfg)
            ck, cp2 = clone(ch), clone(ch)
            static.edge_write(ccfg, ck, eo, rnd_c, lat, mask)
            with K.forced_plain():
                static.edge_write(ccfg, cp2, eo, rnd_c, lat, mask)
            torch.cuda.synchronize()
            err2 = max(err2, max_abs_err(ck, cp2))
            n_clip += int(ck.lat_clipped)
    check(err8 == 0, f"edge_faults at the lin-kv CLI shape (edge-shared "
          f"draws) differs from its plain version (max abs err {err8})")
    check(err2 == 0, f"edge_write at the lin-kv CLI shape differs from its "
          f"plain version (max abs err {err2})")
    check(n_ok > 0 and n_dup > 0 and n_clip > 0,
          f"the lin-kv CLI shape's checks delivered {n_ok}, duplicated "
          f"{n_dup} and clipped {n_clip} lanes")
    out["edge_faults@linkv"] = {"max_abs_err": err8, "trials": 64,
                                "delivered": n_ok, "duplicated": n_dup}
    out["edge_write@linkv"] = {"max_abs_err": err2, "lat_clipped": n_clip}

    # K5: the run's client messages (the pool's client rows, then the
    # compacted replies) into its reply log of 256 rows, no payload
    CC = max(cfg.client_cap, 2 * cfg.n_clients, 1)
    CW = min(cfg.client_cap, cfg.pool_cap) + min(CC, N * cp_.inbox_cap)
    rcap = max(256, 2 * CW)

    def cm_of(p_valid):
        def ints(lo, hi):
            return torch.randint(lo, hi, (CW,), generator=g, device="cuda",
                                 dtype=torch.int32)
        return T.Msgs(valid=torch.rand(CW, generator=g, device="cuda")
                      < p_valid, src=ints(0, N), dest=ints(N, N + n_cl),
                      due=ints(0, 999), mid=ints(0, 1 << 20),
                      reply_to=ints(-1, 1 << 20), type=ints(0, 40),
                      a=ints(-9, 9), b=ints(-9, 9), c=ints(-9, 9))
    err5 = 0
    for p_valid, rn0, k, k_max, stop in ((0.3, 0, 1, 9, True),
                                         (0.5, rcap - 6, 4, 9, False),
                                         (0.1, 17, 9, 9, False),
                                         (0.0, 5, 2, 9, True)):
        cm = cm_of(p_valid)
        got = []
        for forced in (False, True):
            log = S.empty_reply_log(rcap, 0, "cuda")
            log = log[:3] + (torch.tensor(rn0, dtype=torch.int32,
                                          device="cuda"),)
            ek = torch.full((), 2**31 - 1, dtype=torch.int32, device="cuda")
            if forced:
                with K.forced_plain():
                    rn = S.append_replies(log, cm, None, N, rnd, k, k_max,
                                          stop, ek)
            else:
                rn = S.append_replies(log, cm, None, N, rnd, k, k_max, stop,
                                      ek)
            got.append((log[0], log[1], rn, ek))
        torch.cuda.synchronize()
        err5 = max(err5, max_abs_err(got[0], got[1]))
    check(err5 == 0, f"reply_log_append at the lin-kv CLI shape differs "
          f"from its plain version (max abs err {err5})")
    out["reply_log_append@linkv"] = {"max_abs_err": err5, "width": CW,
                                     "rcap": rcap}
    return out


def raft_kernel_checks(timed):
    """K10 raft_step (with and without the stall mask), K7 on a batch of
    keys and K4 on batched segments, each against its plain version on
    the card (`forced_plain`), at the bench shape (10,000 clusters of 5
    nodes, log 256, kv 256, 4 client slots) and at the CLI shape (one
    cluster, the faulted run's program: log 336, every node's client
    slots in use). Returns {kernel: {...}}, timed at the bench shape."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch import sim as S
    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    out = {}
    F = RAFT_BENCH["clusters"]
    shapes = (("bench", _raft_program(), F),
              ("cli", _raft_program(**{
                  "latency": {"mean": 5, "dist": "exponential"},
                  "rate": 20, "time_limit": 2,
                  "nemesis": {"kill", "pause", "partition", "duplicate"}}),
               1))
    for name, prog, nf in shapes:
        N = prog.n_nodes
        for stalled in (False, True):
            rnd = torch.arange(40, 40 + nf, dtype=torch.int32, device="cuda")
            state, ein, cin = _random_raft_inputs(g, prog, nf, 40)
            keys = prng.split(prng.PRNGKey(nf + stalled, "cuda"), nf)
            stall = (torch.rand(nf * N, generator=g, device="cuda") < 0.3
                     if stalled else None)

            def k10():
                return prog.step_rows(state, ein, cin, rnd, keys, stall)
            got = k10()
            with K.forced_plain():
                ref = k10()
            torch.cuda.synchronize()
            err = max_abs_err(got, ref)
            label = "raft_step" + ("_stall" if stalled else "")
            check(err == 0, f"{label} at the {name} shape differs from its "
                  f"plain version (max abs err {err})")
            if name != "bench":
                r = out.setdefault(label, {})
                r["cli_max_abs_err"] = err
                if timed:
                    r["cli_ms"] = cuda_ms(k10)
                continue
            so, eo, co = got
            fields = ("valid", "type", "a", "b", "c")
            io = (nbytes(*state.values(), *[getattr(ein, f) for f in fields],
                         *[getattr(cin, f) for f in ("valid", "src", "due",
                                                     "mid", "type", "a", "b",
                                                     "c")], rnd, keys)
                  + (nbytes(stall) if stalled else 0)
                  + nbytes(*so.values(), *[getattr(eo, f) for f in fields],
                           *[getattr(co, f) for f in
                             ("valid", "src", "dest", "due", "mid",
                              "reply_to", "type", "a", "b", "c")]))
            b, by = bound_of(io, 5 * THREEFRY_OPS * nf * N)
            r = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
                 "bytes": io, "nodes": nf * N}
            if timed:
                r["ms"] = cuda_ms(k10)
                with K.forced_plain():
                    r["plain_ms"] = cuda_ms(k10)
            out.setdefault(label, {}).update(r)

    # K7: the round's split of every cluster's key, [F, 2] -> [F, 5, 2]
    keys = prng.split(prng.PRNGKey(1, "cuda"), F)

    def k7():
        return prng.split(keys, 5)
    got = k7()
    with K.forced_plain():
        ref = k7()
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    check(err == 0, f"threefry on batched keys differs (max abs err {err})")
    b, by = bound_of(F * 8 + F * 5 * 8, F * 5 * THREEFRY_OPS)
    r = {"max_abs_err": err, "bound_ms": b, "bound_by": by, "keys": F}
    if timed:
        r["ms"] = cuda_ms(k7)
        with K.forced_plain():
            r["plain_ms"] = cuda_ms(k7)
    out["threefry_batched"] = r

    # K4: one segment a cluster, 5 nodes x 4 slots, CC 4 (the bench);
    # then clusters of several 4096-row segments
    from maelstrom_tpu_torch.net.tpu import Msgs

    def flat_of(nf, nk, p_valid):
        def ints(lo, hi):
            return torch.randint(lo, hi, (nf, nk), generator=g,
                                 device="cuda", dtype=torch.int32)
        return Msgs(valid=torch.rand((nf, nk), generator=g, device="cuda")
                    < p_valid, src=ints(0, 5), dest=ints(5, 9),
                    due=ints(0, 99), mid=ints(0, 999), reply_to=ints(-1, 99),
                    type=ints(0, 20), a=ints(-9, 9), b=ints(-9, 9),
                    c=ints(-9, 9))
    err = 0
    for nf, nk, cc, p_valid in ((F, 20, 4, 0.1), (3, 10_000, 5000, 0.4),
                                (5, 9000, 7, 0.001)):
        flat = flat_of(nf, nk, p_valid)
        nm = torch.randint(0, 1 << 20, (nf,), generator=g, device="cuda",
                           dtype=torch.int32)

        def k4():
            return S.compact_replies(flat, 4, cc, nm)
        got = k4()
        with K.forced_plain():
            ref = k4()
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, ref))
        if nf == F:
            timed_k4, bench_flat = k4, flat
    check(err == 0, f"reply_compact on batched segments differs (max abs "
          f"err {err})")
    n_valid = int(bench_flat.valid.sum())
    # each cluster's valid bytes and next_mid read; per cluster its CC
    # output rows written (37 bytes) from the rows they copy (29 bytes
    # of the valid ones) and n_all
    b, by = bound_of(F * 20 + F * 4 + F * 4 * 37 + n_valid * 29 + F * 4, 0)
    r = {"max_abs_err": err, "bound_ms": b, "bound_by": by, "clusters": F,
         "rows_per_cluster": 20, "slots": 4}
    if timed:
        r["ms"] = cuda_ms(timed_k4)
        with K.forced_plain():
            r["plain_ms"] = cuda_ms(timed_k4)
    out["reply_compact_batched"] = r
    return out


def phase_raft_kernels(timed):
    t0 = time.perf_counter()
    r = raft_kernel_checks(timed)
    if not timed:
        r.update(raft_edge_checks())
    emit({"phase": "raft_kernels", "timed": timed,
          "bench_shape": {"clusters": RAFT_BENCH["clusters"], "nodes": 5,
                          "log": 256, "kv": 256, "client_slots": 4},
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


def golden_plan(F, rounds, seed=42):
    """tests/test_raft_golden.py's injection plan: every third round past
    50, one client request a cluster (reads, writes and CASes on 8
    keys), from numpy's RandomState(42); [F, 3] fields a round."""
    import numpy as np
    from maelstrom_tpu_torch.nodes.raft import T_CAS, T_READ, T_WRITE
    rng = np.random.RandomState(seed)
    plan = []
    for r in range(rounds):
        if r % 3 == 0 and r > 50:
            cols = {"type": rng.choice([T_READ, T_WRITE, T_CAS], size=F),
                    "dest": rng.randint(0, 5, size=F),
                    "a": rng.randint(0, 8, size=F),
                    "b": rng.randint(0, 5, size=F),
                    "c": rng.randint(0, 5, size=F),
                    "src": 5 + rng.randint(0, 3, size=F),
                    "mid": np.full(F, r * 10 + 1),
                    "valid": np.ones(F, bool)}
            rows = {}
            for k, v in cols.items():
                x = np.zeros((F, 3), bool if k == "valid" else np.int32)
                x[:, 0] = v
                rows[k] = x
            plan.append(rows)
        else:
            plan.append(None)
    return plan


def phase_raft_bench(smi):
    """The raft slice's cluster-axis path: `python -m
    maelstrom_tpu_torch.bench --raft` at 10,000 clusters, launch counters
    set to 0 just before and read just after; clusters 0-63 hash to the
    JAX run's state. Then the golden scenario against its live JAX
    hash."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch import parallel as PP
    from maelstrom_tpu_torch.bench import run_raft_bench
    from maelstrom_tpu_torch.net import tpu as T
    from maelstrom_tpu_torch.tree import to_numpy
    K.reset_launches()
    rec, sims = run_raft_bench(RAFT_BENCH["clusters"], RAFT_BENCH["rounds"],
                               RAFT_BENCH["chunk"], RAFT_BENCH["seed"],
                               return_state=True)
    launches = K.launch_counts()
    check(rec["rounds"] == RAFT_BENCH["rounds"],
          f"raft bench ran {rec['rounds']} rounds")
    check(rec["clusters_with_one_leader"] == 1.0,
          f"raft bench: {rec['clusters_with_one_leader']} of the clusters "
          f"have one leader")
    for k in RAFT_KERNELS:
        check(launches[k] >= RAFT_BENCH["rounds"],
              f"the raft bench launched {k} {launches[k]} times")
    n = RAFT_PINNED_CLUSTERS
    head = to_numpy(({k: v[:n] for k, v in sims.nodes.items()},
                     sims.key[:n], sims.net.stats,
                     {"overwrites": sims.channels.overwrites[:n],
                      "lat_clipped": sims.channels.lat_clipped[:n]}))
    digest = PP.cluster_digest(*head, n)
    check(digest == PINNED_RAFT, f"raft bench clusters 0-63: sha256 "
          f"{digest}, the JAX run's {PINNED_RAFT}")
    del sims

    # the golden scenario: 32 clusters, 400 rounds, seed 7
    prog = _raft_program()
    cfg = T.NetConfig(n_nodes=5, n_clients=3, pool_cap=64,
                      inbox_cap=prog.inbox_cap, client_cap=4)
    fn = PP.make_cluster_round_fn(prog, cfg)
    gs = PP.make_cluster_sims(prog, cfg, 32, seed=7)
    empty = T.Msgs.empty((32, 3), "cuda")
    t0 = time.perf_counter()
    for rows in golden_plan(32, 400):
        gs = fn(gs, empty if rows is None
                else PP.injection_msgs(rows, "cuda"))[0]
    torch.cuda.synchronize()
    golden_s = time.perf_counter() - t0
    gd = PP.nodes_digest(to_numpy(gs.nodes))
    check(gd == PINNED_RAFT_GOLDEN, f"raft golden scenario: sha256 {gd}, "
          f"the JAX run's {PINNED_RAFT_GOLDEN}")
    emit({"phase": "raft_bench_10k", **rec, "launches": launches,
          "pinned_clusters_sha256_equal": True,
          "golden": {"clusters": 32, "rounds": 400, "seconds": golden_s,
                     "sha256_equal": True},
          "nvidia_smi": smi})
    return launches


def phase_cli_linkv(smi):
    """The port's lin-kv CLI through the kernels, launch counters set to
    0 just before and read just after: both histories must hash to the
    JAX runner's, and the faulted run's faults must show."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_linkv")
    shutil.rmtree(store, ignore_errors=True)
    K.reset_launches()
    runs = {}
    for name, args in CLI_LINKV:
        tel = name in TELEMETRY_ON
        rc, d, res, tm, digest, wall = _cli_run(
            args + (["--telemetry"] if tel else []), store)
        _cli_checks(name, rc, res, tm)
        if tel:
            # the flight recorder on: the history keeps its pin
            _telemetry_checks(name, d, res, PINNED_TELEMETRY[name])
        check(res["workload"]["valid"] is True,
              f"cli {name}: workload {res['workload']}")
        check(res["net"]["log-overflow"] == 0, f"cli {name}: log-overflow")
        check(digest == PINNED_LINKV[name],
              f"cli {name}: history.jsonl sha256 {digest}, the JAX "
              f"runner's {PINNED_LINKV[name]}")
        fs = set()
        with open(os.path.join(d, "history.jsonl")) as f:
            for line in f:
                if '"nemesis"' in line:
                    op = json.loads(line)
                    if op.get("type") == "info":
                        fs.add(op["f"])
        faults = {k: res["net"][k] for k in
                  ("lost", "dropped-partition", "dropped-down",
                   "duplicated", "channel-overwrites", "latency-clipped")}
        if name.endswith("faults"):
            for k in ("lost", "dropped-partition", "dropped-down",
                      "duplicated"):
                check(faults[k] > 0, f"cli {name}: no {k}")
            check({"start-kill", "start-pause", "start-partition"} <= fs,
                  f"cli {name}: nemesis ops {sorted(fs)}")
        runs[name] = {"wall_s": wall, "final_round": tm["final-round"],
                      "rounds_executed": tm["rounds-executed"],
                      "ms_per_executed_round": 1e3 * tm["scan-s"]
                      / max(tm["rounds-executed"], 1),
                      "dispatches": tm["dispatches"], "drains": tm["drains"],
                      "history_ops": tm["history-ops"],
                      "nemesis_info_ops": sorted(fs), "faults": faults,
                      "history_sha256_equal": True, "telemetry": tel}
    launches = K.launch_counts()
    for k in LINKV_KERNELS + ("ring_update",):
        check(launches[k] > 0, f"the lin-kv CLI runs did not launch {k}: "
              f"{launches}")
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_linkv", "runs": runs, "launches": launches,
          "nvidia_smi": smi})
    return launches


def phase_raft_profile():
    """`bench.profile_raft`'s window, taken again (as `traced` does, the
    allocator's cache emptied first) until its trace holds K10's kernel
    once a round, as the round launches it, or one time less
    (`anchored`); when no trace is, the last is kept and the `profiler`
    line says how many records it lacks."""
    import torch
    from maelstrom_tpu_torch.bench import profile_raft
    window = 20
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rec = profile_raft(RAFT_BENCH["clusters"], start=100, window=window)
        PROFILER["traces"] += 1
        k10 = [round(t["calls_per_round"] * window) for t in rec["top"]
               if "raft_kernel" in t["name"]]
        if (len(k10) == 1 and window - 1 <= k10[0] <= window
                and rec["device_busy_ms_per_round"] > 0):
            PROFILER["short"] += window - k10[0]
            PROFILER["records_missing"] += window - k10[0]
            emit({"phase": "raft_profile", **rec})
            return
        PROFILER["retaken"] += 1
    check(len(k10) == 1 and rec["device_busy_ms_per_round"] > 0,
          f"raft profile: no K10 in 3 traces ({rec['top']})")
    PROFILER["kept_short"].append({"what": "raft profile",
                                   "anchor": "raft_kernel",
                                   "launches": window,
                                   "anchor_missing": window - k10[0]})
    emit({"phase": "raft_profile", **rec})


# --- the pool-path round and the CRDT programs -------------------------------

POOL_KERNELS = ("echo_step", "unique_ids_step", "threefry",
                "reply_log_append")
CRDT_KERNELS = ("pn_counter_step", "reply_log_append_i32", "edge_read",
                "edge_write", "edge_faults", "reply_compact", "threefry")
GSET_KERNELS = ("broadcast_step", "edge_read", "edge_write", "edge_faults",
                "reply_compact", "reply_log_append", "quiet_probe")
# the kernels' function names in a profiler trace
OWN_KERNELS = ("step_kernel", "count_kernel", "emit_kernel", "route_kernel",
               "clear_kernel", "write_kernel", "spill_kernel",
               "faults_kernel", "faults_finish", "pn_counter_kernel",
               "echo_kernel", "unique_ids_kernel", "threefry_kernel",
               "raft_kernel", "append_kernel", "quiet_kernel")

# The pool-path programs on the CLI: echo at 5 nodes (BASELINE config 1,
# at tests/test_tpu_e2e.py's rate 20, seed 7 and 2 s), and unique-ids at
# Gossip Glomers' challenge-2 shape (3 nodes, rate 1000, partitions;
# time limit cut from 30 s to 2.5 s, and the nemesis interval, the CLI's
# 10 s there, scaled with it to 0.834 s, so that the cut run keeps the
# challenge's schedule: one partition over the middle third of the run,
# none at 10 s in a short run; then the time limit alone cut to 1.25 s
# and 1 s, which leaves the partition from 0.834 s to the end of the
# run).
# tests/test_torch_runner_programs.py holds both against the JAX runner
# on the CPU.
CLI_POOL = [
    ("echo5", ["test", "-w", "echo", "--node", "tpu:echo", "--node-count",
               "5", "--rate", "20", "--time-limit", "2", "--seed", "7"]),
    ("unique-ids3-challenge2", [
        "test", "-w", "unique-ids", "--node", "tpu:unique-ids",
        "--node-count", "3", "--rate", "1000", "--nemesis", "partition",
        "--nemesis-interval", "0.834", "--time-limit", "1", "--seed",
        "7"]),
]
CLI_POOL_REDUCED = {"unique-ids3-challenge2": {
    "time_limit_s": 1.0, "from": 30.0, "cut_again_from": 1.25,
    "rounds_executed_from": 1252, "why_again": WHY_SERVICES
    + ": the partition now runs 0.834-1 s",
    "nemesis_interval_s": 0.834,
    "nemesis_interval_from": 10.0,
    "why": "the interval scaled with a 2.5 s time limit: one partition "
           "over the run's middle third, as in the 30 s challenge; then "
           "the time limit alone cut to 1.25 s to pay for the "
           "batched-broadcast phases (the partition starts at 0.834 s "
           "and lasts to the end)"}}
# The CRDT programs through `core.run` (the JAX CLI has no flag for
# gossip_fanout or recovery_s): tests/test_tpu_crdt.py's g-set at 20
# nodes with gossip fanout 3 and 5% loss and its pn-counter at 5 nodes
# under partitions, and its g-counter at 5 nodes at 5 ms a round
CLI_CRDT = [
    ("g-set20-fanout3-loss", {
        "workload": "g-set", "node": "tpu:g-set", "node_count": 20,
        "gossip_fanout": 3, "p_loss": 0.05, "rate": 20.0, "time_limit": 2.0,
        "recovery_s": 1.5, "ms_per_round": 5.0, "seed": 11}),
    ("pn-counter5-partition", {
        "workload": "pn-counter", "node": "tpu:pn-counter", "node_count": 5,
        "nemesis": {"partition"}, "nemesis_interval": 0.5, "rate": 20.0,
        "time_limit": 1.5, "recovery_s": 1, "seed": 11}),
    ("g-counter5", {
        "workload": "g-counter", "node": "tpu:g-counter", "node_count": 5,
        "rate": 20.0, "time_limit": 2.0, "recovery_s": 1.0,
        "ms_per_round": 5.0, "seed": 11}),
]
CLI_CRDT_REDUCED = {
    "g-set20-fanout3-loss": {
        "recovery_s": 1.5, "from": 3.0, "rounds_executed_from": 2239,
        "why": WHY_SERVICES + ": the final reads still see every "
               "acknowledged add (lost-count 0) under the 5% loss"},
    "g-counter5": {
        "recovery_s": 1.0, "from": 10.0, "rounds_executed_from": 2402,
        "why": WHY_SERVICES + ": the JAX g-counter never quiesces on "
               "this graph (ROADMAP queue 3), so every round of its 10 s "
               "recovery "
               "window (the default, at 5 ms a round) executed; 1 s of "
               "recovery still ends in a valid count"},
    "pn-counter5-partition": {
    "time_limit_s": 1.5, "from": 3.0, "recovery_s": 1.0,
    "recovery_from": 2.0,
    "why": "to pay for the batched-broadcast phases: the run never "
           "quiesces, so every round of it executes; the partition "
           "interval kept at 0.5 s, so the cut run has half the "
           "nemesis ops"}}
# sha256 of the JAX runner's history.jsonl for each run above, on the
# CPU; re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_runner_programs.py \
#       -m slow
PINNED_POOL = {
    "echo5": "e43929688d2a0f9c44df83a5ad75afea1720f8e7c957ee4bdaae1c9ad32503b7",
    "unique-ids3-challenge2":
        "7c7a9e6aca607d2ac29ce53356e0177ee72f3e919cacc7f8133f7d1826424957",
}
PINNED_CRDT = {
    "g-set20-fanout3-loss":
        "8b7ff9277d6b97702a8772e4a406ad315c334c2d8954039bdd94b04ed0fd1ee2",
    "pn-counter5-partition":
        "ab5ff8f51c79929a46310f758182731071289c91dfdcb7c428499f6065d06cf2",
    "g-counter5":
        "1ca6a70b120a88c4d2e607bfa6afa37b88c9a0ee2d491b8aa64cf4e54dd80dc1",
}
# The slice's full-width runs: BASELINE config 3 (g-set, 1,000 nodes,
# gossip fanout 3, 5% loss; the README's set-full claim), and pn-counter
# (5% loss and partitions) and g-counter on the same graph. Cut in depth
# (`CRDT_1000_REDUCED`): 2 s at rate 100 and a 2 s recovery window (4 s
# and 3 s before the cut that pays for the batched-broadcast phases; the
# partition interval kept at 1 s, so half the nemesis ops), at 5 ms a
# round as
# tests/test_tpu_crdt.py's fanout run, instead of the CLI's 10 s, 10 s
# and 1 ms; node count, graph, loss and nemesis kept.
CRDT_1000_BASE = {"node_count": 1000, "gossip_fanout": 3, "rate": 100.0,
                  "time_limit": 2.0, "recovery_s": 2, "ms_per_round": 5.0,
                  "seed": 11, "journal_rows": False}
CRDT_1000 = [
    ("g-set1000-fanout3-loss", {"workload": "g-set", "node": "tpu:g-set",
                                "p_loss": 0.05}),
    ("pn-counter1000-fanout3-loss-partition", {
        "workload": "pn-counter", "node": "tpu:pn-counter", "p_loss": 0.05,
        "nemesis": {"partition"}, "nemesis_interval": 1.0}),
    ("g-counter1000-fanout3", {"workload": "g-counter",
                               "node": "tpu:g-counter"}),
]
CRDT_1000_REDUCED = {"time_limit_s": 2.0, "from": 10.0, "recovery_s": 2.0,
                     "recovery_from": 10.0, "ms_per_round": 5.0,
                     "ms_per_round_from": 1.0}


def _core_run(opts, store):
    """`core.run` in this process (the runs whose options the CLI has no
    flag for); returns what `_cli_run` returns."""
    import contextlib
    import hashlib
    from maelstrom_tpu_torch import core
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = core.run({**opts, "store_root": store})
    wall = time.perf_counter() - t0
    d = os.path.realpath(os.path.join(store, "latest"))
    with open(os.path.join(d, "timing.json")) as f:
        timing = json.load(f)
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return (0 if res["valid"] is True else 1), d, res, timing, digest, wall


def _run_line(name, run, store, pins=None):
    """One pinned or full-width run (CLI args or `core.run` options),
    checked; returns its line's record."""
    rc, _d, res, tm, digest, wall = (_cli_run(run, store)
                                     if isinstance(run, list)
                                     else _core_run(run, store))
    check(rc == 0 and res["valid"] is True,
          f"run {name}: exit {rc}, valid {res.get('valid')}")
    check(res["net"]["dropped-overflow"] == 0, f"run {name}: pool overflow")
    # host reads scale with the run's ops, not its rounds (a run at rate
    # 1000 dispatches about once a round, as the JAX runner does)
    check(tm["drains"] < max(tm["final-round"] / 4, 2 * tm["history-ops"]),
          f"run {name}: {tm['drains']} host drains for "
          f"{tm['final-round']} rounds and {tm['history-ops']} ops")
    check(res["workload"]["valid"] is True,
          f"run {name}: workload {res['workload']}")
    check(res["net"].get("latency-clipped", 0) == 0,
          f"run {name}: clipped latency draws")
    if pins is not None:
        check(digest == pins[name], f"run {name}: history.jsonl sha256 "
              f"{digest}, the JAX runner's {pins[name]}")
    w = res["workload"]
    return {"wall_s": wall, "final_round": tm["final-round"],
            "rounds_executed": tm["rounds-executed"],
            "rounds_bumped": tm["rounds-bumped"],
            "ms_per_executed_round": 1e3 * tm["scan-s"]
            / max(tm["rounds-executed"], 1),
            "scan_s": tm["scan-s"], "replies_s": tm["replies-s"],
            "check_s": tm["check-s"], "store_s": tm["store-s"],
            "dispatches": tm["dispatches"], "drains": tm["drains"],
            "history_ops": tm["history-ops"],
            "server_msgs": res["net"]["servers"]["send-count"],
            "lost": res["net"]["lost"],
            "dropped_partition": res["net"]["dropped-partition"],
            "dropped_overflow": res["net"]["dropped-overflow"],
            "latency_clipped": res["net"].get("latency-clipped"),
            "log_overflow": res["net"].get("log-overflow"),
            "workload": {k: w[k] for k in ("lost-count", "stable-count",
                                            "final-reads", "acceptable",
                                            "acknowledged-count",
                                            "distinct-count", "acked-sends",
                                            "polls", "distinct-offsets")
                         if k in w},
            **({"history_sha256_equal": True} if pins is not None
               else {})}


def _random_pool_inbox(g, N, K, p_valid, req=10):
    import torch
    from maelstrom_tpu_torch.net.tpu import Msgs

    def ints(lo, hi):
        return torch.randint(lo, hi, (N, K), generator=g, device="cuda",
                             dtype=torch.int32)
    typ = torch.where(torch.rand((N, K), generator=g, device="cuda") < 0.8,
                      req, ints(0, 20))
    return Msgs(valid=torch.rand((N, K), generator=g, device="cuda")
                < p_valid, src=ints(N, N + N), dest=ints(0, N),
                due=ints(0, 99), mid=ints(0, 1 << 30), reply_to=ints(-1, 99),
                type=typ.to(torch.int32), a=ints(-9, 9),
                b=ints(-2**31, 2**31 - 1), c=ints(-2**31, 2**31 - 1))


def pool_kernel_checks(timed):
    """K11 echo_step and K12 unique_ids_step, with and without the stall
    mask, against their plain versions at 100,000 nodes x 8 inbox slots
    (inboxes 1% and 50% full; counters near the int32 limit in some
    rows). Timed at 1%."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch.nodes import get_program
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    N, Kc = 100_000, 8
    nodes = [f"n{i}" for i in range(N)]
    out = {}
    for name, key in (("echo", "rounds"), ("unique-ids", "counter")):
        prog = get_program(name, {}, nodes)
        kname = K.ECHO_STEP.name if name == "echo" else \
            K.UNIQUE_IDS_STEP.name
        err = 0
        for p_valid in (0.5, 0.01):
            inbox = _random_pool_inbox(g, N, Kc, p_valid)
            counter = torch.randint(0, 1 << 20, (N,), generator=g,
                                    device="cuda", dtype=torch.int32)
            counter[:5] = 2**31 - 1
            stall = torch.rand(N, generator=g, device="cuda") < 0.3
            for st in (None, stall):
                ctx = {"round": torch.tensor(9, dtype=torch.int32,
                                             device="cuda")}
                if st is not None:
                    ctx["stall"] = st

                def step(ctx=ctx, inbox=inbox, counter=counter):
                    return prog.step({key: counter}, inbox, ctx)
                got = step()
                with K.forced_plain():
                    ref = step()
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, ref))
        check(err == 0, f"{kname} differs from its plain version (max abs "
              f"err {err})")
        # valid and type read and written (10 bytes a slot), a and b
        # written by unique-ids (8 more), the counter read and written
        io = N * Kc * (10 if name == "echo" else 18) + 8 * N
        b, by = bound_of(io, 0)
        r = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
             "bytes": io, "nodes": N, "slots": Kc, "p_valid_timed": p_valid}
        if timed:
            r["ms"] = cuda_ms(step)
            with K.forced_plain():
                r["plain_ms"] = cuda_ms(step)
            r["stall_ms"] = cuda_ms(lambda: prog.step(
                {key: counter}, inbox, {"round": ctx["round"],
                                        "stall": stall}))
        out[kname] = r
    return out


def _crdt_program(device="cuda"):
    """The 1,000-node pn-counter run's program (CRDT_1000's graph)."""
    from maelstrom_tpu_torch.nodes import get_program
    return get_program("pn-counter", {"gossip_fanout": 3,
                                      "seed": CRDT_1000_BASE["seed"]},
                       [f"n{i}" for i in range(1000)], device=device)


def _random_pn_inputs(g, prog):
    """A PN-counter step's inputs on the card: contributions up to 40,
    pending dense on some edges and absent or sparse on others, entry
    lanes with clipped origins and counts below the -1 sentinel, adds
    and reads in half the client slots."""
    import torch
    from maelstrom_tpu_torch.net.static import EdgeMsgs
    from maelstrom_tpu_torch.net.tpu import Msgs
    N, D, M = prog.n_nodes, prog.D, prog.M
    L, Kc = prog.edge_cfg.lanes, prog.inbox_cap

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    def coin(p, shape):
        return torch.rand(shape, generator=g, device="cuda") < p
    dens = torch.tensor([0.0, 0.002, 0.3], device="cuda")[
        torch.randint(0, 3, (N, D, 1), generator=g, device="cuda")]
    state = {"pos": ints(0, 40, (N, M)), "neg": ints(0, 40, (N, M)),
             "pending": torch.rand((N, D, M), generator=g, device="cuda")
             < dens, "synced": coin(0.5, (N, D, M))}
    edge_in = EdgeMsgs(
        valid=coin(0.7, (N, D, L)),
        type=torch.where(coin(0.75, (N, D, L)), 14, 0).to(torch.int32),
        a=ints(-2, M + 2, (N, D, L)), b=ints(-3, 45, (N, D, L)),
        c=ints(-3, 45, (N, D, L)))
    ctype = torch.where(coin(0.5, (N, Kc)), 10,
                        torch.where(coin(0.5, (N, Kc)), 12, 0))
    client_in = Msgs(valid=coin(0.5, (N, Kc)), src=ints(N, 2 * N, (N, Kc)),
                     dest=ints(0, N, (N, Kc)), due=ints(0, 99, (N, Kc)),
                     mid=ints(0, 1 << 30, (N, Kc)),
                     reply_to=ints(-1, 99, (N, Kc)),
                     type=ctype.to(torch.int32), a=ints(-5, 5, (N, Kc)),
                     b=ints(-9, 9, (N, Kc)), c=ints(-9, 9, (N, Kc)))
    return state, edge_in, client_in


def crdt_kernel_checks(timed):
    """K13 pn_counter_step, with and without the stall mask, on an
    ordinary and a retry round, against its plain version at the
    1,000-node pn-counter run's shape (1,000 origins, the fanout-3
    graph's degree, 4 lanes, 4 client slots); K5's int32 form at that
    run's reply shape (4,000 client rows a round: the pool's 2,000 and
    the 2,000 compacted replies; a log of 8,000 rows of one word)."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch import sim as S
    from maelstrom_tpu_torch.net.tpu import Msgs
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    prog = _crdt_program()
    N, D, M, P = prog.n_nodes, prog.D, prog.M, prog.per_nb
    L, Kc = prog.edge_cfg.lanes, prog.inbox_cap
    out = {}
    err = 0
    for rnd in (41, 0):
        state, ein, cin = _random_pn_inputs(g, prog)
        stall = torch.rand(N, generator=g, device="cuda") < 0.3
        for st in (None, stall):
            ctx = {"round": torch.tensor(rnd, dtype=torch.int32,
                                         device="cuda")}
            if st is not None:
                ctx["stall"] = st

            def k13(ctx=ctx, state=state, ein=ein, cin=cin):
                return prog.edge_step(state, ein, cin, ctx)
            got = k13()
            with K.forced_plain():
                ref = k13()
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, ref))
    check(err == 0, f"pn_counter_step differs from its plain version (max "
          f"abs err {err})")
    # pos, neg (4 bytes) and pending, synced (1 byte) read and written;
    # the lanes in (17 bytes) and out (17 bytes), the client slots in (29
    # bytes) and out (37 bytes), the neighbour table
    io = (2 * (8 * N * M + 2 * N * D * M) + 17 * N * D * (L + P)
          + 66 * N * Kc + 4 * N * D)
    # the operations the function needs, counted from the plain version
    # (`PnCounterProgram.edge_step_plain`), not the kernel's rescans: a
    # lane (node, edge, lane) is tested (valid, type), clipped (2) and
    # max-merged into p_in and n_in (2): 6; a (node, edge, origin) sets
    # p_in and n_in to -1 (2), tests arrival (1) and nb_ge (4), updates
    # synced (2), queues teach (3), echo (3) and retry (4), updates
    # pending (5), takes its priority (1), counts its rank in the
    # rotated order (2) and clears a selected bit (2): 29; a (node,
    # origin) folds the D edges' maxima into pos and neg (2 D), changed
    # (4), ~changed (1) and nonzero (3): 2 D + 8; a client slot: the
    # add and read tests (4), the delta, its two clamps and sums (6),
    # the reply's valid and type (3): 13
    ops = (29 * N * D * M + (2 * D + 8) * N * M + 6 * N * D * L
           + 13 * N * Kc)
    b, by = bound_of(io, ops)
    r = {"max_abs_err": err, "bound_ms": b, "bound_by": by, "bytes": io,
         "operations": ops, "nodes": N, "origins": M, "degree": D,
         "lanes": L}
    if timed:
        r["ms"] = cuda_ms(k13)
        with K.forced_plain():
            r["plain_ms"] = cuda_ms(k13)
        r["stall_ms"] = cuda_ms(lambda: prog.edge_step(
            state, ein, cin, {"round": ctx["round"], "stall": stall}))
    out[K.PN_COUNTER_STEP.name] = r

    CW, rcap, W = 4000, 8000, 1
    rows = torch.randint(-2**31, 2**31 - 1, (N, W), generator=g,
                         device="cuda", dtype=torch.int32)
    rnd_t = torch.tensor(777, dtype=torch.int32, device="cuda")

    def cm_of(p_valid):
        def ints(lo, hi):
            return torch.randint(lo, hi, (CW,), generator=g, device="cuda",
                                 dtype=torch.int32)
        return Msgs(valid=torch.rand(CW, generator=g, device="cuda")
                    < p_valid, src=ints(-3, N + 3), dest=ints(N, 2 * N),
                    due=ints(0, 99), mid=ints(0, 1 << 30),
                    reply_to=ints(-1, 99), type=ints(0, 20), a=ints(-9, 9),
                    b=ints(-9, 9), c=ints(-9, 9))

    def fresh(rn0):
        log = S.empty_reply_log(rcap, W, "cuda")
        return log[:3] + (torch.tensor(rn0, dtype=torch.int32,
                                       device="cuda"),)
    err = 0
    for p_valid, rn0 in ((0.25, 0), (0.25, 7000), (5.0 / CW, 123)):
        cm = cm_of(p_valid)
        res = []
        for fn in (S.append_replies, S.append_replies_plain):
            log = fresh(rn0)
            ek = torch.full((), 2**31 - 1, dtype=torch.int32, device="cuda")
            rn = fn(log, cm, rows, N, rnd_t, 3, 9, False, ek)
            res.append((log[:3], rn, ek))
        torch.cuda.synchronize()
        err = max(err, max_abs_err(res[0], res[1]))
    check(err == 0, f"reply_log_append_i32 differs from its plain version "
          f"(max abs err {err})")
    n_valid = int(cm.valid.sum())
    # cm's valid bytes; for each valid row its 9 int fields read, its
    # log row written (41 bytes and the W payload words) and its payload
    # row read
    r = {"max_abs_err": err,
         "bound_ms": bound_ms(CW + n_valid * (36 + 41 + 8 * W)),
         "bound_by": "bytes", "valid_rows": n_valid, "rows": CW,
         "rcap": rcap}
    if timed:
        log, ek = fresh(123), torch.zeros((), dtype=torch.int32,
                                          device="cuda")
        r["ms"] = cuda_ms(lambda: S.append_replies(
            log, cm, rows, N, rnd_t, 9, 9, False, ek))
        r["plain_ms"] = cuda_ms(lambda: S.append_replies_plain(
            log, cm, rows, N, rnd_t, 9, 9, False, ek))
    out[K.REPLY_LOG_APPEND_I32.name] = r
    return out


def phase_pool_kernels(timed):
    t0 = time.perf_counter()
    r = pool_kernel_checks(timed)
    emit({"phase": "pool_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


def phase_crdt_kernels(timed):
    t0 = time.perf_counter()
    r = crdt_kernel_checks(timed)
    emit({"phase": "crdt_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


def phase_cli_pool(smi):
    """The pool-path programs on the CLI through the kernels, launch
    counters set to 0 just before and read just after: both histories
    must hash to the JAX runner's."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_pool")
    shutil.rmtree(store, ignore_errors=True)
    runs = {}
    launches = {}
    for name, args in CLI_POOL:
        K.reset_launches()
        tel = name in TELEMETRY_ON
        runs[name] = _run_line(name, args + (["--telemetry"] if tel else []),
                               store, PINNED_POOL)
        runs[name]["reduced"] = CLI_POOL_REDUCED.get(name)
        launches[name] = K.launch_counts()
        if tel:
            # the flight recorder on: the history keeps its pin
            d = os.path.realpath(os.path.join(store, "latest"))
            with open(os.path.join(d, "results.json")) as f:
                _telemetry_checks(name, d, json.load(f),
                                  PINNED_TELEMETRY[name])
            check(launches[name]["ring_update"] > 0,
                  f"{name} did not launch ring_update")
            runs[name]["telemetry"] = True
    for k in POOL_KERNELS:
        check(sum(v[k] for v in launches.values()) > 0,
              f"the pool-path runs did not launch {k}: {launches}")
    check(launches["echo5"]["echo_step"] > 0
          and launches["unique-ids3-challenge2"]["unique_ids_step"] > 0,
          f"the pool-path runs did not launch their steps: {launches}")
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_pool", "runs": runs, "launches": launches,
          "nvidia_smi": smi})
    return {"echo_step": launches["echo5"]["echo_step"],
            "unique_ids_step":
                launches["unique-ids3-challenge2"]["unique_ids_step"],
            "rounds_executed":
                runs["unique-ids3-challenge2"]["rounds_executed"]}


def phase_cli_crdt(smi):
    """The CRDT programs through the kernels: the pinned small runs, then
    the 1,000-node runs, each with the launch counters set to 0 just
    before and read just after. Every run valid with no overflow and no
    clipped draws; g-set loses no element."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_crdt")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, opts in CLI_CRDT:
        K.reset_launches()
        runs[name] = _run_line(name, opts, store, PINNED_CRDT)
        runs[name]["reduced"] = CLI_CRDT_REDUCED.get(name)
        launches[name] = K.launch_counts()
    for name, opts in CRDT_1000:
        K.reset_launches()
        runs[name] = _run_line(name, {**CRDT_1000_BASE, **opts}, store)
        runs[name]["reduced"] = CRDT_1000_REDUCED
        launches[name] = K.launch_counts()
    gset = "g-set1000-fanout3-loss"
    pn = "pn-counter1000-fanout3-loss-partition"
    check(runs[gset]["workload"]["lost-count"] == 0
          and runs[gset]["workload"]["stable-count"] > 0,
          f"{gset}: {runs[gset]['workload']}")
    check(runs[gset]["lost"] > 0 and runs[pn]["lost"] > 0
          and runs[pn]["dropped_partition"] > 0,
          "the 1,000-node runs' loss and partitions did not show")
    for k in GSET_KERNELS:
        check(launches[gset][k] > 0, f"{gset} did not launch {k}")
    for name in (pn, "g-counter1000-fanout3"):
        for k in CRDT_KERNELS:
            check(launches[name][k] > 0, f"{name} did not launch {k}")
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_crdt", "runs": runs, "launches": launches,
          "nvidia_smi": smi})
    return {k: launches[pn][k] for k in ("pn_counter_step",
                                         "reply_log_append_i32")}


def phase_pool_profile(rounds_executed):
    """The flight pool's torch ops at the pool-path unique-ids run's
    shape (3 nodes, 3 clients, a 4,096-slot pool, 8-slot inboxes), on a
    state the run reaches: `_send` of the 3-row inject and of the
    24-row outbox, `_deliver`, and `count_by_type` over the outbox, each
    timed against the bytes it must move. `rounds_executed` (the cli_pool
    run's) counts their calls on the path: a round sends twice, delivers
    once, and counts types once a send."""
    import torch
    from maelstrom_tpu_torch import core, prng
    from maelstrom_tpu_torch.net import tpu as T
    from maelstrom_tpu_torch.nodes.unique_ids import T_GEN
    from maelstrom_tpu_torch.runner.tpu_runner import TpuRunner
    from maelstrom_tpu_torch.sim import make_scan_fn
    runner = TpuRunner(core.build_test({
        "workload": "unique-ids", "node": "tpu:unique-ids", "node_count": 3,
        "rate": 1000.0, "journal_rows": False}))
    prog, cfg = runner.program, runner.cfg
    scan = make_scan_fn(prog, cfg, reply_cap=runner.reply_log_cap,
                        device=runner.device)
    rows = [(p, {}, p % 3, T_GEN, 0, 0, 0) for p in range(3)]
    inject = runner._encode_inject(rows)
    sim = scan(runner.sim, inject, 1, False)[0]
    net, key = sim.net, prng.PRNGKey(3, "cuda")
    N, O, P = cfg.n_nodes, prog.outbox_cap, cfg.pool_cap
    flat = T.Msgs.empty(N * O, "cuda").replace(
        valid=torch.ones(N * O, dtype=torch.bool, device="cuda"),
        dest=torch.full((N * O,), N, dtype=torch.int32, device="cuda"))
    msg = 37         # bytes of a message row: valid and nine int32 fields
    CC = min(cfg.client_cap, P)
    out = {}
    for name, fn, io, calls in (
            ("_send inject", lambda: T._send(cfg, net, inject, key),
             P + 3 * msg * 3, rounds_executed),
            ("_send outbox", lambda: T._send(cfg, net, flat, key),
             P + N * O * msg * 3, rounds_executed),
            ("_deliver", lambda: T._deliver(cfg, net),
             P * msg + P + N * prog.inbox_cap * msg + CC * msg,
             rounds_executed),
            ("count_by_type", lambda: T.count_by_type(
                net.stats.sent_by_type, flat.type, flat.valid),
             N * O * 5 + 2 * 4 * T.TYPE_BUCKETS, 2 * rounds_executed)):
        out[name] = {"ms": cuda_ms(fn), "bound_ms": bound_ms(io),
                     "bound_by": "bytes", "bytes": io, "calls": calls,
                     "library_ms": None}
    emit({"phase": "pool_profile", "nodes": N, "pool": P,
          "inbox_slots": prog.inbox_cap, "functions": out})


def phase_crdt_profile():
    """Where the 1,000-node pn-counter run's round goes: the runner's own
    program, config and scan fn, 1,000 adds injected, 40 rounds on the
    host clock, then 40 under the profiler (device busy ms a round,
    K13's ms, the rest of the port's kernels, the torch ops of the flight
    pool and the round's glue), and the flight pool's send and delivery
    timed alone on the state the window left."""
    import torch
    from maelstrom_tpu_torch import core
    from maelstrom_tpu_torch.nodes.pn_counter import T_ADD
    from maelstrom_tpu_torch.runner.tpu_runner import TpuRunner
    from maelstrom_tpu_torch.sim import make_scan_fn
    opts = {**CRDT_1000_BASE, **dict(CRDT_1000)[
        "pn-counter1000-fanout3-loss-partition"]}
    runner = TpuRunner(core.build_test(opts))
    prog, cfg = runner.program, runner.cfg
    scan = make_scan_fn(prog, cfg, reply_cap=runner.reply_log_cap,
                        device=runner.device)
    rows = [(p, {}, p % cfg.n_nodes, T_ADD, 1 + p % 4, 0, 0)
            for p in range(cfg.n_clients)]
    sim = scan(runner.sim, runner._encode_inject(rows), 20, False)[0]
    empty = runner._encode_inject([])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = scan(sim, empty, 40, False)[0]
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / 40
    state = {"sim": sim}

    def window():
        state["sim"] = scan(state["sim"], empty, 40, False)[0]
    wrap, complete, note = anchored(_append_launches, "append_kernel")
    evs = traced(wrap(window), complete, "crdt profile", keep_last=True)
    note("crdt profile")
    sim = state["sim"]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3 / 40
    check(busy_ms > 0, "crdt profile: the trace holds no device time")

    def ms(pred):
        return sum(e.self_device_time_total for e in evs
                   if pred(e.key)) / 1e3 / 40
    own = ms(lambda k: any(n in k for n in OWN_KERNELS))
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:12]
    # the flight pool's share: a round sends the inject batch once and
    # delivers once, timed alone on the state the window left
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch.net import tpu as T
    key = prng.PRNGKey(1, "cuda")
    pool_ms = (cuda_ms(lambda: T._send(cfg, sim.net, empty, key))
               + cuda_ms(lambda: T._deliver(cfg, sim.net)))
    emit({"phase": "crdt_profile", "run": opts["workload"],
          "nodes": cfg.n_nodes, "rounds": 40,
          "host_ms_per_round": host_ms,
          "device_busy_ms_per_round": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / host_ms),
          "pn_counter_step_ms_per_round": ms(
              lambda k: "pn_counter_kernel" in k),
          "own_kernels_ms_per_round": own,
          "torch_ops_ms_per_round": busy_ms - own,
          "pool_ms_per_round": pool_ms,
          "top": [{"name": e.key[:60],
                   "ms_per_round": e.self_device_time_total / 1e3 / 40,
                   "calls_per_round": e.count / 40} for e in top]})


# --- kafka and the fault sweeps ---------------------------------------------

# the kernels a kafka round launches (no quiescence probe: the beat
# timer ticks forever) and those of the broadcast fuzz's run_fn rounds
KAFKA_KERNELS = ("kafka_step", "edge_read", "edge_write", "edge_faults",
                 "reply_compact", "reply_log_append", "threefry")
FUZZ_KERNELS = ("broadcast_step", "edge_read", "edge_write", "edge_faults",
                "reply_compact", "threefry")

# Kafka through `core.run` and the CLI: the JAX package's kafka e2e
# configs (tests/test_kafka.py test_kafka_tpu_e2e, and
# tests/test_kafka_stream.py test_kafka_groups_e2e_round_synchronous and
# test_wide_keys_kill_nemesis_regression), then Gossip Glomers'
# challenge 5b (fly.io dist-sys 5b: --node-count 2 --concurrency 2n
# --time-limit 20 --rate 1000) with --key-count 4, its time limit cut
# from 20 s to 1.5 s and then 1 s (`CLI_KAFKA_REDUCED`), the wide8 kill
# run from 4 s to 2 s, and the two e2e runs from 3 s to 2 s.
# tests/test_torch_runner_kafka.py holds each against the JAX runner on
# the CPU.
KAFKA_BASE = {"workload": "kafka", "node": "tpu:kafka", "node_count": 5,
              "journal_rows": False}
CLI_KAFKA = [
    ("kafka5-e2e", {**KAFKA_BASE, "rate": 20.0, "time_limit": 2.0,
                    "seed": 7}),
    ("kafka5-groups2", {**KAFKA_BASE, "rate": 20.0, "time_limit": 2.0,
                        "seed": 11, "kafka_groups": 2}),
    ("kafka5-wide8-groups2-kill", {
        **KAFKA_BASE, "rate": 60.0, "time_limit": 2.0, "seed": 5,
        "concurrency": 8, "key_count": 8, "kafka_groups": 2,
        "session_timeout_ms": 400.0, "timeout_ms": 800, "recovery_s": 1.5,
        "nemesis": {"kill"}, "nemesis_interval": 0.9}),
    ("kafka2-challenge5b", [
        "test", "-w", "kafka", "--node", "tpu:kafka", "--node-count", "2",
        "--concurrency", "4", "--rate", "1000", "--time-limit", "1",
        "--key-count", "4", "--seed", "7"]),
]
CLI_KAFKA_REDUCED = {
    "kafka5-e2e": {"time_limit_s": 2.0, "from": 3.0,
                   "rounds_executed_from": 3000, "why": WHY_SERVICES},
    "kafka5-groups2": {"time_limit_s": 2.0, "from": 3.0,
                       "rounds_executed_from": 3000, "why": WHY_SERVICES},
    "kafka2-challenge5b": {
        "time_limit_s": 1.0, "from": 20.0, "cut_again_from": 1.5,
        "rounds_executed_from": 1501, "why_again": WHY_SERVICES,
        "why": "at 20 s the full-prefix polls put some 30 M pairs in the "
               "history, past what the JAX runner derives a pin for on a "
               "CPU; then cut from 5 s to 1.5 s to pay for the "
               "batched-broadcast phases"},
    "kafka5-wide8-groups2-kill": {
        "time_limit_s": 2.0, "from": 4.0,
        "why": "to pay for the batched-broadcast phases; the kill "
               "interval kept at 0.9 s, so the cut run has half the "
               "nemesis ops"}}
# sha256 of the JAX runner's history.jsonl for each run above, on the CPU;
# re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_runner_kafka.py \
#       -m slow
PINNED_KAFKA = {
    "kafka5-e2e":
        "1a7528c7de3337eb7a05a5a4e66fa63b82bbfc6c5b6e0490af8d9cc115be151a",
    "kafka5-groups2":
        "1c0b278581b72a142a7fd8238b86d9fbda7ca15f4784cb1447ba13db04f74ba6",
    "kafka5-wide8-groups2-kill":
        "b59b7a81d7ed8df9c8b3dbcdbbdbc1389aaf7d8830d33725a14a1da517ad26cd",
    "kafka2-challenge5b":
        "9b7d82b022dd701b41bbbe896e4678ffc7a5891508b6c94396c486b96e68446f",
}

# fuzz.fuzz_kafka's five configs at 5 nodes, cut from 6 s to 2 s with the
# nemesis interval scaled with it (2 s -> 0.667 s: the 6 s sweep's
# partitions and heals), then the time limit alone to 1 s (to pay for
# the batched-broadcast phases: one partition, from 0.667 s to the
# end); the client RPC timeout stays the runner's 5 s
FUZZ_KAFKA = {"n_nodes": 5, "seed": 0, "time_limit": 1.0,
              "nemesis_interval": 0.667}
FUZZ_KAFKA_REDUCED = {"time_limit_s": 1.0, "from": 6.0,
                      "nemesis_interval_s": 0.667,
                      "nemesis_interval_from": 2.0}
# BASELINE config 5: fuzz --program broadcast --nodes 100000 --values 32
FUZZ_100K = {"n_nodes": 100_000, "values": 32, "seed": 0}
# The same sweep at 4,096 nodes, whose rows (less wall_s) must equal the
# JAX package's fuzz.fuzz_broadcast on the CPU; re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fuzz.py -m slow
FUZZ_PIN_ARGS = {"n_nodes": 4096, "values": 32, "seed": 0}
PINNED_FUZZ = [
    {"config": "zero-latency+partition", "nodes": 4096, "values": 32,
     "values_born": 32, "ok": True, "converged_at_round": 500,
     "delivered": 503425, "lost": 0, "dropped_partition": 53420,
     "dropped_overflow": 0, "channel_overwrites": 0, "latency_clipped": 0,
     "latency_clip_tolerated": False},
    {"config": "latency2+loss5%+partition", "nodes": 4096, "values": 32,
     "values_born": 30, "ok": True, "converged_at_round": 600,
     "delivered": 471034, "lost": 24736, "dropped_partition": 58982,
     "dropped_overflow": 0, "channel_overwrites": 0, "latency_clipped": 0,
     "latency_clip_tolerated": False},
    {"config": "uniform-latency+partition", "nodes": 4096, "values": 32,
     "values_born": 32, "ok": True, "converged_at_round": 600,
     "delivered": 674418, "lost": 0, "dropped_partition": 59095,
     "dropped_overflow": 0, "channel_overwrites": 0, "latency_clipped": 0,
     "latency_clip_tolerated": True},
    {"config": "exponential-latency+loss2%", "nodes": 4096, "values": 32,
     "values_born": 32, "ok": True, "converged_at_round": 500,
     "delivered": 682857, "lost": 14037, "dropped_partition": 0,
     "dropped_overflow": 0, "channel_overwrites": 0, "latency_clipped": 0,
     "latency_clip_tolerated": True},
]


def _kafka_program(n, device="cuda", **opts):
    from maelstrom_tpu_torch.nodes import get_program
    return get_program("kafka", opts, [f"n{i}" for i in range(n)],
                       device=device)


def _cli_flag(args, flag, cast):
    """The value of `flag` in a CLI argument list."""
    return cast(args[args.index(flag) + 1])


_CLI_5B = dict(CLI_KAFKA)["kafka2-challenge5b"]
# name: (nodes, program opts) of K14's checks: each pinned run's shape
# (the three 5-node runs from their own `CLI_KAFKA` options, and the
# challenge-5b run from its CLI flags: log_cap from rate x time limit),
# the kafka fuzz's shape (classic, 5 nodes, `FUZZ_KAFKA`'s time limit),
# and a stress shape at the 15-bit length field's cap, classic and with
# 16 groups of 254 members (some 50 MB of log each)
KAFKA_SHAPES = {
    **{name: (run["node_count"], run) for name, run in CLI_KAFKA
       if isinstance(run, dict)},
    "5b": (_cli_flag(_CLI_5B, "--node-count", int), {
        "key_count": _cli_flag(_CLI_5B, "--key-count", int),
        "rate": _cli_flag(_CLI_5B, "--rate", float),
        "time_limit": _cli_flag(_CLI_5B, "--time-limit", float),
        "concurrency": _cli_flag(_CLI_5B, "--concurrency", int)}),
    "fuzz": (FUZZ_KAFKA["n_nodes"], {"rate": 20.0,
                                     "time_limit": FUZZ_KAFKA["time_limit"]}),
    "stress-classic": (64, {"key_count": 6, "log_cap": 32_766}),
    "stress-groups": (64, {"key_count": 8, "kafka_groups": 16,
                           "concurrency": 254, "log_cap": 24_576,
                           "session_timeout_ms": 30.0}),
}


def _random_kafka_inputs(g, prog, rnd):
    """A kafka step's inputs on the card (the gpu tests' numpy
    `random_kafka_inputs` in torch): logs full on some keys and empty on
    others, offers at, below and above the receiver's length from
    several edges, stray lane types; sends to owners and not with keys
    past both ends, packed commits, lists and polls; in group mode
    subscribes, fetches with cursors past the log, banked commits whose
    generation matches about half the time (the rest fenced), lists of
    both banks, and members past the session timeout."""
    import torch
    from maelstrom_tpu_torch.net.static import EdgeMsgs
    from maelstrom_tpu_torch.net.tpu import Msgs, wrap_i32 as i32
    N, Kk, C, D, G, M = prog.n_nodes, prog.K, prog.cap, prog.D, prog.G, \
        prog.M
    A = prog.inbox_cap

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int64)

    def coin(p, shape):
        return torch.rand(shape, generator=g, device="cuda") < p

    log_len = ints(0, C + 1, (N, Kk))
    log_len = torch.where(coin(0.15, (N, Kk)), C, log_len)
    log_len = torch.where(coin(0.15, (N, Kk)), 0, log_len)
    state = {"log": i32(ints(0, 1000, (N, Kk, C))), "log_len": i32(log_len),
             "peer_len": i32(ints(-1, C + 2, (N, D, Kk))),
             "committed": i32(ints(-3, 40, (N, Kk))),
             "log_overflow": i32(ints(0, 3, (N,)))}
    ggen = ints(0, 70_000, (N, max(G, 1)))
    if G:
        state["gactive"] = coin(0.5, (N, G, M))
        state["gseen"] = i32(rnd - ints(0, 2 * prog.session_rounds + 2,
                                        (N, G, M)))
        state["ggen"] = i32(ggen)
        state["gcommitted"] = i32(ints(-3, 40, (N, G, Kk)))
    ll = log_len[:, None, :]
    edge_in = EdgeMsgs(
        valid=coin(0.7, (N, D, Kk)),
        type=i32(torch.where(coin(0.85, (N, D, Kk)), 20,
                             ints(0, 40, (N, D, Kk)))),
        a=i32(ll + ints(-2, 4, (N, D, Kk))),
        b=i32(ll + ints(-2, 3, (N, D, Kk))),
        c=i32(ints(0, 1000, (N, D, Kk))))
    types = torch.tensor([10, 12, 14, 16, 30, 32, 34, 37, 0, 99],
                         device="cuda")
    ty = types[ints(0, len(types), (N, A))]
    a, b, c = (ints(-2**31, 2**31 - 1, (N, A)) for _ in range(3))

    def packed():
        return ints(0, 40, (N, A)) | (ints(0, 40, (N, A)) << 16)
    send = ty == 10
    a = torch.where(send, ints(-1, Kk + 1, (N, A)), a)
    b = torch.where(send, ints(0, 1000, (N, A)), b)
    cm = ty == 14
    a, b, c = (torch.where(cm, packed(), w) for w in (a, b, c))
    if G:
        gi = ints(0, G + 1, (N, A))
        m = ints(0, M + 1, (N, A))
        a = torch.where((ty == 30) | (ty == 32), (gi << 10) | m, a)
        fetch = ty == 32
        b = torch.where(fetch, (ints(-1, Kk + 1, (N, A)) << 16)
                        | ints(0, C + 3, (N, A)), b)
        c = torch.where(fetch, ints(-2, 12, (N, A)), c)
        gen = ggen.gather(1, gi.clamp(max=G - 1))
        gen = torch.where(coin(0.6, (N, A)), gen & 0xFFFF,
                          ints(0, 0xFFFF, (N, A)))
        bank = ints(0, 2, (N, A))
        gc = ty == 34
        a = torch.where(gc, (bank << 30) | (gi.clamp(max=15) << 26)
                        | (m.clamp(max=1023) << 16) | gen, a)
        b, c = (torch.where(gc, packed(), w) for w in (b, c))
        a = torch.where(ty == 37, (bank << 30) | gi, a)
    client_in = Msgs(
        valid=coin(0.6, (N, A)), src=i32(ints(N, 2 * N, (N, A))),
        dest=i32(torch.arange(N, device="cuda")[:, None].expand(N, A)),
        due=i32(ints(0, 99, (N, A))), mid=i32(ints(0, 1 << 30, (N, A))),
        reply_to=torch.full((N, A), -1, dtype=torch.int32, device="cuda"),
        type=i32(ty), a=i32(a), b=i32(b), c=i32(c))
    return state, edge_in, client_in


def kafka_kernel_checks(timed):
    """K14 kafka_step against its plain version at `KAFKA_SHAPES`, with
    and without the stall mask, on a beat round and an ordinary one;
    every output field and state leaf exact, the inputs untouched. Timed
    at the 5b and the classic stress shapes."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    out = {}
    err = 0
    timing = {}
    for shape, (n, opts) in KAFKA_SHAPES.items():
        prog = _kafka_program(n, **opts)
        for rnd in (64, 37):
            state, ein, cin = _random_kafka_inputs(g, prog, rnd)
            stall = torch.rand(n, generator=g, device="cuda") < 0.4
            for st in (None, stall):
                ctx = {"round": torch.tensor(rnd, dtype=torch.int32,
                                             device="cuda")}
                if st is not None:
                    ctx["stall"] = st
                before = clone(state)

                def k14(ctx=ctx, state=state, ein=ein, cin=cin, prog=prog):
                    return prog.edge_step(state, ein, cin, ctx)
                got = k14()
                with K.forced_plain():
                    ref = k14()
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, ref),
                          max_abs_err(state, before))
                if st is None and rnd == 37:
                    timing[shape] = (prog, k14, state, ein, cin)
    check(err == 0, f"kafka_step differs from its plain version (max abs "
          f"err {err})")
    for shape in ("5b", "stress-classic"):
        prog, k14, state, ein, cin = timing[shape]
        N, D, Kk, C = prog.n_nodes, prog.D, prog.K, prog.cap
        A = prog.inbox_cap
        # the log copied (read and written), the other state leaves read
        # and written (log_len, committed 8 bytes a key; peer_len; the
        # overflow counter), the lanes in (17 bytes) and out (17), the
        # client slots in (29 bytes) and out (37), the neighbour table
        io = (8 * N * Kk * C + 16 * N * Kk + 8 * N * D * Kk + 8 * N
              + 34 * N * D * Kk + 66 * N * A + 4 * N * D)
        # the operations the function needs: a lane tests valid, type,
        # b == len, b < a, b < C and records its peer length (6), picks
        # the first offer (2), builds its outbound lane (want < have,
        # beat, changed, neighbour, the entry's clip and gather: 8); a
        # slot decodes and routes (about 40 with the packed fields)
        ops = 16 * N * D * Kk + 40 * N * A
        b, by = bound_of(io, ops)
        r = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
             "bytes": io, "operations": ops, "nodes": N, "keys": Kk,
             "log_cap": C, "degree": D}
        if timed:
            r["ms"] = cuda_ms(k14)
            with K.forced_plain():
                r["plain_ms"] = cuda_ms(k14)
        out[f"{K.KAFKA_STEP.name}@{shape}"] = r
    return out


def phase_kafka_kernels(timed):
    t0 = time.perf_counter()
    r = kafka_kernel_checks(timed)
    emit({"phase": "kafka_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


def phase_cli_kafka(smi):
    """Kafka through the kernels: the pinned runs, each with the launch
    counters set to 0 just before and read just after; every history
    must hash to the JAX runner's, every run valid with no log overflow,
    acked sends, polls and replication traffic."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_kafka")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, run in CLI_KAFKA:
        K.reset_launches()
        runs[name] = _run_line(name, run, store, PINNED_KAFKA)
        runs[name]["reduced"] = CLI_KAFKA_REDUCED.get(name)
        launches[name] = K.launch_counts()
        w = runs[name]["workload"]
        check(runs[name]["log_overflow"] == 0 and w["acked-sends"] > 0
              and w["polls"] > 0 and runs[name]["server_msgs"] > 0,
              f"kafka {name}: {runs[name]}")
        for k in KAFKA_KERNELS:
            check(launches[name][k] > 0, f"kafka {name} did not launch {k}")
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_kafka", "runs": runs, "launches": launches,
          "nvidia_smi": smi})
    return {k: sum(v[k] for v in launches.values()) for k in KAFKA_KERNELS}


def phase_fuzz_kafka(smi):
    """fuzz.fuzz_kafka's five configs through the kernels: every one ok,
    partitions and losses showing where the config has them."""
    import shutil
    from maelstrom_tpu_torch import fuzz
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_fuzz")
    shutil.rmtree(store, ignore_errors=True)
    K.reset_launches()
    t0 = time.perf_counter()
    rows = fuzz.fuzz_kafka(**FUZZ_KAFKA, store_root=store,
                           log=lambda s: print(s, file=sys.stderr))
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    for c, r in zip(fuzz.KAFKA_SWEEP, rows):
        check(r["ok"] and r["dropped_overflow"] == 0
              and (r["dropped_partition"] > 0 or not c["partition"])
              and (r["lost"] > 0 or not c["p_loss"]),
              f"fuzz kafka {c['name']}: {r}")
    for k in KAFKA_KERNELS:
        check(launches[k] > 0, f"the kafka fuzz did not launch {k}")
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "fuzz_kafka", "reduced": FUZZ_KAFKA_REDUCED,
          "wall_s": wall, "rows": rows, "launches": launches,
          "nvidia_smi": smi})


def phase_fuzz_broadcast(smi):
    """BASELINE config 5: the broadcast fuzz at 4,096 nodes, whose rows
    must equal the JAX package's (`PINNED_FUZZ`), then at 100,000 nodes
    with the launch counters set to 0 just before and read just after:
    every config converged, no overflow, the faults showing."""
    from maelstrom_tpu_torch import fuzz
    from maelstrom_tpu_torch import kernels as K

    def sweep(args):
        t0 = time.perf_counter()
        rows = fuzz.fuzz_broadcast(**args,
                                   log=lambda s: print(s, file=sys.stderr))
        return rows, time.perf_counter() - t0
    rows, wall4k = sweep(FUZZ_PIN_ARGS)
    got = [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]
    check(got == PINNED_FUZZ, f"fuzz 4,096 nodes: rows {got}, the JAX "
          f"package's {PINNED_FUZZ}")
    K.reset_launches()
    rows, wall = sweep(FUZZ_100K)
    launches = K.launch_counts()
    for c, r in zip(fuzz.DEFAULT_SWEEP, rows):
        check(r["ok"] and r["dropped_overflow"] == 0
              and r["values_born"] > 0
              and (r["dropped_partition"] > 0 or not c["partition"])
              and (r["lost"] > 0 or not c["p_loss"]),
              f"fuzz 100,000 nodes {c['name']}: {r}")
    for k in FUZZ_KERNELS:
        check(launches[k] > 0, f"the 100,000-node fuzz did not launch {k}")
    emit({"phase": "fuzz_100k", "wall_s": wall, "wall_4096_s": wall4k,
          "rows_4096_equal_jax": True, "rows": rows, "launches": launches,
          "nvidia_smi": smi})


# --- batched atomic broadcast and the ordering axis -------------------------

# the kernels a batched-broadcast CLI round launches beside its step (K6
# probes its quiescence; K5 snapshots the seen words the read replies
# carry), and
# those of the ordered runs: lin-kv over the batched engine, kafka over
# the raft engine
BATCHED_KERNELS = ("edge_read", "edge_write", "edge_faults",
                   "reply_compact", "reply_log_append", "threefry",
                   "quiet_probe")
ORDERED_KERNELS = {"batched": ("broadcast_batched_step", "edge_read",
                               "edge_write", "reply_log_append"),
                   "raft": ("raft_step", "edge_read", "edge_write",
                            "reply_log_append")}

# The JAX package's batched-broadcast runs (tests/test_broadcast_batched.py
# test_batched_broadcast_tpu_e2e, and the combined-nemesis run of
# test_verdict_bit_equal_under_combined_nemesis), and the ordering axis
# at tests/test_ordering.py's base options (seed 7, rate 12; 1.6 s there,
# cut to 1 s, `CLI_ORDERED_REDUCED`): lin-kv over the batched engine,
# kafka over the raft engine.
BATCHED_BASE = {"workload": "broadcast-batched",
                "node": "tpu:broadcast-batched", "node_count": 5,
                "topology": "grid", "journal_rows": False}
CLI_BATCHED = [
    ("batched5-e2e", {**BATCHED_BASE, "rate": 20.0, "time_limit": 1.0,
                      "seed": 7}),
    ("batched5-nemesis", {**BATCHED_BASE, "rate": 20.0, "time_limit": 3.0,
                          "recovery_s": 2.0, "seed": 13,
                          "nemesis": {"kill", "partition", "duplicate"},
                          "nemesis_interval": 0.8, "timeout_ms": 1000}),
]
CLI_BATCHED_REDUCED = {
    "batched5-e2e": {"time_limit_s": 1.0, "from": 2.0,
                     "rounds_executed_from": 2002, "why": WHY_SERVICES},
    "batched5-nemesis": {
    "timeout_ms": 1000, "from": 5000, "rounds_executed": 3200,
    "rounds_from": 7204,
    "why": "to pay for the stream slice: an op to a killed node held "
           "the main phase 5 s at its timeout; at 1 s the time limit, "
           "recovery and nemesis interval are kept, every fault counter "
           "still shows (cutting the time limit to 1.5 s removed 1,576 "
           "rounds, the timeout 4,004)"}}
ORDERED_BASE = {"seed": 7, "rate": 12.0, "time_limit": 1.0,
                "journal_rows": False}
CLI_ORDERED_REDUCED = {"time_limit_s": 1.0, "from": 1.6,
                       "rounds_executed_from": 1600, "why": WHY_SERVICES}
CLI_ORDERED = [
    ("linkv-ordered-batched", {**ORDERED_BASE, "workload": "lin-kv",
                               "ordering": "batched"}),
    ("kafka-ordered-raft", {**ORDERED_BASE, "workload": "kafka",
                            "ordering": "raft"}),
]
# sha256 of the JAX runner's history.jsonl for each run above, on the CPU;
# re-derived by
#   JAX_PLATFORMS=cpu python -m pytest \
#       tests/test_torch_runner_batched.py -m slow
PINNED_BATCHED = {
    "batched5-e2e":
        "8af12805afe548f062005cf576e67b1ed38217f7c3708b7682c6beded5a16ff9",
    "batched5-nemesis":
        "361f5de5b2621fcb13526e0f896e38adaa890d94cbee41b5764187e73c82d0c4",
    "linkv-ordered-batched":
        "5dfe10fcc59aea9a1703d97bce4261ffff1f324e810c85a42207b6746c629cd2",
    "kafka-ordered-raft":
        "d94c458b932fa7da7aab8f41515664fe62c65e955d6a13b82f41d65047ffc533",
}

# bench.py's batched-vs-eager record at its defaults (4,096 nodes, 512
# values, batches of 32, chunks of 64 rounds), and the JAX package's
# rounds to converge and delivered messages and units for each side
# (bench.bench_broadcast_batched_record on the CPU); re-derived by
#   JAX_PLATFORMS=cpu python -m pytest \
#       tests/test_torch_runner_batched.py -m slow -k bench
BATCHED_BENCH = {"n_nodes": 4096, "values": 512, "batch": 32, "chunk": 64}
PINNED_BATCHED_BENCH = {
    "eager": {"rounds_to_convergence": 1088,
              "messages_delivered": 15_783_768,
              "units_delivered": 15_783_768},
    "batched": {"rounds_to_convergence": 192,
                "messages_delivered": 480_611,
                "units_delivered": 7_968_522},
}
BENCH_PIN_KEYS = ("rounds_to_convergence", "messages_delivered",
                  "units_delivered")


def _batched_program(n, V, per_nb, eager=False, device="cuda", **opts):
    from maelstrom_tpu_torch.nodes import get_program
    return get_program("broadcast-batched",
                       {"topology": "grid", "max_values": V,
                        "gossip_per_neighbor": per_nb, "eager_resend": eager,
                        "latency": {"mean": 0}, **opts},
                       [f"n{i}" for i in range(n)], device=device)


# name: (nodes, values, ranges an edge, eager, client batch span) of
# K15's checks: the pinned runs' shapes (the CLI runs at V 1,024, the
# ordered lin-kv run at V 2 x 12 x 1.6 + 256 = 294), the bench's, the
# CLI default at 1,024 nodes, a 100,000-node stress shape, a wrap
# shape whose batches span past id 65,536 (the proof's int32 sum wraps),
# a wide table (V 280,000, once past the first design's shared-memory
# masks), small tables whose rows share a warp at every 16-byte offset
# (V 17 and 64), and a table of three tiles whose pending runs end on
# the rows' tile edges (`tile_edges`)
BATCHED_SHAPES = {
    "cli5": (5, 1024, 2, False, 16),
    "ordered5": (5, 294, 2, False, 1),
    "bench": (4096, 512, 1, True, 32),
    "cli1024": (1024, 1024, 2, False, 16),
    "stress100k": (100_000, 1024, 2, False, 64),
    "wrap": (64, 70_000, 2, False, 70_000),
    "wideV": (1089, 280_000, 2, False, 280_000),
    "small17": (16, 17, 2, False, 4),
    "small64": (33, 64, 4, True, 16),
    "tile_edges": (17, 1501, 3, False, 64),
}
# K15's timed shapes (the smoke's kernels line reads stress100k)
BATCHED_TIMED = ("cli5", "bench", "stress100k")


def tile_edge_pending(N, D, V):
    """[N, D, V] pending planes (on the card) whose runs end on each edge
    row's first two 512-value tile edges: row r = n * D + d sits at byte
    offset r * V % 16 of its plane, its tiles at t * 512 - offset."""
    import torch
    v = torch.arange(V, device="cuda")[None, None, :]
    s = (torch.arange(N * D, device="cuda").reshape(N, D, 1) * V) % 16
    return (v < 512 - s) | ((v >= 515 - s) & (v < 1024 - s))


def _random_batched_inputs(g, prog, span):
    """A batched step's inputs on the card: pending planes of sparse,
    half and dense runs, range lanes at and past both ends of the table
    (some of the whole table), digests of every window and past the
    last, stray lane types; client batches of up to `span` ids from
    every start (some the whole table), reads and stray types."""
    import torch
    from maelstrom_tpu_torch.net.static import EdgeMsgs
    from maelstrom_tpu_torch.net.tpu import Msgs, wrap_i32 as i32
    N, D, V, W = prog.n_nodes, prog.D, prog.V, prog.n_windows
    L = prog.edge_cfg.lanes
    K_ = prog.inbox_cap

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int64)

    def coin(p, shape):
        return torch.rand(shape, generator=g, device="cuda") < p

    dens = torch.tensor([0.02, 0.5, 0.97], device="cuda")[
        ints(0, 3, (N, D, 1))]
    plane = (N, D, V)
    state = {"seen": coin(0.3, (N, V)),
             "pending": torch.rand(plane, generator=g, device="cuda") < dens,
             "inflight": coin(0.2, plane), "inflight_old": coin(0.2, plane),
             "owed": coin(0.3, (N, D, W))}
    shape = (N, D, L)
    typ = torch.tensor([24, 24, 15, 14, 0], device="cuda")[
        ints(0, 5, shape)]
    a = torch.where(typ == 15, ints(0, W + 1, shape), ints(-2, V + 3, shape))
    b = torch.where(coin(0.1, shape), V + 5, ints(-2, max(V // 8, 4), shape))
    b = torch.where(typ == 15, ints(-2**31, 2**31 - 1, shape), b)
    edge_in = EdgeMsgs(valid=coin(0.6, shape), type=i32(typ), a=i32(a),
                       b=i32(b), c=i32(ints(-2**31, 2**31 - 1, shape)))
    cs = (N, K_)
    ctyp = torch.tensor([20, 20, 22, 10, 0], device="cuda")[ints(0, 5, cs)]
    ca = torch.where(coin(0.1, cs), 0, ints(-1, V + 2, cs))
    cb = torch.where(coin(0.1, cs), span, ints(-1, span + 2, cs))
    client_in = Msgs(
        valid=coin(0.5, cs), src=i32(ints(N, 2 * N, cs)),
        dest=i32(torch.arange(N, device="cuda")[:, None].expand(cs)),
        due=i32(ints(0, 99, cs)), mid=i32(ints(0, 1 << 30, cs)),
        reply_to=torch.full(cs, -1, dtype=torch.int32, device="cuda"),
        type=i32(ctyp), a=i32(ca), b=i32(cb),
        c=i32(ints(-2**31, 2**31 - 1, cs)))
    if span >= V:
        # every node's first slot a batch of the whole table
        client_in.valid[:, 0] = True
        client_in.type[:, 0] = 20
        client_in.a[:, 0] = 0
        client_in.b[:, 0] = V
    return state, edge_in, client_in


def batched_io_ops(prog, L, K_):
    """(bytes, operations) one K15 step must move and do: seen and the
    three [N, D, V] planes read and written, owed read and written, the
    lanes in (17 bytes a lane) and out, the client slots in (29 bytes)
    and out (37), the neighbour table; a value tests each client slot's
    range (4), each arriving lane's once (4 a lane), ORs its D edges'
    arrivals into seen (D), tests its digest bit (4) and does the retry
    logic (8), as the plain version needs; the kernel's second test of
    the lanes is its own cost, not the function's."""
    N, D, V, W = prog.n_nodes, prog.D, prog.V, prog.n_windows
    io = (2 * N * V + 6 * N * D * V + 2 * N * D * W
          + 17 * N * D * (L + prog.lanes) + 66 * N * K_ + 4 * N * D)
    ops = N * V * (4 * K_ + D) + N * D * V * (4 * L + 12)
    return io, ops


def batched_kernel_checks(timed):
    """K15 broadcast_batched_step against its plain version at
    `BATCHED_SHAPES`, with and without the stall mask, on a retry-tick
    round and an ordinary one; every output field and state leaf exact,
    the inputs untouched. Timed at `BATCHED_TIMED`, the stall form with
    some 40% of the nodes stalled."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    g = torch.Generator(device="cuda")
    g.manual_seed(15)
    out, timing = {}, {}
    err = 0
    for shape, (n, V, per_nb, eager, span) in BATCHED_SHAPES.items():
        prog = _batched_program(n, V, per_nb, eager)
        for rnd in (3 * prog.retry_rounds, 3 * prog.retry_rounds + 1):
            state, ein, cin = _random_batched_inputs(g, prog, span)
            if shape == "tile_edges":
                state["pending"] = tile_edge_pending(n, prog.D, V)
            stall = torch.rand(n, generator=g, device="cuda") < 0.4
            for st in (None, stall):
                ctx = {"round": torch.tensor(rnd, dtype=torch.int32,
                                             device="cuda")}
                if st is not None:
                    ctx["stall"] = st
                before = clone((state, ein, cin))

                def k15(ctx=ctx, state=state, ein=ein, cin=cin, prog=prog):
                    return prog.edge_step(state, ein, cin, ctx)
                got = k15()
                with K.forced_plain():
                    ref = k15()
                torch.cuda.synchronize()
                e = max(max_abs_err(got, ref),
                        max_abs_err((state, ein, cin), before))
                check(e == 0, f"broadcast_batched_step@{shape} stall="
                      f"{st is not None} round {rnd}: max abs err {e}")
                err = max(err, e)
                if shape in ("wrap", "wideV"):
                    # the whole-table batches' proofs wrapped
                    c = got[2]
                    whole = (c.type == 21) & (c.b == V)
                    check(bool(whole.any()), "wrap: no whole-table batch")
                if rnd % prog.retry_rounds == 1:
                    timing[shape, st is not None] = (prog, k15, ein, cin)
    for (shape, st), (prog, k15, ein, cin) in timing.items():
        if shape not in BATCHED_TIMED:
            continue
        io, ops = batched_io_ops(prog, ein.valid.shape[2],
                                 cin.valid.shape[1])
        b, by = bound_of(io, ops)
        r = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
             "bytes": io, "operations": ops, "nodes": prog.n_nodes,
             "values": prog.V, "degree": prog.D, "ranges": prog.per_nb}
        if timed:
            r["ms"] = cuda_ms(k15)
            with K.forced_plain():
                r["plain_ms"] = cuda_ms(k15, iters=5)
        kern = K.BROADCAST_BATCHED_STEP_STALL if st else \
            K.BROADCAST_BATCHED_STEP
        out[f"{kern.name}@{shape}"] = r
    return out


def phase_batched_kernels(timed):
    t0 = time.perf_counter()
    r = batched_kernel_checks(timed)
    emit({"phase": "batched_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0,
          "shapes": {k: dict(zip(("nodes", "values", "ranges", "eager",
                                  "batch_span"), v))
                     for k, v in BATCHED_SHAPES.items()},
          "kernels": r})
    return r


def phase_cli_batched(smi):
    """Batched broadcast through the kernels: the pinned runs, each with
    the launch counters set to 0 just before and read just after; every
    history must hash to the JAX runner's, every proof hold, no value
    lost, and the net carry more than one client op a message."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_batched")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, run in CLI_BATCHED:
        K.reset_launches()
        runs[name] = _run_line(name, run, store, PINNED_BATCHED)
        runs[name]["reduced"] = CLI_BATCHED_REDUCED.get(name)
        launches[name] = K.launch_counts()
        with open(os.path.join(store, "latest", "results.json")) as f:
            res = json.load(f)
        w, net = res["workload"], res["net"]
        check(w["proof-errors"] == [] and w["lost-count"] == 0
              and net.get("units-per-msg", 0) > 1,
              f"batched {name}: proofs {w['proof-errors']}, lost "
              f"{w['lost-count']}, units/msg {net.get('units-per-msg')}")
        runs[name].update({"units_per_msg": net["units-per-msg"],
                           "sent_units": net["sent-units"],
                           "proof_errors": 0})
        # a run with kill or pause steps through the stall form only
        stall = bool({"kill", "pause"} & set(run.get("nemesis", ())))
        step = "broadcast_batched_step" + ("_stall" if stall else "")
        for k in (step,) + BATCHED_KERNELS:
            check(launches[name][k] > 0, f"batched {name} did not launch "
                  f"{k}")
        check(all(launches[name][k] == 0 for k in BYZ_KERNELS),
              f"batched {name}: a benign run launched the adversary")
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_batched", "runs": runs, "launches": launches,
          "nvidia_smi": smi})
    return {k: sum(v[k] for v in launches.values())
            for k in ("broadcast_batched_step",
                      "broadcast_batched_step_stall")}


def phase_cli_ordered(smi):
    """The ordering axis through the kernels: lin-kv over the batched
    engine and kafka over the raft engine, each valid with its history
    hashed to the JAX runner's."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_ordered")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, run in CLI_ORDERED:
        K.reset_launches()
        runs[name] = _run_line(name, run, store, PINNED_BATCHED)
        runs[name]["reduced"] = CLI_ORDERED_REDUCED
        launches[name] = K.launch_counts()
        for k in ORDERED_KERNELS[run["ordering"]]:
            check(launches[name][k] > 0, f"ordered {name} did not launch "
                  f"{k}")
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_ordered", "runs": runs, "launches": launches,
          "nvidia_smi": smi})


def phase_bench_batched(smi):
    """bench.py's batched-vs-eager record at its defaults: both sides
    converge, no overflow, and each side's rounds to converge and
    delivered messages and units equal the JAX package's."""
    from maelstrom_tpu_torch.bench import run_broadcast_batched_bench
    rec = run_broadcast_batched_bench(**BATCHED_BENCH)
    check(rec["valid"], f"bench_batched: {rec}")
    for r in rec["protocols"]:
        got = {k: r[k] for k in BENCH_PIN_KEYS}
        check(got == PINNED_BATCHED_BENCH[r["protocol"]],
              f"bench_batched {r['protocol']}: {got}, the JAX package's "
              f"{PINNED_BATCHED_BENCH[r['protocol']]}")
    emit({"phase": "bench_batched", **rec, "counts_equal_jax": True,
          "nvidia_smi": smi})
    return rec



# --- Raft transactions, lin-mutex and device Elle ----------------------------

# The JAX package's e2e runs of the transaction programs, cut in depth
# to pay for the role-partition slice (`CLI_TXN_REDUCED`; the lengths
# in parentheses are the JAX tests'): tests/test_elle_device.py's device-vs-host run
# (seed 11, rate 25, 2 s) and its partition soup (seed 23, rate 15, 4 s,
# a partition every 2 s), both with the device checker on;
# tests/test_txn_rw_register.py's run (3 nodes, seed 7, rate 15, 3 s);
# lin-mutex on the Raft lin-kv program
# at the lin-kv runs' shape (5 nodes, seed 7, rate 15, 2 s); and a run
# whose 1,158 ok transactions engage the device checker on its own
# (`--device-checker auto` engages at 1,024): rate 500 over 20 clients
# for 3 s at 5 ms a round (the rate a 5-node cluster commits at 1 ms a
# round is some 1,000 a second for 5 clients), a dispatch a round (a
# reply lands in nearly every round: the port's scan of 16 rounds would
# roll back 15 of them; the history is the same at any bound).
TXN_BASE = {"workload": "txn-list-append", "node": "tpu:txn-list-append",
            "node_count": 5, "journal_rows": False}
CLI_TXN = [
    ("txn5-device-on", {**TXN_BASE, "rate": 25.0, "time_limit": 1.0,
                        "seed": 11, "device_checker": "on"}),
    ("txn5-partition-device-on", {
        **TXN_BASE, "rate": 15.0, "time_limit": 3.0, "seed": 23,
        "nemesis": {"partition"}, "nemesis_interval": 2.0,
        "device_checker": "on"}),
    ("rw-register3", {"workload": "txn-rw-register",
                      "node": "tpu:txn-rw-register", "node_count": 3,
                      "rate": 15.0, "time_limit": 2.0, "seed": 7,
                      "journal_rows": False}),
    ("lin-mutex5", {"workload": "lin-mutex", "node": "tpu:lin-kv",
                    "node_count": 5, "rate": 15.0, "time_limit": 1.0,
                    "seed": 7, "journal_rows": False}),
    ("txn5-auto", {**TXN_BASE, "rate": 500.0, "time_limit": 3.0,
                   "concurrency": 20, "ms_per_round": 5.0, "seed": 3,
                   "max_scan": 1}),
]
CLI_TXN_REDUCED = {
    "txn5-device-on": {"time_limit_s": 1.0, "from": 2.0,
                       "rounds_executed_from": 2000, "why": WHY_SERVICES},
    "txn5-partition-device-on": {
        "time_limit_s": 3.0, "from": 4.0, "rounds_executed_from": 4000,
        "why": WHY_SERVICES + "; the 2 s nemesis interval kept, so the "
               "partition runs 2-3 s (dropped-partition still shows)"},
    "rw-register3": {"time_limit_s": 2.0, "from": 3.0,
                     "rounds_executed_from": 3000, "why": WHY_SERVICES},
    "lin-mutex5": {"time_limit_s": 1.0, "from": 2.0,
                   "rounds_executed_from": 2002, "why": WHY_SERVICES}}
# (sha256 of the JAX runner's history.jsonl, its Elle `device` block or
# None) for each run above, on the CPU; re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_runner_txn.py \
#       -m slow -k pinned
PINNED_TXN = {
    "txn5-device-on": (
        "c26cb0b9c22aaeb65dfb1984fb492a72f6f9007c757237e79099e09d49d10e05",
        {"screen": {"data": "acyclic", "realtime": "acyclic",
                    "iters": [7, 0]},
         "edges-on-device": True, "edge-candidates": 66}),
    "txn5-partition-device-on": (
        "b2eeaee047c22da1de4ee643568d3eb01085c04e6bccc325a0374c069cc45bba",
        {"screen": {"data": "acyclic", "realtime": "acyclic",
                    "iters": [5, 0]},
         "edges-on-device": True, "edge-candidates": 95}),
    "rw-register3": (
        "f6fe58daf375c1bfeebd6354f6f76111fe380287f2742f52e5279280aa5f57d2",
        None),
    "lin-mutex5": (
        "dd66b5cfda2c54d374aa206f39a532d6bcfa843c6184682cbe2c4b481399665a",
        None),
    "txn5-auto": (
        "cf261f7763ec6959da1d11dce3a118e3ccfb21231fcdbcecc451cfb88962de99",
        {"screen": {"data": "acyclic", "realtime": "acyclic",
                    "iters": [32, 4]},
         "edges-on-device": True, "edge-candidates": 3845}),
}
# the kernels a transaction run launches: the Raft round's, and K16 and
# K17 where the device checker engages
TXN_KERNELS = ("raft_step", "edge_read", "edge_write", "reply_log_append")
ELLE_KERNELS = ("elle_edges", "elle_screen")



def _elle_inputs(txns, longest, appender, rt):
    """device_args of one transaction set (the checker's assembly); rt
    None: no realtime inputs."""
    from maelstrom_tpu_torch.checkers import elle_device as ed
    return ed.device_args(*ed.host_arrays(txns, longest, appender, repr,
                                          rt=rt))


def _elle_tables(txns):
    """(longest, appender, rt) as `elle.analyze_txns` builds them."""
    import numpy as np
    from maelstrom_tpu_torch.checkers.elle import _hk, _hv
    appender, longest = {}, {}
    for t in txns:
        for f, k, v in t["micro"]:
            if f == "append":
                appender[(_hk(k), _hv(v))] = t["id"]
    for t in txns:
        if t["ok"]:
            for f, k, v in t["micro"]:
                if f == "r" and isinstance(v, list) \
                        and len(v) > len(longest.get(_hk(k), [])):
                    longest[_hk(k)] = [_hv(x) for x in v]
    ok = sorted((t for t in txns if t["ok"]), key=lambda t: t["ret"])
    rets = np.array([t["ret"] for t in ok], np.float64)
    invs = np.array([t["inv"] for t in ok], np.float64)
    before = np.searchsorted(rets, invs, side="left") - 1
    return longest, appender, (np.array([t["id"] for t in ok], np.int64),
                               before)


def elle_shapes(synthetic):
    """name -> (edge args, screen args, Tp, have_rt) of K16 and K17's
    checks: every fixture history, random_append_history at 150
    transactions (seeds 0-3, every other one with 15% corrupt reads),
    and the full-width set `bench_checkers_record` grades (`synthetic`,
    `elle_synthetic` at 1,000,000 micro-ops: 64 keys, 3,125 versions a
    key; Vp 262,144, Rp 1,048,576, Tp 1,048,576), data stage only as the
    bench screens it, and again with its realtime inputs (realtime
    cyclic by design: 32 iterations over every edge and transaction)."""
    from maelstrom_tpu_torch.checkers.elle import _txn_ops
    from maelstrom_tpu_torch.testing.histories import (
        ELLE_FIXTURES, from_rows, random_append_history)
    out = {}
    hists = {f"fixture-{k}": from_rows(f()) for k, f in
             ELLE_FIXTURES.items()}
    hists.update({f"random150-{s}": random_append_history(
        s, n_txn=150, corrupt=0.15 if s % 2 else 0.0) for s in range(4)})
    for name, h in hists.items():
        txns = _txn_ops(h)
        longest, appender, rt = _elle_tables(txns)
        out[name] = _elle_inputs(txns, longest, appender, rt)
    txns, longest, appender, _ops = synthetic
    out["full"] = _elle_inputs(txns, longest, appender, None)
    out["full-rt"] = _elle_inputs(txns, longest, appender,
                                  _elle_tables(txns)[2])
    return out


def elle_io(eargs, sargs, tp, verdict):
    """(bytes, operations) of K16 and of K17 on one input: K16 reads its
    five planes once and writes 13 bytes a candidate row (a row's gathers
    and tests some 8 operations); K17 writes its four words and reads
    the seven planes of the data stage once (writers, slot_key,
    slot_idx; r_tid, r_n, wr_pos, rw_pos), the realtime stage's two
    (ret_tid, before_idx) only where the input has realtime inputs, and
    does what this input's iterations need: the data seed, then a pass
    over the edges (step 2 operations an edge, violation test 1) and,
    with realtime inputs, the rank seed and the realtime stage's passes,
    over the edges and over the transactions (bound 2, prefix max 1,
    violation 2, changed 1), for each iteration and for the initial
    violation count."""
    vp, rp = len(eargs[0]), len(eargs[2])
    n = vp - 1 + 2 * rp
    k16 = (4 * (2 * vp + 3 * rp) + 13 * n, 8 * n)
    _data_ok, _full_ok, it_a, it_b = (int(x) for x in verdict)
    rt = bool(sargs[7].max() >= 0)
    ops = (vp + rp) + (it_a + 1) * 3 * n
    planes = 3 * vp + 4 * rp
    if rt:
        ops += tp + (it_b + 1) * (3 * n + 6 * tp)
        planes += 2 * tp
    k17 = (4 * planes + 16, ops)
    return k16, k17


def elle_kernel_checks(timed, inputs):
    """K16 elle_edges and K17 elle_screen against their plain versions on
    the card at `inputs` (`elle_shapes`): all four edge arrays and all
    four screen words exact, the inputs untouched. Timed at the full width (K17 on
    the bench's data stage; the realtime stress shape beside it)."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch.checkers import elle_device as ed
    out, err, shapes = {}, 0, {}
    steps = {"timing_s": 0.0}
    for name, (eargs, sargs, tp, have_rt) in inputs.items():
        on = ed.to_device(sargs, "cuda")
        e_in = tuple(on[id(a)] for a in eargs)
        s_in = tuple(on[id(a)] for a in sargs)
        before = clone(s_in)

        def k16(e_in=e_in):
            return ed.elle_edges(*e_in)

        def k17(s_in=s_in, tp=tp, have_rt=have_rt):
            return ed.elle_screen(*s_in, n_txns_pad=tp, do_rt=have_rt)
        got = (k16(), k17())
        with K.forced_plain():
            ref = (k16(), k17())
        torch.cuda.synchronize()
        e = max(max_abs_err(got, ref), max_abs_err(s_in, before))
        check(e == 0, f"elle kernels@{name}: max abs err {e} (screen "
              f"{got[1].tolist()} vs {ref[1].tolist()})")
        err = max(err, e)
        verdict = got[1].tolist()
        shapes[name] = {"vp": len(eargs[0]), "rp": len(eargs[2]), "tp": tp,
                        "realtime": have_rt, "screen": verdict}
        if name.startswith("full"):
            (b16, o16), (b17, o17) = elle_io(eargs, sargs, tp, verdict)
            for kern, fn, by, ops in ((K.ELLE_EDGES, k16, b16, o16),
                                      (K.ELLE_SCREEN, k17, b17, o17)):
                if kern is K.ELLE_EDGES and name != "full":
                    continue
                b, bb = bound_of(by, ops)
                r = {"bound_ms": b, "bound_by": bb, "bytes": by,
                     "operations": ops, "screen": verdict}
                if timed:
                    t1 = time.perf_counter()
                    r["ms"] = cuda_ms(fn, iters=10)
                    with K.forced_plain():
                        r["plain_ms"] = cuda_ms(fn, iters=3, warmup=1)
                    steps["timing_s"] += time.perf_counter() - t1
                out[f"{kern.name}@{name}"] = r
    for r in out.values():
        r["max_abs_err"] = err
    v = shapes["full"]["screen"]
    check(v[0] == 1 and v[2] == 0, f"full width: the data stage did not "
          f"certify at once {shapes['full']}")
    return out, shapes, steps


def phase_elle_kernels(timed, inputs):
    t0 = time.perf_counter()
    r, shapes, steps = elle_kernel_checks(timed, inputs)
    emit({"phase": "elle_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0, **steps, "shapes": shapes,
          "kernels": r})
    return r


def phase_cli_txn(smi):
    """The transaction programs and lin-mutex through the kernels: the
    pinned runs, each with the launch counters set to 0 just before and
    read just after. Every history and Elle device block must equal the
    JAX runner's, every run be valid, and the device checker's runs
    launch K16 and K17 (one call each)."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_txn")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, run in CLI_TXN:
        sha, device = PINNED_TXN[name]
        K.reset_launches()
        runs[name] = _run_line(name, run, store, {name: sha})
        launches[name] = K.launch_counts()
        with open(os.path.join(store, "latest", "results.json")) as f:
            res = json.load(f)
        w = res["workload"]
        check(w.get("device") == device,
              f"txn {name}: device block {w.get('device')}, the JAX "
              f"runner's {device}")
        check(res["net"]["log-overflow"] == 0, f"txn {name}: log-overflow")
        want = TXN_KERNELS + (ELLE_KERNELS if device else ())
        for k in want:
            check(launches[name][k] > 0, f"txn {name} did not launch {k}")
        if device:
            check(res["net"].get("checker-device-calls") == 1
                  and launches[name]["elle_screen"] == 1,
                  f"txn {name}: device calls "
                  f"{res['net'].get('checker-device-calls')}")
        runs[name].update({"device": w.get("device"),
                           "checker_device_s": res["net"].get(
                               "checker-device-s"),
                           "ok_count": res["stats"]["ok-count"],
                           "reduced": CLI_TXN_REDUCED.get(name)})
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_txn", "runs": runs, "launches": launches,
          "nvidia_smi": smi})
    return {k: sum(v[k] for v in launches.values()) for k in ELLE_KERNELS}


def phase_bench_checkers(smi):
    """`python -m maelstrom_tpu_torch.bench --checkers` at its defaults
    (1,000,000 lin-kv rows; 1,000,000 Elle micro-ops), in this process:
    every verdict and edge set equal (the device block's through K16 and
    K17 against `_edges_vectorized`), the screen deciding at least 90% of
    its fixtures. The Elle set is built here, once; the kernels' inputs
    (`elle_shapes`, numpy) are made from it and returned for
    `phase_elle_kernels`, and the set is let go. While it lives, the
    garbage collector leaves what exists alone (`gc.freeze`): its
    passes over the set's some 3 million containers would slow every
    host phase behind it, the register baseline first."""
    import gc
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch.bench import (bench_checkers_record,
                                           elle_synthetic)
    t0 = time.perf_counter()
    synthetic = elle_synthetic(1_000_000)
    synthetic_s = time.perf_counter() - t0
    gc.freeze()
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        rec = bench_checkers_record(synthetic=synthetic)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        inputs = elle_shapes(synthetic)
        inputs_s = time.perf_counter() - t0
    finally:
        del synthetic
        gc.unfreeze()
    d = rec["elle"]["device"]
    check(rec["valid"] and d["match"] and rec["elle"]["match"]
          and d["screen_fixtures"]["decided_fraction"] >= 0.9,
          f"bench_checkers: {rec}")
    launches = {k: K.launch_counts()[k] for k in ELLE_KERNELS}
    emit({"phase": "bench_checkers", **rec, "wall_s": wall,
          "synthetic_s": synthetic_s, "elle_inputs_s": inputs_s,
          "build_s": d["build_s"], "screen_s": d["screen_s"],
          "speedup": d["speedup"], "launches": launches,
          "nvidia_smi": smi})
    return inputs


# --- the stream slice: continuous mode and the flight recorder ---------------

# The port's continuous runs (`--continuous`: client ops injected at their
# offered-rate rounds inside the scan window, kernel K18) through
# `core.run` (the CLI has no flag for the recovery window), at the JAX
# package's own configurations: its acceptance run, streaming kafka with
# two consumer groups under the whole five-package soup
# (tests/test_continuous.py `_kafka_stream`), lin-kv under the soup
# (`_run`) and echo at 300 ops/s, whose windows batch many ops a drain;
# the kafka and echo runs with the flight recorder on (`--telemetry`,
# kernel K19). The kafka and lin-kv runs cut from 3 s to 2 s
# (`CLI_STREAM_REDUCED`).
SOUP = {"kill", "pause", "partition", "duplicate", "weather"}
STREAM_BASE = {"node_count": 5, "continuous": True, "journal_rows": False,
               "recovery_s": 1.5}
CLI_STREAM = [
    ("kafka5-stream-soup", {
        **STREAM_BASE, "workload": "kafka", "node": "tpu:kafka",
        "kafka_groups": 2, "rate": 20.0, "time_limit": 2.0,
        "timeout_ms": 1000, "nemesis": SOUP, "nemesis_interval": 0.7,
        "seed": 7, "telemetry": "auto"}),
    ("linkv5-stream-soup", {
        **STREAM_BASE, "workload": "lin-kv", "node": "tpu:lin-kv",
        "rate": 10.0, "time_limit": 2.0, "timeout_ms": 1000,
        "nemesis": SOUP, "nemesis_interval": 0.7, "seed": 29}),
    ("echo-stream-300", {
        **STREAM_BASE, "workload": "echo", "node": "tpu:echo",
        "rate": 300.0, "time_limit": 1.0, "concurrency": 64,
        "latency": {"mean": 10, "dist": "constant"}, "timeout_ms": 5000,
        "seed": 3, "telemetry": "auto"}),
]
CLI_STREAM_REDUCED = {
    name: {"time_limit_s": 2.0, "from": 3.0, "rounds_executed_from": r,
           "why": WHY_SERVICES + ": the 0.7 s soup interval kept, every "
                  "package still starts and clients still invoke "
                  "inside fault windows"}
    for name, r in (("kafka5-stream-soup", 3680),
                    ("linkv5-stream-soup", 3540))}
# sha256 of the JAX runner's history.jsonl and of its results'
# `net.telemetry` block (json.dumps with sorted keys; None with the ring
# off), and its verdict, for each run above, on the CPU (JAX without its
# overlap pipeline); re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_continuous.py \
#       -m slow
PINNED_STREAM = {
    "kafka5-stream-soup": {
        "history":
            "0bd25ba3f6752e2ff9a7c4de6abd6496cdebf8614b49fc74324c5a9180df1007",
        "telemetry":
            "91de0a222a7f43d001f5554d738f448013d14d0ed8ccea90f940804c70cb73ca",
        "valid": True},
    "linkv5-stream-soup": {
        "history":
            "cfa2272a7db5765c1391ea6c2f3dfb067c374c44ad18c0c6753dd4fa71776111",
        "telemetry": None,
        # the JAX runner's verdict: linearizable, but no read of the run
        # succeeds, which fails its stats block
        "valid": False},
    "echo-stream-300": {
        "history":
            "08de9234f0e1b3d2e2b616683c39b9b05f4114ec38fb180edac89244d1962b90",
        "telemetry":
            "e1b0a7417f2a6f9ebff23ff658d967327f3ccf753321dadd6a84fe187e8e7c4d",
        "valid": True},
}
# The flight recorder on two runs the smoke already drives, the edge
# path's linkv5-faults and the pool path's echo5: their histories keep
# their pins (PINNED_LINKV, PINNED_POOL: the ring on and off give one
# history), and their `net.telemetry` blocks hash to the JAX runner's
# (same derivation)
TELEMETRY_ON = ("linkv5-faults", "echo5")
PINNED_TELEMETRY = {
    "linkv5-faults":
        "4ec1decb152a311882583b42c1dc12681e876ee7e7279ed5002070a654acad4e",
    "echo5": "666cd9aaf751345f29de4265620318f085b1c56f0560546958beb2e6362c85ad",
}


STREAM_KERNELS = ("sched_inject", "ring_update")
# K18 at the stream runs' widths (5 and 64 clients) and at concurrency
# 100,000; K19 at the stream runs' shapes and the 100,000-node CLI run's
# (`CLI_100K`: pool 800,000, 200,000 client rows, its edge planes)
SCHED_Q = (5, 64, 100_000)
RING_SHAPES = {"kafka5": dict(CLI_STREAM)["kafka5-stream-soup"],
               "echo-stream": dict(CLI_STREAM)["echo-stream-300"],
               "cli100k": CLI_100K}


def _stream_runner(opts):
    """A runner (program, NetConfig, SimState with the ring) of `opts` on
    the card: the shapes the stream kernels see on that run's path."""
    from maelstrom_tpu_torch import core
    from maelstrom_tpu_torch.runner.tpu_runner import TpuRunner
    return TpuRunner(core.build_test({**opts, "device": "cuda",
                                      "telemetry": "auto"}))


def _ring_inputs(g, runner, p_valid):
    """Random inputs of one ring fold at a runner's shapes: the ring, the
    round-entry and -exit counters (some past 2^31 - 1 after the round),
    the pool and channel planes, the send planes, the inject and reply
    rows. Returns (ring_update's args, bytes read and written, the
    operations: about two a row)."""
    import torch
    from types import SimpleNamespace
    from maelstrom_tpu_torch import telemetry as TM
    from maelstrom_tpu_torch.net import tpu as T
    cfg, prog, sim = runner.cfg, runner.program, runner.sim
    N, C = cfg.n_nodes, max(cfg.n_clients, 1)

    def rb(shape, p):
        return torch.rand(shape, generator=g, device="cuda") < p

    def ri(lo, hi, shape=()):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)
    ring = TM.make_ring(cfg, "cuda")
    ring = ring.replace(**{f: ri(0, 1000, tuple(getattr(ring, f).shape))
                           for f in TM.MetricRing.__dataclass_fields__
                           if f != "req_round"})
    ring = ring.replace(lat_sum=torch.tensor(2**31 - 100, dtype=torch.int32,
                                             device="cuda"),
                        req_round=torch.where(rb((C,), 0.3), -1,
                                              ri(0, 5000, (C,))))
    stats = ("sent_all", "recv_all", "lost", "dropped_partition",
             "dropped_down", "dropped_overflow", "duplicated")
    st0 = T.NetStats.zeros("cuda").replace(
        **{f: ri(2**31 - 2000, 2**31 - 1) for f in stats})
    st1 = st0.replace(**{f: getattr(st0, f) + ri(0, 4000) for f in stats})
    net = SimpleNamespace(stats=st1, pool=SimpleNamespace(
        valid=rb((cfg.pool_cap,), p_valid)))
    if sim.channels is not None:
        Kc = prog.inbox_cap
        chan = rb(tuple(sim.channels.valid.shape), p_valid)
        planes = (rb((N, prog.D * prog.lanes), p_valid),
                  rb((N, Kc), p_valid / 4))
        RP = N * Kc
    else:
        chan = None
        planes = (rb((N, prog.outbox_cap), p_valid),)
        RP = cfg.client_cap
    reply = T.Msgs.empty(RP, "cuda").replace(valid=rb((RP,), p_valid),
                                             dest=ri(0, N + C + 2, (RP,)))
    inject = T.Msgs.empty(C, "cuda").replace(valid=rb((C,), p_valid),
                                             src=ri(0, N + C + 2, (C,)))
    rnd = torch.tensor(5000, dtype=torch.int32, device="cuda")
    args = (cfg, ring, st0, net, chan, rnd, planes, inject, reply)
    rows = (cfg.pool_cap + (0 if chan is None else chan.numel())
            + sum(p.numel() for p in planes) + RP + C)
    io = (rows + 4 * RP + 4 * C + 2 * nbytes(*[getattr(ring, f) for f in
                                              TM.MetricRing.__dataclass_fields__])
          + 8 * len(stats) + 4)
    return args, io, 2 * rows + 8 * C


def stream_kernel_checks(timed):
    """K18 sched_inject and K19 ring_update against their plain versions
    on the card (exact: int32 and bool), at the shapes above; K18 in its
    per-round form and the window's last fold, K19 with its planes 5%
    and 50% full. Timed at 5%."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch import telemetry as TM
    from maelstrom_tpu_torch.net import tpu as T
    from maelstrom_tpu_torch.sim import sched_select, sched_select_plain
    g = torch.Generator(device="cuda")
    g.manual_seed(19)
    out = {}
    for Q in SCHED_Q:
        valid = torch.rand(Q, generator=g, device="cuda") < 0.8
        at = torch.randint(-1, 300, (Q,), generator=g, device="cuda",
                           dtype=torch.int32)
        im = torch.randint(-1, 1 << 30, (Q,), generator=g, device="cuda",
                           dtype=torch.int32)
        sent = T.Msgs.empty(Q, "cuda").replace(
            valid=torch.rand(Q, generator=g, device="cuda") < 0.5,
            mid=torch.randint(0, 1 << 30, (Q,), generator=g, device="cuda",
                              dtype=torch.int32))
        err = 0
        for args in ((valid, at, im, sent, 7), (valid, at, None, None, 0),
                     (valid, at, im, sent, None)):
            got = sched_select(*args)
            ref = sched_select_plain(*args)
            torch.cuda.synchronize()
            check((got[0] is None) == (ref[0] is None),
                  "sched_inject: the select's form differs")
            err = max(err, max_abs_err(got[1], ref[1]), 0 if got[0] is None
                      else max_abs_err(got[0], ref[0]))
        check(err == 0, f"sched_inject at Q={Q} differs from its plain "
              f"version (max abs err {err})")
        io = 14 * Q + 5 * Q
        b, by = bound_of(io, 3 * Q)
        r = {"max_abs_err": err, "bound_ms": b, "bound_by": by, "bytes": io,
             "rows": Q}
        if timed:
            def step(valid=valid, at=at, im=im, sent=sent):
                return sched_select(valid, at, im, sent, 7)
            r["ms"] = cuda_ms(step)
            r["plain_ms"] = cuda_ms(lambda: sched_select_plain(
                valid, at, im, sent, 7))
        out[f"{K.SCHED_INJECT.name}@{Q}"] = r
    for shape, opts in RING_SHAPES.items():
        runner = _stream_runner(opts)
        err = 0
        for p_valid in (0.5, 0.05):
            args, io, ops = _ring_inputs(g, runner, p_valid)
            got = TM.ring_update(*args)
            ref = TM.ring_update_plain(*args)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, ref))
        check(err == 0, f"ring_update at {shape} differs from its plain "
              f"version (max abs err {err})")
        b, by = bound_of(io, ops)
        r = {"max_abs_err": err, "bound_ms": b, "bound_by": by, "bytes": io,
             "nodes": runner.cfg.n_nodes, "clients": runner.cfg.n_clients,
             "pool": runner.cfg.pool_cap, "p_valid_timed": p_valid}
        if timed:
            r["ms"] = cuda_ms(lambda args=args: TM.ring_update(*args))
            r["plain_ms"] = cuda_ms(
                lambda args=args: TM.ring_update_plain(*args))
        out[f"{K.RING_UPDATE.name}@{shape}"] = r
        del runner
    return out


def phase_stream_kernels(timed):
    t0 = time.perf_counter()
    r = stream_kernel_checks(timed)
    emit({"phase": "stream_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


def _telemetry_checks(name, d, res, pin):
    """A run with the ring on: the ring counts what NetStats counts, a
    pool-occupancy sample every executed round, the stream's records
    valid with their final quantiles equal to the PerfChecker's, the
    three span names in trace.json, and the ring equal to the JAX
    runner's (sha256 of the sorted JSON). Returns the ring."""
    import hashlib
    from maelstrom_tpu_torch import telemetry as TM
    ring, net = res["net"].get("telemetry"), res["net"]
    check(ring is not None, f"{name}: no net.telemetry block")
    check(ring["sent"] == net["all"]["send-count"]
          and ring["delivered"] == net["all"]["recv-count"]
          and ring["dropped"] == (net["lost"] + net["dropped-partition"]
                                  + net["dropped-down"]
                                  + net["dropped-overflow"])
          and ring["duplicated"] == net["duplicated"],
          f"{name}: the ring {ring} disagrees with NetStats")
    check(ring["rounds"] > 0
          and sum(ring["pool-occupancy-hist"]) == ring["rounds"],
          f"{name}: pool occupancy samples {ring['pool-occupancy-hist']} "
          f"for {ring['rounds']} rounds")
    recs = TM.read_records(os.path.join(d, "telemetry"))
    bad = [p for r in recs for p in TM.validate_record(r)]
    check(recs and not bad, f"{name}: telemetry.jsonl {bad[:3]}")
    final = [r for r in recs if r["type"] == "final"][-1]
    perf = {k: v for k, v in res["perf"]["latency-ms"].items()
            if k != "by-f"}
    check(final["lat_ms"] == perf and final["ring"] == ring,
          f"{name}: final record {final['lat_ms']} vs perf {perf}")
    with open(os.path.join(d, "telemetry", "trace.json")) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]}
    check({"schedule-encode", "dispatch", "device-get"} <= spans,
          f"{name}: spans {sorted(spans)}")
    digest = hashlib.sha256(json.dumps(ring, sort_keys=True).encode()
                            ).hexdigest()
    check(digest == pin, f"{name}: net.telemetry sha256 {digest}, the JAX "
          f"runner's {pin}")
    return ring


def phase_cli_stream(smi):
    """The continuous runs through the kernels, launch counters set to 0
    just before each and read just after: each history and ring must hash
    to the JAX runner's, K18 launch on every run and K19 on the runs with
    the ring on; lin-kv must see client ops invoked inside a fault
    window, and echo's windows must batch (drains < ops / 2)."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_stream")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, opts in CLI_STREAM:
        K.reset_launches()
        rc, d, res, tm, digest, wall = _core_run(opts, store)
        launches[name] = K.launch_counts()
        pin = PINNED_STREAM[name]
        check(digest == pin["history"], f"stream {name}: history.jsonl "
              f"sha256 {digest}, the JAX runner's {pin['history']}")
        # the JAX runner's verdict (lin-kv's stats block fails there too:
        # no read of the soup run succeeds)
        check(res["valid"] == pin["valid"]
              and res["workload"]["valid"] is True
              and res["net"]["valid"] is True
              and res["net"]["dropped-overflow"] == 0,
              f"stream {name}: valid {res['valid']}, workload "
              f"{res['workload'].get('valid')}, net {res['net']['valid']}")
        check(tm["drains"] < tm["final-round"] / 4,
              f"stream {name}: {tm['drains']} drains for "
              f"{tm['final-round']} rounds")
        check(launches[name]["sched_inject"] > 0,
              f"stream {name} did not launch sched_inject")
        rec = {"wall_s": wall, "final_round": tm["final-round"],
               "rounds_executed": tm["rounds-executed"],
               "ms_per_executed_round": 1e3 * tm["scan-s"]
               / max(tm["rounds-executed"], 1),
               "dispatches": tm["dispatches"], "drains": tm["drains"],
               "history_ops": tm["history-ops"],
               "ops": res["stats"]["count"], "valid": res["valid"],
               "history_sha256_equal": True,
               "reduced": CLI_STREAM_REDUCED.get(name)}
        if opts.get("telemetry"):
            check(launches[name]["ring_update"] > 0,
                  f"stream {name} did not launch ring_update")
            ring = _telemetry_checks(name, d, res, pin["telemetry"])
            rec["ring"] = {k: ring[k] for k in
                           ("rounds", "sent", "dropped", "latency-count",
                            "pool-occupancy-max")}
            rec["telemetry_sha256_equal"] = True
        if opts.get("nemesis"):
            with open(os.path.join(d, "history.jsonl")) as f:
                ops = [json.loads(line) for line in f]
            fs = {o["f"] for o in ops if o.get("process") == "nemesis"
                  and o["type"] == "info"}
            starts = sorted(o["time"] for o in ops if o["type"] == "info"
                            and str(o.get("f")).startswith("start-"))
            stops = sorted(o["time"] for o in ops if o["type"] == "info"
                           and str(o.get("f")).startswith("stop-"))
            inside = [o for o in ops if o["type"] == "invoke"
                      and o.get("process") != "nemesis"
                      and any(a < o["time"] < b
                              for a, b in zip(starts, stops))]
            check({f"start-{p}" for p in SOUP} <= fs and inside,
                  f"stream {name}: nemesis ops {sorted(fs)}, "
                  f"{len(inside)} invokes inside a fault window")
            rec["invokes_mid_fault"] = len(inside)
        if name == "echo-stream-300":
            check(rec["ops"] > 100 and tm["drains"] < rec["ops"] / 2,
                  f"stream {name}: {tm['drains']} drains for "
                  f"{rec['ops']} ops")
        runs[name] = rec
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_stream", "runs": runs, "launches": launches,
          "nvidia_smi": smi})
    return {k: sum(v[k] for v in launches.values()) for k in STREAM_KERNELS}


# --- the role-partition slice: the in-cluster services (K20-K22) -----------

# The lin-tso workload on the role-partitioned services cluster (`--node
# tpu:services`) through `core.run` (the CLI has no flag for recovery_s):
# the JAX package's e2e run (tests/test_services_roles.py), the same
# under role-targeted kills (the lww-kv replicas), pauses (the lin-tso
# node) and partitions with the flight recorder on (a 1 s client
# timeout: at the 5 s default stragglers wait out the paused oracle and
# the run reaches round 6,820), and 1,022 lww-kv replicas at 200 ops/s
# (K22 at 1,022 replicas every round). Nothing is cut.
SERVICES_BASE = {"workload": "lin-tso", "node": "tpu:services", "seed": 7,
                 "rate": 20.0, "time_limit": 2.0}
CLI_SERVICES = [
    ("tso5", dict(SERVICES_BASE)),
    ("tso5-targeted", {
        **SERVICES_BASE, "nemesis": {"kill", "pause", "partition"},
        "nemesis_targets": "kill=lww-kv,pause=lin-tso",
        "nemesis_interval": 0.5, "recovery_s": 0.5, "timeout_ms": 1000,
        "telemetry": "auto"}),
    ("tso1024", {**SERVICES_BASE, "rate": 200.0, "time_limit": 1.0,
                 "service_roles": "lin-tso=1,seq-kv=1,lww-kv=1022"}),
]
# sha256 of the JAX runner's history.jsonl and of its results'
# `net.telemetry` block (json.dumps with sorted keys; None with the ring
# off) for each run above, on the CPU (JAX without its overlap
# pipeline); re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_services.py -m slow
PINNED_SERVICES = {
    "tso5": {
        "history":
            "9ff3baebd63d57cb291c99f240472303c0d2f293b58545ad5651629f0626d49a",
        "telemetry": None},
    "tso5-targeted": {
        "history":
            "0ba2d771350a2e42d5b75c702ba9a49749a94ad41e919ee7397f5742dbe02aff",
        "telemetry":
            "0ee53475cf2200d3699244429934ccfbc67d045528e722e9b4b2f40dec169ddb"},
    "tso1024": {
        "history":
            "c899bdf76de3a0161b0993ff2022fb83ce79d1fa06b82c08b081033d7953276a",
        "telemetry": None},
}
# The partition's bit-identity on the card: pinned runs of earlier slices
# again with their program wrapped as a one-role partition (`--node
# tpu:solo:<program>`), each held to its existing pin: the edge path
# under the combined nemesis (the shortest such pin, grid5-storm) and
# the pool path (echo5)
SOLO_RUNS = (("grid5-storm", "broadcast_step_stall"),
             ("echo5", "echo_step"))
SERVICES_KERNELS = ("tso_step", "seq_kv_step", "lww_kv_step")
# (role, replicas, inbox lanes) at the CLI's shapes (the oracle and the
# single-copy KV one node each; lww-kv at tso5's 3 replicas and tso1024's
# 1,022) and a replicated store the card holds, 100,000 replicas x 256
# keys (some 230 MB of kv, vts and dirty rows)
SERVICES_SHAPES = {"tso_step@cli": ("lin-tso", 1),
                   "seq_kv_step@cli": ("seq-kv", 1),
                   "lww_kv_step@cli3": ("lww-kv", 3),
                   "lww_kv_step@cli1022": ("lww-kv", 1022),
                   "lww_kv_step@100k": ("lww-kv", 100_000)}


def _random_services(g, n, K_, keys, G):
    """Random inputs of a service role step on the card: every lane type,
    keys repeated and past both ends, cas words that hit and miss,
    merges older and newer than the stored stamp, INT32_MAX words (b + 1
    wraps), wrapping clocks and timestamps, dirty sets below, at and
    above G keys a replica. Returns (inbox Msgs, state dict)."""
    import torch
    from maelstrom_tpu_torch.net.tpu import Msgs

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    def rb(shape, p):
        return torch.rand(shape, generator=g, device="cuda") < p
    shape = (n, K_)
    types = torch.tensor([10, 12, 14, 45, 40, 0, 11, 41], dtype=torch.int32,
                         device="cuda")
    a = torch.where(rb(shape, 0.05), keys + 3, ri(-2, 6, shape))
    b, c = (torch.where(rb(shape, 0.04), 2**31 - 1, ri(-2, 9, shape))
            for _ in range(2))
    inbox = Msgs(valid=rb(shape, 0.8), src=ri(0, n + 8, shape),
                 dest=ri(0, n, shape), due=ri(0, 50, shape),
                 mid=ri(0, 1000, shape), reply_to=ri(-1, 1000, shape),
                 type=types[ri(0, len(types), shape).long()], a=a, b=b, c=c)
    dens = torch.tensor([0.0, 0.01, G / keys, 0.3], device="cuda")[
        ri(0, 4, (n, 1)).long()]
    dirty = torch.rand((n, keys), generator=g, device="cuda") < dens
    dirty[0] = False
    dirty[0, :G] = True
    clock = ri(0, 12, (n,))
    clock[n // 2] = 2**31 - 1
    ts = ri(0, 100, (n,))
    ts[0] = 2**31 - 3
    return inbox, {"kv": ri(0, 9, (n, keys)), "vts": ri(-1, 12, (n, keys)),
                   "clock": clock, "dirty": dirty, "ts": ts}


def services_kernel_checks(timed):
    """K20 tso_step, K21 seq_kv_step and K22 lww_kv_step, with and
    without the stall mask, against their plain versions on the same
    inputs on the card (exact: int32 and bool) at `SERVICES_SHAPES`, the
    inputs unchanged after the launch; timed without the mask."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch.nodes import services as S
    g = torch.Generator(device="cuda")
    g.manual_seed(20)
    keys, G, K_ = 256, 8, 8
    state_keys = {"lin-tso": ("ts",), "seq-kv": ("kv",),
                  "lww-kv": ("kv", "vts", "clock", "dirty")}
    out = {}
    for name, (role, n) in SERVICES_SHAPES.items():
        nodes = [f"n{i}" for i in range(n)]
        opts = {"kv_keys": keys, "gossip_keys": G}
        prog = {"lin-tso": S.TSORole, "seq-kv": S.SeqKVRole}.get(
            role, lambda o, nd: S.LWWKVRole(o, nd, base=2))(opts, nodes)
        inbox, full = _random_services(g, n, K_, keys, G)
        state = {k: full[k] for k in state_keys[role]}
        before = clone(state), clone(inbox)
        stall = torch.rand(n, generator=g, device="cuda") < 0.3
        err = 0
        for ctx in ({}, {"stall": stall}):
            def step(ctx=ctx):
                return prog.step(state, inbox, ctx)
            got = step()
            with K.forced_plain():
                ref = step()
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, ref))
        check(max_abs_err(before, (state, inbox)) == 0,
              f"{name}: the kernel updated an input")
        check(err == 0, f"{name} differs from its plain version (max abs "
              f"err {err})")
        L = prog.outbox_cap if role == "lww-kv" and n > 1 else K_
        # read: valid and type (K20) or valid, type, src, mid, a, b, c;
        # written: valid, type, a, b, c (K20) or every outbox field; the
        # state rows read and written
        lane_in, lane_out = (5, 17) if role == "lin-tso" else (25, 37)
        st_bytes = 2 * nbytes(*state.values())
        io = n * K_ * lane_in + n * L * lane_out + st_bytes + n
        # a few dozen int32 operations a lane, a dozen a key of the
        # gossip's prefix count
        ops = n * K_ * 30 + (n * keys * 12 if L > K_ else 0)
        b, by = bound_of(io, ops)
        r = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
             "bytes": io, "replicas": n, "lanes": L, "keys": keys}
        if timed:
            def timed_step():
                return prog.step(state, inbox, {})
            r["ms"] = cuda_ms(timed_step)
            with K.forced_plain():
                r["plain_ms"] = cuda_ms(timed_step)
        out[name] = r
        del prog, inbox, full, state, before
    return out


def phase_services_kernels(timed):
    t0 = time.perf_counter()
    r = services_kernel_checks(timed)
    emit({"phase": "services_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


def phase_cli_services(smi):
    """The lin-tso runs through the kernels, launch counters set to 0
    just before each and read just after: each history (and ring) must
    hash to the JAX runner's, every run valid and monotonic with no
    duplicate timestamp, K20-K22 launched every executed round; the
    targeted run's kills on lww-kv nodes only and its pauses on n0
    only. Then the one-role partition on two pinned runs of earlier
    slices, held to their existing pins."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_services")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, opts in CLI_SERVICES:
        K.reset_launches()
        rc, d, res, tm, digest, wall = _core_run(opts, store)
        launches[name] = K.launch_counts()
        pin = PINNED_SERVICES[name]
        check(rc == 0 and res["valid"] is True
              and res["net"]["dropped-overflow"] == 0,
              f"services {name}: exit {rc}, valid {res.get('valid')}, "
              f"overflow {res['net']['dropped-overflow']}")
        # host reads scale with the run's ops (tso1024 dispatches at each
        # of its 200 ops a second), not its rounds
        check(tm["drains"] < max(tm["final-round"] / 4,
                                 2 * tm["history-ops"]),
              f"services {name}: {tm['drains']} host drains for "
              f"{tm['final-round']} rounds and {tm['history-ops']} ops")
        w = res["workload"]
        check(w["valid"] is True and w["monotonic"] is True
              and "duplicate-ts" not in w,
              f"services {name}: workload {w}")
        check(digest == pin["history"], f"services {name}: history.jsonl "
              f"sha256 {digest}, the JAX runner's {pin['history']}")
        n_launch = [launches[name][k] for k in SERVICES_KERNELS]
        check(min(n_launch) >= tm["rounds-executed"] > 0
              and len(set(n_launch)) == 1,
              f"services {name}: launches {n_launch} for "
              f"{tm['rounds-executed']} executed rounds")
        rec = {"wall_s": wall, "final_round": tm["final-round"],
               "rounds_executed": tm["rounds-executed"],
               "ms_per_executed_round": 1e3 * tm["scan-s"]
               / max(tm["rounds-executed"], 1),
               "dispatches": tm["dispatches"], "drains": tm["drains"],
               "history_ops": tm["history-ops"],
               "granted": w["granted-count"],
               "history_sha256_equal": True}
        if name == "tso5":
            check(w["granted-count"] > 10,
                  f"services {name}: {w['granted-count']} granted")
        if opts.get("telemetry"):
            ring = _telemetry_checks(name, d, res, pin["telemetry"])
            check(set(ring["role-sent"]) == {"lin-tso", "seq-kv", "lww-kv"},
                  f"services {name}: role-sent {ring['role-sent']}")
            rec["role_sent"] = ring["role-sent"]
            rec["telemetry_sha256_equal"] = True
        if opts.get("nemesis_targets"):
            with open(os.path.join(d, "history.jsonl")) as f:
                vals = [o["value"] for o in map(json.loads, f)
                        if o.get("process") == "nemesis"
                        and o["type"] == "info"]
            killed = [v for v in vals if v.startswith("killed")]
            paused = [v for v in vals if v.startswith("paused")]
            check(killed and paused
                  and all("'n0'" not in v and "'n1'" not in v
                          for v in killed)
                  and all(v == "paused ['n0']" for v in paused),
                  f"services {name}: kills {killed}, pauses {paused}")
            rec["nemesis"] = {"killed": killed, "paused": paused}
        runs[name] = rec
    pins = {**PINNED_FAULTS, **PINNED_POOL}
    args_of = dict(CLI_FAULTS_SMALL + CLI_POOL)
    for name, kernel in SOLO_RUNS:
        args = list(args_of[name])
        i = args.index("--node") + 1
        args[i] = "tpu:solo:" + args[i][len("tpu:"):]
        K.reset_launches()
        rc, _d, res, tm, digest, wall = _cli_run(args, store)
        counts = K.launch_counts()
        _cli_checks(f"solo {name}", rc, res, tm)
        check(digest == pins[name], f"solo {name}: history.jsonl sha256 "
              f"{digest}, the unwrapped run's pin {pins[name]}")
        check(counts[kernel] > 0, f"solo {name} did not launch {kernel}")
        runs[f"solo:{name}"] = {
            "wall_s": wall, "rounds_executed": tm["rounds-executed"],
            "history_sha256_equal": True, kernel: counts[kernel]}
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_services", "runs": runs, "launches": {
        k: {kk: v[kk] for kk in SERVICES_KERNELS}
        for k, v in launches.items()}, "nvidia_smi": smi})
    return {k: sum(v[k] for v in launches.values())
            for k in SERVICES_KERNELS}


# --- the compartment slice: one sequencer (K23-K26) --------------------------

# The JAX package's compartment runs (tests/test_compartment.py): the
# default roles (one sequencer, 2 proxies, a 2x2 grid, 2 replicas) at
# seed 7, rate 20, 2 s; the role-targeted soup (kills on the proxies, a
# partition cutting acceptor column 0 off, every 0.7 s for 3 s, 2 s of
# recovery) with the ring on; the leader's backpressure shed (2 leader
# and 2 proxy slots, 16 clients at rate 200 for 1 s); and kafka over the
# compartment engine at the ordering axis's base options. Nothing is cut.
COMP_BASE = {"workload": "lin-kv", "node": "tpu:compartment", "seed": 7,
             "rate": 20.0, "time_limit": 2.0, "journal_rows": False}
CLI_COMPARTMENT = [
    ("comp9", dict(COMP_BASE)),
    ("comp9-targeted", {
        **COMP_BASE, "seed": 11, "time_limit": 3.0,
        "nemesis": {"kill", "partition"}, "nemesis_interval": 0.7,
        "nemesis_targets": "kill=proxies,partition=acceptor-col-0",
        "recovery_s": 2.0, "telemetry": "auto"}),
    ("comp9-shed", {**COMP_BASE, "rate": 200.0, "time_limit": 1.0,
                    "leader_slots": 2, "proxy_slots": 2,
                    "concurrency": 16}),
    ("kafka-ordered-comp", {**ORDERED_BASE, "workload": "kafka",
                            "ordering": "compartment"}),
]
# sha256 of the JAX runner's history.jsonl and of its results'
# `net.telemetry` block (json.dumps with sorted keys; None with the ring
# off) for each run above, on the CPU (JAX without its overlap
# pipeline); re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_compartment.py -m slow
PINNED_COMPARTMENT = {
    "comp9": {
        "history":
            "8db3af6bbfb88f49ba990362e405a204434b02b1fe94c3be5463594c01383e67",
        "telemetry": None},
    "comp9-targeted": {
        "history":
            "4c9ccf09f28f5bb1fca63cfa910d512ddd7435804fd0a2180414d7b471452bf0",
        "telemetry":
            "10c47d48f6c9904f83d75b419120859d5b984bfad0a0efd8319c3857597aefe1"},
    "comp9-shed": {
        "history":
            "3de5cded866056f9bbe0fdfce88ecdb914ecb83cbafc6678616d1181f616f0b4",
        "telemetry": None},
    "kafka-ordered-comp": {
        "history":
            "abf17fc1415941f39111a8aa352508a96134f1025d0c52d481d4370c51a0ac91",
        "telemetry": None},
}
# bench.py's compartment sweep at full width (P = 1, 2, 4, 8 proxies,
# rate 8,000, 2 s, 96 clients, seed 11): the JAX runner's ok ops at each
# point on the CPU, re-derived by the same command
PINNED_COMPARTMENT_BENCH = {1: 1671, 2: 3362, 4: 7049, 8: 11635}


COMPARTMENT_KERNELS = ("compartment_sequencer_step", "compartment_proxy_step",
                       "compartment_acceptor_step", "compartment_replica_step")
# (roles, layout options, role, role nodes) of each K23-K26 check: the CLI
# runs' shapes (comp9: QL 32, K 8, QP 8, a 336-slot log, 256 keys), the
# bench's (QL 128, K 16, 8 proxies, a 32,256-slot log, 1,024 keys: the
# slice's path at full width, the kernels line's shape) and a stress
# shape the card holds: 4,096 sequencer and proxy tables, 4,096
# acceptors x 32,256 slots (660 MB of planes) and 1,024 replicas x
# 32,256 slots x 1,024 keys (433 MB).
_BENCH_LAY = {"leader_slots": 128, "proxy_slots": 8,
              "compartment_inbox": 16, "kv_keys": 1024,
              "concurrency": 96, "rate": 8000.0, "time_limit": 2.0}
_CLI_LAY = {"rate": 20.0, "time_limit": 2.0}
_R9 = "proxies=2,acceptors=2x2,replicas=2"
_R8 = "proxies=8,acceptors=2x2,replicas=2"
COMPARTMENT_SHAPES = {
    "compartment_sequencer_step@cli": (_R9, _CLI_LAY, "sequencers", 1),
    "compartment_proxy_step@cli": (_R9, _CLI_LAY, "proxies", 2),
    "compartment_acceptor_step@cli": (_R9, _CLI_LAY, "acceptors", 4),
    "compartment_replica_step@cli": (_R9, _CLI_LAY, "replicas", 2),
    "compartment_sequencer_step@bench": (_R8, _BENCH_LAY, "sequencers", 1),
    "compartment_proxy_step@bench": (_R8, _BENCH_LAY, "proxies", 8),
    "compartment_acceptor_step@bench": (_R8, _BENCH_LAY, "acceptors", 4),
    "compartment_replica_step@bench": (_R8, _BENCH_LAY, "replicas", 2),
    "compartment_sequencer_step@stress": (_R8, _BENCH_LAY, "sequencers",
                                          4096),
    "compartment_proxy_step@stress": (_R8, _BENCH_LAY, "proxies", 4096),
    "compartment_acceptor_step@stress": (_R8, _BENCH_LAY, "acceptors",
                                         4096),
    "compartment_replica_step@stress": (_R8, _BENCH_LAY, "replicas", 1024),
}


def _compartment_role(roles, opts, role, n, byz=False):
    """The role program of a `--roles` layout over n nodes, on the card
    (with `byz`, under the byzantine adversary)."""
    from maelstrom_tpu_torch.nodes import compartment as C
    lay = C.Layout({"roles": roles, **opts}, C.roles_node_count(roles))
    cls = {"sequencers": C.SequencerRole, "proxies": C.ProxyRole,
           "acceptors": C.GridAcceptors, "replicas": C.ReplicaRole}[role]
    return lay, cls({"nemesis": {"byzantine"}} if byz else {},
                    [f"n{i}" for i in range(n)], lay)


def _random_compartment(g, role, lay, n, rnd):
    """Random inputs of a compartment role step, drawn on the card (as
    `testing.compartment.random_compartment_inputs` draws them with
    numpy, which the stress shape's 660 MB of planes would make slow on
    the host): every lane type the
    role reads and some it does not, slots repeated, matching live rows
    and past the log, grid and replica indices past both ends, INT32_MAX
    words, client ids below and above the cluster, tables empty, partly
    full and full, rows due and not due, ack sets a row short of a
    quorum and whole, stored runs past the apply frontier, commands of
    every op with keys past the row. Returns (inbox Msgs, state)."""
    import torch
    from maelstrom_tpu_torch.net.tpu import Msgs
    K_, C = lay.K, lay.cap
    Q = {"sequencers": lay.QL, "proxies": lay.QP}.get(role, 1)
    shape = (n, K_)

    def ri(lo, hi, shp):
        return torch.randint(lo, hi, shp, generator=g, device="cuda",
                             dtype=torch.int32)

    def rf(shp):
        return torch.rand(shp, generator=g, device="cuda")

    def dens(shp):
        d = torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0], device="cuda")[
            ri(0, 5, (shp[0], 1)).long()]
        return rf(shp) < d

    def pick_lane(rows):
        return torch.gather(rows, 1, ri(0, rows.shape[1], shape).long())
    last = rnd - ri(0, 2 * lay.retry, (n, Q))
    last = torch.where(rf((n, Q)) < 0.2, -(1 << 20), last)
    b, c = (torch.where(rf(shape) < 0.04, 2**31 - 1, ri(-2, 9, shape))
            for _ in range(2))
    inbox = dict(valid=rf(shape) < 0.85, src=ri(0, lay.n_nodes + 40, shape),
                 dest=ri(0, n, shape), due=ri(0, 50, shape),
                 mid=ri(0, 1000, shape), reply_to=ri(-1, 1000, shape),
                 b=b, c=c)

    def types(codes):
        t = torch.tensor(codes, dtype=torch.int32, device="cuda")
        return t[ri(0, len(codes), shape).long()]
    if role == "sequencers":
        slots = ri(0, C + 4, (n, Q))
        inbox["type"] = types([10, 12, 14, 35, 35, 30, 0, 31])
        a = torch.where(rf(shape) < 0.05, lay.keys + 3, ri(-2, 8, shape))
        done = torch.where(rf(shape) < 0.5, pick_lane(slots),
                           ri(0, C + 4, shape))
        inbox["a"] = torch.where(inbox["type"] == 35, done, a)
        nxt = torch.where(rf(n) < 0.3, C - ri(0, 3, (n,)), ri(0, C + 1, (n,)))
        state = {"next_slot": nxt, "t_valid": dens((n, Q)),
                 "t_slot": slots, "t_cmd": ri(0, 1 << 30, (n, Q)),
                 "t_client": ri(0, 0x8000, (n, Q)),
                 "t_mid": ri(-1, 1000, (n, Q)), "t_last": last}
    elif role == "proxies":
        slots = ri(0, C + 4, (n, Q))
        inbox["type"] = types([32, 32, 34, 34, 30, 30, 0, 35])
        slot_in = torch.where(rf(shape) < 0.6, pick_lane(slots),
                              ri(0, C + 4, shape)) & 0x7FFF
        inbox["a"] = torch.where(inbox["type"] == 30,
                                 (ri(0, 0x8000, shape) << 16) | slot_in,
                                 slot_in)
        ackish = (inbox["type"] == 32) | (inbox["type"] == 34)
        inbox["b"] = torch.where(ackish, ri(-1, lay.AR + 2, shape),
                                 inbox["b"])
        pa = torch.tensor([0.0, 0.5, 0.8, 1.0], device="cuda")[
            ri(0, 4, (n, Q, 1)).long()]
        state = {"p_valid": dens((n, Q)), "p_learn": rf((n, Q)) < 0.4,
                 "p_slot": slots, "p_cmd": ri(0, 1 << 30, (n, Q)),
                 "p_client": ri(0, 0x8000, (n, Q)),
                 "p_mid": ri(-1, 1000, (n, Q)), "p_last": last,
                 "p_acks": rf((n, Q, lay.AR)) < pa}
    elif role == "acceptors":
        inbox["type"] = types([31, 31, 31, 32, 0, 33])
        a = ri(-2, C + 3, shape)
        inbox["a"] = torch.where(rf(shape) < 0.3, a[:, :1], a)
        state = {"acc_cmd": ri(0, 1 << 30, (n, C)),
                 "acc_has": rf((n, C)) < 0.3}
    else:
        applied = torch.where(rf(n) < 0.2, C - 1 - ri(0, 3, (n,)),
                              ri(-1, C, (n,)))
        applied[0] = -1
        slot_in = applied[:, None] + ri(-2, lay.AP + 3, shape)
        slot_in = torch.where(rf(shape) < 0.1, C + ri(0, 3, shape),
                              slot_in) & 0x7FFF
        slot_in = torch.where(rf(shape) < 0.2, slot_in[:, :1], slot_in)
        inbox["type"] = types([33, 33, 33, 34, 0, 31])
        inbox["a"] = (ri(0, 0x8000, shape) << 16) | slot_in
        key = torch.where(rf((n, C)) < 0.02, min(lay.keys + 1, 4095),
                          ri(0, lay.keys, (n, C)))
        cmd = ((key << 18) | (ri(0, 4, (n, C)) << 16)
               | (ri(0, 10, (n, C)) << 8) | ri(0, 10, (n, C)))
        inbox["b"] = torch.where(inbox["type"] == 33,
                                 torch.gather(cmd, 1,
                                              ri(0, C, shape).long()),
                                 inbox["b"])
        # runs of stored slots past the apply frontier
        ar = torch.arange(C, device="cuda")[None, :]
        run = ri(0, 2 * lay.AP, (n, 1))
        lo = (applied[:, None] + 1).clamp(min=0)
        has = (rf((n, C)) < 0.3) | ((ar >= lo) & (ar < lo + run))
        state = {"r_cmd": cmd, "r_client": ri(0, 0x8000, (n, C)),
                 "r_mid": ri(-2, 1000, (n, C)), "r_has": has,
                 "applied": applied, "kv": ri(0, 10, (n, lay.keys))}
    return Msgs(**inbox), state


# The inbox bytes a lane each compartment role kernel reads: valid (1)
# and 4 for each int32 field it loads. K23 and K27 read src, mid, type,
# a, b and c; K24 and K28 type, a, b and c; K25 type, a, b and src; K26
# and K29 type, a, b, c and src.
LANE_IN = {"compartment_sequencer_step": 25, "compartment_proxy_step": 17,
           "compartment_acceptor_step": 17, "compartment_replica_step": 21,
           "compartment_sequencer_elect": 25, "compartment_proxy_elect": 17,
           "compartment_acceptor_elect": 21,
           # the conviction lanes read src too
           "compartment_proxy_step+byz": 21,
           "compartment_proxy_elect+byz": 21}


def _role_io(kernel, lay, n, state, out):
    """(bytes, int32 operations) a compartment role step (K23-K29) must
    move and do: the inbox fields the kernel reads (`LANE_IN`), the state
    read and written, the outbox written; a few dozen operations a row
    and a lane and the in-round dedups (K x K a node), then the kernel's
    own folds: K23's retire (Q x K); K24's ack fold (Q x K x AR); K25's
    and K26's slots and apply walk; K27's retire and QVAL folds
    (Q x K), done_bits row and fan; K28's ack, fence and upgrade folds
    (Q x K x 3 + Q x AR); K29's query resolution (K x K) and copied
    rows."""
    K_, C, AR, AP = lay.K, lay.cap, lay.AR, lay.AP
    lane_in = LANE_IN.get(kernel, LANE_IN[kernel.split("+")[0]])
    byz = kernel.endswith("+byz")
    kernel = kernel.split("+")[0]
    io = (n * K_ * lane_in + 2 * nbytes(*state.values())
          + nbytes(*[getattr(out, f) for f in (
              "valid", "src", "dest", "due", "mid", "reply_to", "type", "a",
              "b", "c")]))
    Q = (lay.QL if "sequencer" in kernel
         else lay.QP if "proxy" in kernel else 0)
    extra = {"compartment_sequencer_step": Q * K_ * 3,
             "compartment_proxy_step": Q * K_ * 4 + Q * AR * 6,
             "compartment_acceptor_step": C + AP * (K_ + 30),
             "compartment_replica_step": C + AP * (K_ + 30),
             "compartment_sequencer_elect": Q * K_ * 6 + C + Q * AR * 8,
             "compartment_proxy_elect": Q * K_ * 12 + Q * AR * 6,
             "compartment_acceptor_elect": 3 * C + 2 * K_ * K_}[kernel]
    if byz and "proxy" in kernel:
        extra += Q * K_ * 3     # the conviction scan over the rows
    return io, n * (K_ * K_ + 30 * (Q + K_) + extra)


def compartment_kernel_checks(timed):
    """K23-K26, with and without the stall mask, against their plain
    versions on the same inputs on the card (exact: int32 and bool) at
    `COMPARTMENT_SHAPES`, the inputs unchanged after the launch, at
    rounds 0, 37 and 2^20 (rows due and not); timed without the mask."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    out = {}
    for name, (roles, opts, role, n) in COMPARTMENT_SHAPES.items():
        lay, prog = _compartment_role(roles, opts, role, n)
        err = 0
        for rnd in (37, 0, 1 << 20):
            inbox, state = _random_compartment(g, role, lay, n, rnd)
            before = clone(state), clone(inbox)
            stall = torch.rand(n, generator=g, device="cuda") < 0.3
            r = torch.tensor(rnd, dtype=torch.int32, device="cuda")
            for ctx in ({"round": r}, {"round": r, "stall": stall}):
                def step(ctx=ctx):
                    return prog.step(state, inbox, ctx)
                got = step()
                with K.forced_plain():
                    ref = step()
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, ref))
                del got, ref
            check(max_abs_err(before, (state, inbox)) == 0,
                  f"{name}: the kernel updated an input")
            del before
        check(err == 0, f"{name} differs from its plain version (max abs "
              f"err {err})")
        new, outbox = prog.step(state, inbox, {"round": r})
        io, ops = _role_io(name.split("@")[0], lay, n, state, outbox)
        b, by = bound_of(io, ops)
        rec = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
               "bytes": io, "ops": ops, "nodes": n, "lanes": lay.K,
               "slots": lay.cap, "table": {"sequencers": lay.QL,
                                           "proxies": lay.QP}.get(role)}
        del new, outbox
        if timed:
            def timed_step():
                return prog.step(state, inbox, {"round": r})
            rec["ms"] = cuda_ms(timed_step)
            with K.forced_plain():
                rec["plain_ms"] = cuda_ms(timed_step)
        out[name] = rec
        del prog, inbox, state
        torch.cuda.empty_cache()
    return out


def phase_compartment_kernels(timed):
    t0 = time.perf_counter()
    r = compartment_kernel_checks(timed)
    emit({"phase": "compartment_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


def _rounds_run(tm):
    """The rounds a run's scans ran, from its timing.json: those it
    executed, those replayed after a chunk ran past an exit, and those
    that ran past the exit and were rolled back. A role step launches
    its kernel once for each."""
    return (tm["rounds-executed"] + tm["scan-replayed-rounds"]
            + tm["scan-rolled-back-rounds"])


def phase_cli_compartment(smi):
    """The compartment's runs through the kernels, launch counters set to
    0 just before each and read just after: each history (and the
    targeted run's ring) must hash to the JAX runner's, every run valid
    with no pool overflow, each of K23-K26 launched once for every
    round the scan ran (`_rounds_run`); the targeted run's kills on the
    proxies (n1, n2) only, the shed run with both fails and oks."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_compartment")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, opts in CLI_COMPARTMENT:
        K.reset_launches()
        rc, d, res, tm, digest, wall = _core_run(opts, store)
        launches[name] = K.launch_counts()
        pin = PINNED_COMPARTMENT[name]
        check(rc == 0 and res["valid"] is True
              and res["net"]["dropped-overflow"] == 0,
              f"compartment {name}: exit {rc}, valid {res.get('valid')}, "
              f"overflow {res['net']['dropped-overflow']}")
        check(res["workload"]["valid"] is True,
              f"compartment {name}: workload {res['workload']}")
        check(digest == pin["history"], f"compartment {name}: history.jsonl "
              f"sha256 {digest}, the JAX runner's {pin['history']}")
        n_launch = [launches[name][k] for k in COMPARTMENT_KERNELS]
        ran = _rounds_run(tm)
        check(all(launches[name][k] == 0 for k in BYZ_KERNELS),
              f"compartment {name}: a benign run launched the adversary")
        check(tm["rounds-executed"] > 0 and n_launch == [ran] * len(n_launch),
              f"compartment {name}: launches {n_launch} for {ran} rounds "
              f"run ({tm['rounds-executed']} executed, "
              f"{tm['scan-replayed-rounds']} replayed, "
              f"{tm['scan-rolled-back-rounds']} rolled back)")
        st = res["stats"]
        rec = {"wall_s": wall, "final_round": tm["final-round"],
               "rounds_executed": tm["rounds-executed"],
               "replayed_rounds": tm["scan-replayed-rounds"],
               "rolled_back_rounds": tm["scan-rolled-back-rounds"],
               "ms_per_executed_round": 1e3 * tm["scan-s"]
               / max(tm["rounds-executed"], 1),
               "dispatches": tm["dispatches"], "drains": tm["drains"],
               "history_ops": tm["history-ops"],
               "ok": st["ok-count"], "fail": st["fail-count"],
               "server_msgs": res["net"]["servers"]["send-count"],
               "threefry_per_round": launches[name]["threefry"]
               / max(n_launch[0], 1),
               "history_sha256_equal": True}
        if name == "comp9-shed":
            check(st["fail-count"] > 0 and st["ok-count"] > 0,
                  f"compartment {name}: {st['ok-count']} ok, "
                  f"{st['fail-count']} failed")
        if opts.get("telemetry"):
            ring = _telemetry_checks(name, d, res, pin["telemetry"])
            rec["role_sent"] = ring["role-sent"]
            rec["telemetry_sha256_equal"] = True
        if opts.get("nemesis_targets"):
            with open(os.path.join(d, "history.jsonl")) as f:
                vals = [o["value"] for o in map(json.loads, f)
                        if o.get("process") == "nemesis"
                        and o["type"] == "info"]
            killed = [v for v in vals if str(v).startswith("killed")]
            others = [f"'n{i}'" for i in (0, 3, 4, 5, 6, 7, 8)]
            check(killed and all(("'n1'" in v or "'n2'" in v)
                                 and not any(o in v for o in others)
                                 for v in killed),
                  f"compartment {name}: kills {killed}")
            rec["killed"] = killed
        runs[name] = rec
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_compartment", "runs": runs, "launches": {
        k: {kk: v[kk] for kk in COMPARTMENT_KERNELS + ("threefry",)}
        for k, v in launches.items()}, "nvidia_smi": smi})
    return {k: sum(v[k] for v in launches.values())
            for k in COMPARTMENT_KERNELS}


def phase_bench_compartment(smi):
    """bench.py's compartment sweep at full width through the port's
    entry point (`python -m maelstrom_tpu_torch.bench --compartment`):
    every point valid with the JAX runner's ok ops, 4 proxies at least
    twice one's, each point's wall seconds and host ms an executed round
    (from its store's timing.json, read before the bench removes it), the
    launch counters set to 0 just before and read just after: each of
    K23-K26 launched once for every round the sweep's scans ran."""
    from maelstrom_tpu_torch import bench
    from maelstrom_tpu_torch import core
    from maelstrom_tpu_torch import kernels as K
    timings = []
    run = core.run

    def timed_run(opts):
        res = run(opts)
        d = os.path.realpath(os.path.join(opts["store_root"], "latest"))
        with open(os.path.join(d, "timing.json")) as f:
            timings.append(json.load(f))
        return res
    K.reset_launches()
    core.run = timed_run
    try:
        rec, rc = bench.main_compartment(device="cuda")
    finally:
        core.run = run
    counts = K.launch_counts()
    check(rc == 0 and rec["valid"] is True,
          f"bench_compartment: exit {rc}, record {rec}")
    got = {r["proxies"]: r["ok_ops"] for r in rec["proxies"]}
    check(got == PINNED_COMPARTMENT_BENCH,
          f"bench_compartment: ok ops {got}, the JAX runner's "
          f"{PINNED_COMPARTMENT_BENCH}")
    check(rec["scaling_1_to_4"] >= 2.0,
          f"bench_compartment: scaling {rec['scaling_1_to_4']}")
    check(len(timings) == len(rec["proxies"]),
          f"bench_compartment: {len(timings)} runs timed for "
          f"{len(rec['proxies'])} points")
    points = []
    for row, tm in zip(rec["proxies"], timings):
        check(tm["rounds-executed"] > 0,
              f"bench_compartment: P {row['proxies']} executed no round")
        points.append({**row, "rounds_executed": tm["rounds-executed"],
                       "replayed_rounds": tm["scan-replayed-rounds"],
                       "rolled_back_rounds": tm["scan-rolled-back-rounds"],
                       "host_ms_per_round": 1e3 * tm["scan-s"]
                       / max(tm["rounds-executed"], 1),
                       "dispatches": tm["dispatches"]})
    ran = sum(map(_rounds_run, timings))
    n_launch = [counts[k] for k in COMPARTMENT_KERNELS]
    check(n_launch == [ran] * len(n_launch),
          f"bench_compartment: launches {n_launch} for {ran} rounds run")
    emit({"phase": "bench_compartment", "points": points,
          "scaling_1_to_4": rec["scaling_1_to_4"],
          "value": rec["value"], "ok_ops_equal": True,
          "launches": {k: counts[k] for k in COMPARTMENT_KERNELS},
          "nvidia_smi": smi})
    return {k: counts[k] for k in COMPARTMENT_KERNELS}


# --- the compartment slice: elections and failover (K27-K29) -----------------

# tests/test_election.py's ELECT config (2 candidates, 1 proxy, a 1x2 grid,
# 1 replica; seed 11, rate 30 for 2.5 s, timeout 300 ms, election timeout
# 40 rounds, kill=sequencer, 1 s of recovery): the soup of kill, pause,
# partition and duplicate every 0.6 s; kill=sequencer with acceptor
# column 0 partitioned every 0.7 s (seed 13, 3 s, 2 s of recovery, the
# ring on); the kill under --continuous; and the soup with two redirect
# hops, 20 ms of backoff and the lease off. Nothing is cut.
ELECT_BASE = {"workload": "lin-kv", "node": "tpu:compartment", "seed": 11,
              "rate": 30.0, "time_limit": 2.5, "journal_rows": False,
              "timeout_ms": 300, "election_timeout_rounds": 40,
              "roles": "sequencers=2,proxies=1,acceptors=1x2,replicas=1",
              "nemesis_targets": "kill=sequencer", "recovery_s": 1}
SOUP4 = {"kill", "pause", "partition", "duplicate"}
CLI_ELECTION = [
    ("elect-soup", {**ELECT_BASE, "nemesis": SOUP4,
                    "nemesis_interval": 0.6}),
    ("elect-col", {**ELECT_BASE, "seed": 13, "time_limit": 3.0,
                   "nemesis": {"kill", "partition"}, "nemesis_interval": 0.7,
                   "nemesis_targets": "kill=sequencer,"
                                      "partition=acceptor-col-0",
                   "recovery_s": 2, "telemetry": "auto"}),
    ("elect-cont", {**ELECT_BASE, "continuous": True, "nemesis": {"kill"},
                    "nemesis_interval": 0.6}),
    ("elect-retries", {**ELECT_BASE, "nemesis": SOUP4,
                       "nemesis_interval": 0.6, "client_retries": 2,
                       "client_backoff_ms": 20, "leader_lease_ms": 0}),
]
# sha256 of the JAX runner's history.jsonl and of its `net.telemetry`
# block (None with the ring off), and its `availability.election` block,
# for each run above, on the CPU (JAX without its overlap pipeline);
# re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_election.py -m slow
PINNED_ELECTION = {
    "elect-soup": {
        "history":
            "2a951850297a70ac97546b716e2c4473875bf344cb1d4851295c9cd302aaa761",
        "telemetry": None,
        "election": {
            "candidates": 2,
            "failovers": 3,
            "wins-per-candidate": [1, 2],
            "ballot": 7,
            "leader": 1,
            "ballot-overflows": 0,
            "rounds-to-leader": {"mean": 2.0, "max": 2}}},
    "elect-col": {
        "history":
            "de8761b119552619b1fada13c5ef2c9327d5d357bd200b94df76ebcb6c1038e7",
        "telemetry":
            "b850d5841e96a90e654c56e34d88e57ae01654e1440b21ffb2a2520dad064ffa",
        "election": {
            "candidates": 2,
            "failovers": 2,
            "wins-per-candidate": [1, 1],
            "ballot": 4,
            "leader": 0,
            "ballot-overflows": 0,
            "rounds-to-leader": {"mean": 2.0, "max": 2}}},
    "elect-cont": {
        "history":
            "ec6430ac36d651b818c431fe3e8860d5ff313b7caeae01bcc00cae49ca0dcc0a",
        "telemetry": None,
        "election": {
            "candidates": 2,
            "failovers": 3,
            "wins-per-candidate": [1, 2],
            "ballot": 7,
            "leader": 1,
            "ballot-overflows": 0,
            "rounds-to-leader": {"mean": 2.0, "max": 2}}},
    "elect-retries": {
        "history":
            "5584e5fc08acac6d0b05e8fe2df5d198c274cc0e3964c34a615a7edb99d38544",
        "telemetry": None,
        "election": {
            "candidates": 2,
            "failovers": 3,
            "wins-per-candidate": [1, 2],
            "ballot": 7,
            "leader": 1,
            "ballot-overflows": 0,
            "rounds-to-leader": {"mean": 2.0, "max": 2}}},
}
# bench.py's failover record at full width (`bench_failover_record`): the
# JAX runner's counts on the CPU, re-derived by the same command
PINNED_FAILOVER_BENCH = {
    "failovers": 4, "forced_kills": 4,
    "rounds_to_leader": {"mean": 2.0, "max": 2},
    "client_ops_per_vsec": {"before": 170.0, "during": 127.5, "after": 160.0},
    "longest_ok_gap_rounds": 156, "dip_count": 0}
FAILOVER_PIN_KEYS = ("failovers", "forced_kills", "rounds_to_leader",
                     "client_ops_per_vsec", "longest_ok_gap_rounds",
                     "dip_count")

ELECT_KERNELS = ("compartment_sequencer_elect", "compartment_proxy_elect",
                 "compartment_acceptor_elect", "compartment_replica_step")
# (roles, layout options, role, role nodes) of each K26-K29 check at the
# elected learn packing: the CLI runs' ELECT shape (QL 32, K 8, a 406-slot
# log), bench.py's failover shape (the slice's path at full width, the
# kernels line's shape: 3 candidates, 4 proxies, a 2x2 grid, QL 128,
# K 16, a 2,656-slot log, 1,024 keys) and a stress shape at the elected
# layout's limits: 63 candidates, a 5 x 6 grid, a 4,095-slot log, QL
# 1,024, K 16, 4,096 proxies and 64 replicas.
_ELECT_ROLES = "sequencers=2,proxies=1,acceptors=1x2,replicas=1"
_ELECT_LAY = {"rate": 30.0, "time_limit": 2.5, "election_timeout_rounds": 40}
_FAIL_ROLES = "sequencers=3,proxies=4,acceptors=2x2,replicas=2"
_FAIL_LAY = {"leader_slots": 128, "proxy_slots": 8, "compartment_inbox": 16,
             "kv_keys": 1024, "concurrency": 48, "rate": 200.0,
             "time_limit": 6.0}
_STRESS_ROLES = "sequencers=63,proxies=4096,acceptors=5x6,replicas=64"
_STRESS_LAY = {"leader_slots": 1024, "compartment_inbox": 16,
               "log_cap": 4095, "kv_keys": 1024, "concurrency": 4000}
ELECT_SHAPES = {}
for _tag, (_roles, _lay) in {"elect": (_ELECT_ROLES, _ELECT_LAY),
                             "failover": (_FAIL_ROLES, _FAIL_LAY),
                             "stress": (_STRESS_ROLES, _STRESS_LAY)}.items():
    _n = {"elect": (2, 1, 2, 1), "failover": (3, 4, 4, 2),
          "stress": (63, 4096, 30, 64)}[_tag]
    for _k, _role, _nn in zip(ELECT_KERNELS, ("sequencers", "proxies",
                                              "acceptors", "replicas"), _n):
        ELECT_SHAPES[f"{_k}@{_tag}"] = (_roles, _lay, _role, _nn)


def election_kernel_checks(timed):
    """K27-K29 and K26 at the elected learn packing, with and without the
    stall mask, against their plain versions on the same inputs on the
    card (exact: int32 and bool) at `ELECT_SHAPES`, on the gpu tests'
    hazard inputs (`testing.compartment.random_compartment_inputs`: every
    phase-1 lane type, QVAL ballot ties, duplicate and stale prepares, a
    query of a slot written the same round, done_bits backlogs past 8,
    ballots at the width limit), the inputs unchanged after the launch,
    at rounds 37, 0 and 2^20; timed without the mask, the sequencer's
    jitter drawn before (its K7 draws are not K27's)."""
    import numpy as np
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch.net.tpu import Msgs
    from maelstrom_tpu_torch.testing.compartment import \
        random_compartment_inputs
    out = {}
    for name, (roles, opts, role, n) in ELECT_SHAPES.items():
        lay, prog = _compartment_role(roles, opts, role, n)
        err = 0
        for rnd in (37, 0, 1 << 20):
            rng = np.random.default_rng(n * 7 + rnd % 101)
            ib_np, st_np = random_compartment_inputs(rng, role, lay, n,
                                                     rnd)
            inbox = Msgs(**{k: torch.tensor(v, device="cuda")
                            for k, v in ib_np.items()})
            state = {k: torch.tensor(v, device="cuda")
                     for k, v in st_np.items()}
            before = clone(state), clone(inbox)
            stall = torch.tensor(rng.random(n) < 0.3, device="cuda")
            r = torch.tensor(rnd, dtype=torch.int32, device="cuda")
            key = prng.PRNGKey(rnd + n, "cuda")
            for ctx in ({"round": r, "key": key},
                        {"round": r, "key": key, "stall": stall}):
                def step(ctx=ctx):
                    return prog.step(state, inbox, ctx)
                got = step()
                with K.forced_plain():
                    ref = step()
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, ref))
                del got, ref
            check(max_abs_err(before, (state, inbox)) == 0,
                  f"{name}: the kernel updated an input")
            del before
        check(err == 0, f"{name} differs from its plain version (max abs "
              f"err {err})")
        ctx = {"round": r, "key": key}
        new, outbox = prog.step(state, inbox, ctx)
        io, ops = _role_io(name.split("@")[0], lay, n, state, outbox)
        b, by = bound_of(io, ops)
        rec = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
               "bytes": io, "ops": ops, "nodes": n, "lanes": lay.K,
               "slots": lay.cap, "candidates": lay.S, "grid": lay.A,
               "table": {"sequencers": lay.QL,
                         "proxies": lay.QP}.get(role)}
        del new, outbox
        if timed:
            if role == "sequencers":
                jit1 = prog.jitter(ctx)

                def timed_step():
                    return prog._launch_elect(state, inbox, r, None, jit1)

                def plain_step():
                    return prog.step_plain_elect(state, inbox, r, jit1)
            else:
                def timed_step():
                    return prog.step(state, inbox, ctx)
                plain_step = timed_step
            rec["ms"] = cuda_ms(timed_step)
            with K.forced_plain():
                rec["plain_ms"] = cuda_ms(plain_step)
        out[name] = rec
        del prog, inbox, state
        torch.cuda.empty_cache()
    return out


def phase_election_kernels(timed):
    t0 = time.perf_counter()
    r = election_kernel_checks(timed)
    emit({"phase": "election_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


def phase_cli_election(smi):
    """The elected compartment's runs through the kernels, launch
    counters set to 0 just before each and read just after: each history
    (and elect-col's ring) must hash to the JAX runner's, its
    `availability.election` block equal JAX's, every run valid with no
    pool overflow, elect-soup with two failovers or more, every kill on a
    candidate (n0, n1), each of K26-K29 launched once for every round the
    scan ran (an elected cluster never quiesces: every round of the
    window runs); the K7 launches a round beside them."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_election")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, opts in CLI_ELECTION:
        K.reset_launches()
        rc, d, res, tm, digest, wall = _core_run(opts, store)
        launches[name] = K.launch_counts()
        pin = PINNED_ELECTION[name]
        check(rc == 0 and res["valid"] is True
              and res["net"]["dropped-overflow"] == 0,
              f"election {name}: exit {rc}, valid {res.get('valid')}, "
              f"overflow {res['net']['dropped-overflow']}")
        check(res["workload"]["valid"] is True,
              f"election {name}: workload {res['workload']}")
        check(digest == pin["history"], f"election {name}: history.jsonl "
              f"sha256 {digest}, the JAX runner's {pin['history']}")
        elect = res["availability"].get("election")
        check(elect == pin["election"], f"election {name}: election block "
              f"{elect}, the JAX runner's {pin['election']}")
        n_launch = [launches[name][k] for k in ELECT_KERNELS]
        ran = _rounds_run(tm)
        check(all(launches[name][k] == 0 for k in BYZ_KERNELS),
              f"election {name}: a benign run launched the adversary")
        check(tm["rounds-executed"] > 0 and tm["rounds-bumped"] == 0
              and n_launch == [ran] * len(n_launch),
              f"election {name}: launches {n_launch} for {ran} rounds run "
              f"({tm['rounds-executed']} executed, "
              f"{tm['scan-replayed-rounds']} replayed, "
              f"{tm['scan-rolled-back-rounds']} rolled back, "
              f"{tm['rounds-bumped']} bumped)")
        with open(os.path.join(d, "history.jsonl")) as f:
            kills = [o["value"] for o in map(json.loads, f)
                     if o.get("process") == "nemesis" and o["type"] == "info"
                     and str(o["value"]).startswith("killed")]
        check(kills and all(("'n0'" in v) != ("'n1'" in v) for v in kills),
              f"election {name}: kills {kills}")
        if name == "elect-soup":
            check(elect["failovers"] >= 2, f"election {name}: {elect}")
        st = res["stats"]
        rec = {"wall_s": wall, "final_round": tm["final-round"],
               "rounds_executed": tm["rounds-executed"],
               "replayed_rounds": tm["scan-replayed-rounds"],
               "rolled_back_rounds": tm["scan-rolled-back-rounds"],
               "ms_per_executed_round": 1e3 * tm["scan-s"]
               / max(tm["rounds-executed"], 1),
               "dispatches": tm["dispatches"], "drains": tm["drains"],
               "history_ops": tm["history-ops"],
               "ok": st["ok-count"], "fail": st["fail-count"],
               "info": st["info-count"], "election": elect,
               "longest_ok_gap_rounds":
                   res["availability"]["longest-ok-gap-rounds"],
               "threefry_per_round": launches[name]["threefry"]
               / max(n_launch[0], 1),
               "kills": len(kills), "history_sha256_equal": True,
               "election_equal": True}
        if opts.get("telemetry"):
            ring = _telemetry_checks(name, d, res, pin["telemetry"])
            rec["role_sent"] = ring["role-sent"]
            rec["telemetry_sha256_equal"] = True
        runs[name] = rec
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_election", "runs": runs, "launches": {
        k: {kk: v[kk] for kk in ELECT_KERNELS + ("threefry",)}
        for k, v in launches.items()}, "nvidia_smi": smi})
    return {k: sum(v[k] for v in launches.values()) for k in ELECT_KERNELS}


def phase_bench_failover(smi):
    """bench.py's failover record at full width through the port's entry
    point (`python -m maelstrom_tpu_torch.bench --failover`): valid with
    two failovers or more, its counts equal to the JAX runner's
    (`PINNED_FAILOVER_BENCH`), its host ms an executed round from the
    store's timing.json (read before the bench removes it), the launch
    counters set to 0 just before and read just after: each of K26-K29
    launched once for every round the scans ran."""
    from maelstrom_tpu_torch import bench
    from maelstrom_tpu_torch import core
    from maelstrom_tpu_torch import kernels as K
    timings = []
    run = core.run

    def timed_run(opts):
        res = run(opts)
        d = os.path.realpath(os.path.join(opts["store_root"], "latest"))
        with open(os.path.join(d, "timing.json")) as f:
            timings.append(json.load(f))
        return res
    K.reset_launches()
    core.run = timed_run
    try:
        rec, rc = bench.main_failover(device="cuda")
    finally:
        core.run = run
    counts = K.launch_counts()
    check(rc == 0 and rec["valid"] is True and rec["failovers"] >= 2,
          f"bench_failover: exit {rc}, record {rec}")
    got = {k: rec[k] for k in FAILOVER_PIN_KEYS}
    check(got == PINNED_FAILOVER_BENCH,
          f"bench_failover: {got}, the JAX runner's {PINNED_FAILOVER_BENCH}")
    check(len(timings) == 1, f"bench_failover: {len(timings)} runs timed")
    tm = timings[0]
    ran = _rounds_run(tm)
    n_launch = [counts[k] for k in ELECT_KERNELS]
    check(tm["rounds-executed"] > 0 and n_launch == [ran] * len(n_launch),
          f"bench_failover: launches {n_launch} for {ran} rounds run")
    emit({"phase": "bench_failover", "record": rec, "counts_equal": True,
          "rounds_executed": tm["rounds-executed"],
          "replayed_rounds": tm["scan-replayed-rounds"],
          "rolled_back_rounds": tm["scan-rolled-back-rounds"],
          "host_ms_per_round": 1e3 * tm["scan-s"]
          / max(tm["rounds-executed"], 1),
          "dispatches": tm["dispatches"],
          "launches": {k: counts[k] for k in ELECT_KERNELS + ("threefry",)},
          "nvidia_smi": smi})
    return {k: counts[k] for k in ELECT_KERNELS}


# --- the byzantine adversary (K30, K31; K24 and K28's conviction lanes) ------

# tests/test_byzantine.py's run() config (seed 3, 2 candidates, 2 proxies, a
# 1x2 grid, 1 replica, retry 3, rate 20 for 3 s, a window every 0.8 s,
# byzantine=n0, equivocation); the same at one sequencer, so that K24's
# lanes run; byzantine=sequencers with stale ballots; the batched run of
# test_forged_proof_convicted_by_expansion_audit (seed 7, 5 nodes, rate
# 10 for 6 s, a window every 1.5 s, forged proofs); and the armed
# detectors on honest traffic (rate 0 permille, 2 s). Nothing is cut.
BYZ_BASE = {"workload": "lin-kv", "node": "tpu:compartment", "seed": 3,
            "rate": 20.0, "time_limit": 3.0, "journal_rows": False,
            "roles": "sequencers=2,proxies=2,acceptors=1x2,replicas=1",
            "compartment_retry": 3, "nemesis": {"byzantine"},
            "nemesis_interval": 0.8}
CLI_BYZANTINE = [
    ("byz-eq", {**BYZ_BASE, "nemesis_targets": "byzantine=n0",
                "byz_attacks": "equivocation"}),
    ("byz-eq1", {**BYZ_BASE, "roles": "proxies=2,acceptors=1x2,replicas=1",
                 "nemesis_targets": "byzantine=n0",
                 "byz_attacks": "equivocation"}),
    ("byz-stale", {**BYZ_BASE, "nemesis_targets": "byzantine=sequencers",
                   "byz_attacks": "stale-ballot"}),
    ("byz-forge", {"workload": "broadcast-batched",
                   "node": "tpu:broadcast-batched", "node_count": 5,
                   "seed": 7, "rate": 10.0, "time_limit": 6.0,
                   "journal_rows": False, "nemesis": {"byzantine"},
                   "nemesis_interval": 1.5, "byz_attacks": "forged-proof"}),
    ("byz-armed", {**BYZ_BASE, "nemesis_targets": "byzantine=n0",
                   "byz_attacks": "equivocation", "byz_rate": 0.0,
                   "time_limit": 2.0}),
]
# sha256 of the JAX runner's history.jsonl, its `byzantine` block and its
# verdict for each run above, on the CPU (JAX without its overlap
# pipeline); re-derived by
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_byzantine.py -m slow
PINNED_BYZANTINE = {
    "byz-eq": {
        "history":
            "405e72f76ced883b60fd63b0ec617c7b865f83db3b1b82a9feff8ae953b98e82",
        "valid": False,
        "byzantine": {
            "convictions": [{"rule": "equivocation", "culprit": "n0",
                             "evidence": {"count": 32, "slot": 62,
                                          "round": 894},
                             "code": 32, "witness": "n2"}],
            "injected": {"equivocation": 64, "forged-proof": 0,
                         "stale-ballot": 0},
            "unconvicted": [], "spurious": [], "valid": True}},
    "byz-eq1": {
        "history":
            "543162186a2c3ee9d073df8bb3501ec7f7a020c032d0ec6474846525d37b87f6",
        "valid": False,
        "byzantine": {
            "convictions": [{"rule": "equivocation", "culprit": "n0",
                             "evidence": {"count": 32, "slot": 62,
                                          "round": 894},
                             "code": 32, "witness": "n1"}],
            "injected": {"equivocation": 64, "forged-proof": 0,
                         "stale-ballot": 0},
            "unconvicted": [], "spurious": [], "valid": True}},
    "byz-stale": {
        "history":
            "59acf00d51d3276359c01b396986088dfa8e49eb8e409f3d398aaed2d58f17f3",
        "valid": True,
        "byzantine": {
            "convictions": [{"rule": "stale-ballot", "culprit": "n0",
                             "evidence": {"count": 13265, "ballot": 1,
                                          "round": 891},
                             "code": 32, "witness": "n3"}],
            "injected": {"equivocation": 0, "forged-proof": 0,
                         "stale-ballot": 13268},
            "unconvicted": [], "spurious": [], "valid": True}},
    "byz-forge": {
        "history":
            "05666c746be6193aff2d27dd8c18ff1c152e2c739517498a3f1df17f52e39473",
        "valid": False,
        "byzantine": {
            "convictions": [
                {"rule": "forged-count", "culprit": "n2",
                 "evidence": {"count": 2, "index": 52, "process": 2,
                              "error": "forged-count", "claimed": 4,
                              "acked": 8, "expanded": 4},
                 "code": 32},
                {"rule": "forged-proof", "culprit": "n2",
                 "evidence": {"count": 2, "index": 52, "process": 2,
                              "error": "forged-proof", "proof": 378,
                              "expected": 772},
                 "code": 32}],
            "injected": {"equivocation": 0, "forged-proof": 2,
                         "stale-ballot": 0},
            "unconvicted": [], "spurious": [], "valid": True}},
    "byz-armed": {
        "history":
            "782c5f99a8437a5179e7b0c35d3516ddbf98200754b9f604ca769543445dde1e",
        "valid": True,
        "byzantine": {
            "convictions": [],
            "injected": {"equivocation": 0, "forged-proof": 0,
                         "stale-ballot": 0},
            "unconvicted": [], "spurious": [], "valid": True}},
}
# bench.py's byzantine record at full width (`bench_byzantine_record`: 2
# candidates, 2 proxies, a 1x2 grid, 1 replica, 16 clients at 200 ops a
# second for 6 s, a window every 1.5 s, 1,024 keys, seed 3): the JAX
# runner's counts on the CPU, re-derived by the same command
PINNED_BYZANTINE_BENCH = {
    "attack_windows": 2, "conviction_latency_rounds": 5.0,
    "injected": {"equivocation": 1174, "forged-proof": 0,
                 "stale-ballot": 0},
    "convictions": [{"rule": "equivocation", "culprit": "n0", "count": 587,
                     "witness": "n3"}],
    "client_ops_per_vsec": {"benign": 157.5, "under_attack": 153.2},
    "benign_convictions": 0, "byzantine_valid": True, "benign_valid": True}
BYZ_BENCH_PIN_KEYS = tuple(PINNED_BYZANTINE_BENCH)

BYZ_KERNELS = ("byz_corrupt_pool", "byz_corrupt_edge")
# the proxy kernel each compartment run steps its proxies with
_BYZ_PROXY = {"byz-eq1": "compartment_proxy_step"}
# (roles, layout options) of the compartment shapes the byzantine checks
# run at: the smoke's ELECT runs' (2 candidates, 1 proxy), the bench
# record's (the slice's path at full width, the kernels line's shape:
# QL 32, K 8, QP 8, a 2,656-slot log, 1,024 keys), the one-sequencer run's
# (byz-eq1) and the stress shapes: 63 candidates, 4,096 proxies at AR 64
# (K28), and one sequencer with 4,096 proxies at AR 64 (K24)
_BYZ_BENCH_LAY = {"rate": 200.0, "time_limit": 6.0, "concurrency": 16,
                  "kv_keys": 1024, "compartment_retry": 3}
_BYZ_S1_ROLES = "proxies=2,acceptors=1x2,replicas=1"
_BYZ_STRESS1 = "proxies=4096,acceptors=5x6,replicas=64"
BYZ_ROLE_SHAPES = {
    "compartment_proxy_elect+byz@elect": (_ELECT_ROLES, _ELECT_LAY,
                                         "proxies", 1),
    "compartment_proxy_elect+byz@bench": (BYZ_BASE["roles"], _BYZ_BENCH_LAY,
                                         "proxies", 2),
    "compartment_proxy_elect+byz@stress": (_STRESS_ROLES, _STRESS_LAY,
                                          "proxies", 4096),
    "compartment_proxy_step+byz@eq1": (_BYZ_S1_ROLES, _CLI_LAY, "proxies",
                                      2),
    "compartment_proxy_step+byz@stress": (_BYZ_STRESS1, _STRESS_LAY,
                                         "proxies", 4096),
    "compartment_sequencer_elect+byz@bench": (BYZ_BASE["roles"],
                                              _BYZ_BENCH_LAY, "sequencers",
                                              2),
    "compartment_sequencer_step+byz@eq1": (_BYZ_S1_ROLES, _CLI_LAY,
                                           "sequencers", 1),
}
# the outboxes K30 rewrites (the whole compartment's [N, O]) and the
# client batches K31 rewrites ([N, K] of the batched program): the ELECT
# runs', the bench record's, the one-sequencer run's and the failover
# bench's (13 nodes, 539 lanes); the forged-proof run's 5 nodes and
# 100,000
BYZ_POOL_SHAPES = {"elect": (_ELECT_ROLES, _ELECT_LAY),
                   "bench": (BYZ_BASE["roles"], _BYZ_BENCH_LAY),
                   "eq1": (_BYZ_S1_ROLES, _CLI_LAY),
                   "failover": (_FAIL_ROLES, _FAIL_LAY)}
BYZ_EDGE_SHAPES = {"forge": 5, "stress100k": 100_000}


def _byz_compartment(roles, opts, device="cuda"):
    from maelstrom_tpu_torch.nodes import get_program
    from maelstrom_tpu_torch.nodes import compartment as C
    n = C.roles_node_count(roles)
    return get_program("compartment", {"roles": roles, **opts,
                                       "nemesis": {"byzantine"}},
                       [f"n{i}" for i in range(n)], device=device)


def _byz_edge_k():
    """K of the batched program's client batch (the forged-proof run's)."""
    from maelstrom_tpu_torch.nodes import get_program
    opts = dict(CLI_BYZANTINE)["byz-forge"]
    prog = get_program("broadcast-batched", dict(opts),
                       [f"n{i}" for i in range(5)], device="cpu")
    return prog.inbox_cap


def _random_byz_batch(g, n, L, msg_type):
    """An outbox on the card: mostly lanes of the attacked type, some
    invalid, words over the whole int32 range."""
    import torch
    from maelstrom_tpu_torch.net.tpu import Msgs

    def ri(lo, hi):
        return torch.randint(lo, hi, (n, L), generator=g, device="cuda",
                             dtype=torch.int32)
    typ = torch.where(torch.rand((n, L), generator=g, device="cuda") < 0.7,
                      msg_type, ri(0, 45))
    return Msgs(valid=torch.rand((n, L), generator=g, device="cuda") < 0.8,
                src=ri(0, n), dest=ri(0, n), due=ri(0, 50),
                mid=ri(0, 1000), reply_to=ri(-1, 1000), type=typ,
                a=ri(-2**31, 2**31 - 1), b=ri(-2**31, 2**31 - 1),
                c=ri(-2**31, 2**31 - 1))


def _byz_carries(n):
    """(name, carry) for the K30 / K31 checks on the card: each attack at
    a culprit in range, the culprit -1 and past the rows, the gate closed
    (rate 0 and inactive) and open (1,000 permille)."""
    import torch

    def carry(attack, culprit, rate_q, active=1, delta=12345):
        def i(v):
            return torch.tensor(v, dtype=torch.int32, device="cuda")
        return {"active": i(active), "attack": i(attack),
                "culprit": i(culprit), "delta": i(delta),
                "rate_q": i(rate_q),
                "injected": torch.tensor([7, 1 << 20, 3], dtype=torch.int32,
                                         device="cuda")}
    out = [(f"attack{a}", carry(a, n // 2, 1000)) for a in range(3)]
    out += [("last", carry(0, n - 1, 1000, delta=0x7FFF)),
            ("culprit-1", carry(0, -1, 1000)),
            ("past", carry(2, n, 1000)), ("rate0", carry(0, 0, 0)),
            ("rate1", carry(1, 0, 1)), ("rate999", carry(2, 0, 999)),
            ("inactive", carry(0, 0, 1000, active=0))]
    return out


def byzantine_kernel_checks(timed):
    """K30 and K31 against their plain versions on the same inputs on the
    card (exact) at `BYZ_POOL_SHAPES` / `BYZ_EDGE_SHAPES`, every carry of
    `_byz_carries` at rounds 0, 1, 2^20 and 2^31 - 1 (both parities, the
    gate's wrap), the carry unchanged after the launch; and the byz forms
    of K24, K28 (and K23, K27 on E_BYZANTINE NACK lanes) at
    `BYZ_ROLE_SHAPES`, with and without the stall mask, on
    `testing.compartment.random_byz_inputs` (equivocating, stale-ballot
    and honest assigns), the inputs unchanged. Timed without the mask,
    K30 and K31 at the equivocation / forged-proof carry with the gate
    open."""
    import numpy as np
    import torch
    from maelstrom_tpu_torch import byzantine as BZ
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch.net.tpu import Msgs
    from maelstrom_tpu_torch.nodes.broadcast_batched import T_BATCH_OK
    from maelstrom_tpu_torch.nodes.compartment import T_ASSIGN
    from maelstrom_tpu_torch.testing.compartment import random_byz_inputs
    from maelstrom_tpu_torch.tree import to
    g = torch.Generator(device="cuda")
    g.manual_seed(30)
    out = {}
    edge_k = _byz_edge_k()
    cases = [(f"byz_corrupt_pool@{tag}", False, roles, opts)
             for tag, (roles, opts) in BYZ_POOL_SHAPES.items()]
    cases += [(f"byz_corrupt_edge@{tag}", True, n, None)
              for tag, n in BYZ_EDGE_SHAPES.items()]
    for name, edge, a1, a2 in cases:
        if edge:
            n, L, wire = a1, edge_k, BZ.EdgeWire(T_BATCH_OK)
            prog = type("Edge", (), {"byz_wire_edge": lambda self: wire})()
            fn, plain = BZ.corrupt_edge, BZ.corrupt_edge_plain
        else:
            prog = _byz_compartment(a1, a2)
            n, L, wire = prog.n_nodes, prog.outbox_cap, prog.byz_wire()
            fn, plain = BZ.corrupt_pool, BZ.corrupt_pool_plain
        err, rewrote = 0, 0
        for rnd in (0, 1, 1 << 20, 2**31 - 1):
            r = torch.tensor(rnd, dtype=torch.int32, device="cuda")
            for _tag, carry in _byz_carries(n):
                batch = _random_byz_batch(g, n, L, wire.msg_type)
                keep = clone(carry)
                with K.forced_plain():
                    ref = plain(wire, carry, clone(batch), r)
                got = fn(prog, carry, batch, r)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, ref))
                check(max_abs_err(carry, keep) == 0,
                      f"{name}: the kernel updated the carry")
                rewrote += int((got[0]["injected"]
                                != carry["injected"]).any())
        check(err == 0, f"{name} differs from its plain version (max abs "
              f"err {err})")
        check(rewrote > 0, f"{name}: no check rewrote a lane")
        # bound: the culprit's row (valid, type and the two words read and
        # written) and the carry, 13 bytes a lane
        io = 13 * L + 4 * (len(BZ.SCALARS) + 2 * len(BZ.ATTACKS) + 1)
        b, by = bound_of(io, 8 * L)
        rec = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
               "bytes": io, "nodes": n, "lanes": L}
        if timed:
            # equivocation (K30), forged-proof (K31), the gate open
            carry = _byz_carries(n)[1 if edge else 0][1]
            batch = _random_byz_batch(g, n, L, wire.msg_type)
            r = torch.tensor(36, dtype=torch.int32, device="cuda")

            def timed_step():
                return fn(prog, carry, batch, r)
            rec["ms"] = cuda_ms(timed_step)
            with K.forced_plain():
                rec["plain_ms"] = cuda_ms(timed_step)
        out[name] = rec
        del prog
        torch.cuda.empty_cache()
    for name, (roles, opts, role, n) in BYZ_ROLE_SHAPES.items():
        lay, prog = _compartment_role(roles, opts, role, n, byz=True)
        err = 0
        for rnd in (37, 0, 1 << 20):
            rng = np.random.default_rng(n * 31 + rnd % 101)
            ib_np, st_np = random_byz_inputs(rng, role, lay, n, rnd)
            inbox = Msgs(**{k: torch.tensor(v, device="cuda")
                            for k, v in ib_np.items()})
            state = {k: torch.tensor(v, device="cuda")
                     for k, v in st_np.items()}
            before = clone(state), clone(inbox)
            stall = torch.tensor(rng.random(n) < 0.3, device="cuda")
            r = torch.tensor(rnd, dtype=torch.int32, device="cuda")
            key = prng.PRNGKey(rnd + n, "cuda")
            for ctx in ({"round": r, "key": key},
                        {"round": r, "key": key, "stall": stall}):
                def step(ctx=ctx):
                    return prog.step(state, inbox, ctx)
                got = step()
                with K.forced_plain():
                    ref = step()
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, ref))
                del got, ref
            check(max_abs_err(before, (state, inbox)) == 0,
                  f"{name}: the kernel updated an input")
            del before
        check(err == 0, f"{name} differs from its plain version (max abs "
              f"err {err})")
        ctx = {"round": r, "key": key}
        new, outbox = prog.step(state, inbox, ctx)
        io, ops = _role_io(name.split("@")[0], lay, n, state, outbox)
        b, by = bound_of(io, ops)
        rec = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
               "bytes": io, "ops": ops, "nodes": n, "lanes": lay.K,
               "candidates": lay.S, "table": {"sequencers": lay.QL,
                                              "proxies": lay.QP}[role]}
        del new, outbox
        if timed:
            if role == "sequencers" and lay.S > 1:
                jit1 = prog.jitter(ctx)

                def timed_step():
                    return prog._launch_elect(state, inbox, r, None, jit1)

                def plain_step():
                    return prog.step_plain_elect(state, inbox, r, jit1)
            else:
                def timed_step():
                    return prog.step(state, inbox, ctx)
                plain_step = timed_step
            rec["ms"] = cuda_ms(timed_step)
            with K.forced_plain():
                rec["plain_ms"] = cuda_ms(plain_step)
        out[name] = rec
        del prog, inbox, state
        torch.cuda.empty_cache()
    return out


def phase_byzantine_kernels(timed):
    t0 = time.perf_counter()
    r = byzantine_kernel_checks(timed)
    emit({"phase": "byzantine_kernels", "timed": timed,
          "seconds": time.perf_counter() - t0, "kernels": r})
    return r


# the byzantine runs, split over two run groups: (phase, runs)
BYZ_RUN_SPLIT = {"cli_byzantine": ("byz-eq", "byz-eq1", "byz-armed"),
                 "cli_byzantine_b": ("byz-stale", "byz-forge")}


def phase_cli_byzantine(smi, phase="cli_byzantine"):
    """The adversary's runs of `BYZ_RUN_SPLIT[phase]` through the
    kernels, launch counters set to 0 just before each and read just
    after: each history must hash to the
    JAX runner's, its `byzantine` block equal JAX's (valid: every
    injected kind convicted, none spurious), its verdict JAX's, no pool
    overflow; K30 (the compartment runs) or K31 (the forged-proof run)
    launched once for every round the scans ran, the other never; the
    proxy kernel with its conviction lanes once a round too."""
    import shutil
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", f"chip_smoke_{phase}")
    shutil.rmtree(store, ignore_errors=True)
    runs, launches = {}, {}
    for name, opts in CLI_BYZANTINE:
        if name not in BYZ_RUN_SPLIT[phase]:
            continue
        K.reset_launches()
        rc, d, res, tm, digest, wall = _core_run(opts, store)
        launches[name] = K.launch_counts()
        pin = PINNED_BYZANTINE[name]
        check(res["valid"] is pin["valid"]
              and res["net"]["dropped-overflow"] == 0,
              f"byzantine {name}: exit {rc}, valid {res.get('valid')} (the "
              f"JAX runner's {pin['valid']}), overflow "
              f"{res['net']['dropped-overflow']}")
        check(digest == pin["history"], f"byzantine {name}: history.jsonl "
              f"sha256 {digest}, the JAX runner's {pin['history']}")
        blk = res.get("byzantine")
        check(blk == pin["byzantine"] and blk["valid"] is True,
              f"byzantine {name}: block {blk}, the JAX runner's "
              f"{pin['byzantine']}")
        ran = _rounds_run(tm)
        edge = opts["node"] == "tpu:broadcast-batched"
        on, off = BYZ_KERNELS[::-1] if edge else BYZ_KERNELS
        n_on = launches[name][on]
        check(tm["rounds-executed"] > 0 and n_on == ran
              and launches[name][off] == 0,
              f"byzantine {name}: {on} launched {n_on}, {off} "
              f"{launches[name][off]}, for {ran} rounds run "
              f"({tm['rounds-executed']} executed, "
              f"{tm['scan-replayed-rounds']} replayed, "
              f"{tm['scan-rolled-back-rounds']} rolled back)")
        if not edge:
            proxy = _BYZ_PROXY.get(name, "compartment_proxy_elect")
            check(launches[name][proxy] == ran,
                  f"byzantine {name}: {proxy} launched "
                  f"{launches[name][proxy]} for {ran} rounds run")
        st = res["stats"]
        runs[name] = {
            "wall_s": wall, "final_round": tm["final-round"],
            "rounds_executed": tm["rounds-executed"],
            "replayed_rounds": tm["scan-replayed-rounds"],
            "rolled_back_rounds": tm["scan-rolled-back-rounds"],
            "ms_per_executed_round": 1e3 * tm["scan-s"]
            / max(tm["rounds-executed"], 1),
            "dispatches": tm["dispatches"], "history_ops": tm["history-ops"],
            "ok": st["ok-count"], "fail": st["fail-count"],
            "injected": blk["injected"],
            "convictions": [(c["rule"], c["culprit"], c.get("witness"))
                            for c in blk["convictions"]],
            "valid": res["valid"], "history_sha256_equal": True,
            "block_equal": True}
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": phase, "runs": runs, "launches": {
        k: {kk: v[kk] for kk in BYZ_KERNELS + (
            "compartment_proxy_step", "compartment_proxy_elect",
            "broadcast_batched_step")}
        for k, v in launches.items()}, "nvidia_smi": smi})
    return {k: sum(v[k] for v in launches.values())
            for k in BYZ_KERNELS + ("compartment_proxy_step",
                                    "compartment_proxy_elect")}


def phase_bench_byzantine(smi):
    """bench.py's byzantine record at full width through the port's entry
    point (`python -m maelstrom_tpu_torch.bench --byzantine`): valid, its
    attack windows, ledger, convictions, conviction latency and ok counts
    equal to the JAX runner's (`PINNED_BYZANTINE_BENCH`), no block on the
    benign twin; the launch counters set to 0 just before and read just
    after: K30 launched once for every round the attacked run's scans
    ran and never in the benign twin's, K28 once a round in both."""
    from maelstrom_tpu_torch import bench
    from maelstrom_tpu_torch import core
    from maelstrom_tpu_torch import kernels as K
    timings = []
    run = core.run

    def timed_run(opts):
        res = run(opts)
        d = os.path.realpath(os.path.join(opts["store_root"], "latest"))
        with open(os.path.join(d, "timing.json")) as f:
            timings.append(json.load(f))
        return res
    K.reset_launches()
    core.run = timed_run
    try:
        rec, rc = bench.main_byzantine(device="cuda")
    finally:
        core.run = run
    counts = K.launch_counts()
    check(rc == 0 and rec["valid"] is True,
          f"bench_byzantine: exit {rc}, record {rec}")
    got = {k: rec[k] for k in BYZ_BENCH_PIN_KEYS}
    check(got == PINNED_BYZANTINE_BENCH, f"bench_byzantine: {got}, the JAX "
          f"runner's {PINNED_BYZANTINE_BENCH}")
    check(len(timings) == 2, f"bench_byzantine: {len(timings)} runs timed")
    benign, attacked = (_rounds_run(t) for t in timings)
    check(counts["byz_corrupt_pool"] == attacked
          and counts["byz_corrupt_edge"] == 0
          and counts["compartment_proxy_elect"] == benign + attacked,
          f"bench_byzantine: K30 {counts['byz_corrupt_pool']}, K31 "
          f"{counts['byz_corrupt_edge']}, K28 "
          f"{counts['compartment_proxy_elect']} for {benign} benign and "
          f"{attacked} attacked rounds run")
    emit({"phase": "bench_byzantine", "record": rec, "counts_equal": True,
          "rounds_run": {"benign": benign, "under_attack": attacked},
          "host_ms_per_round": [1e3 * t["scan-s"]
                                / max(t["rounds-executed"], 1)
                                for t in timings],
          "launches": {k: counts[k] for k in BYZ_KERNELS + (
              "compartment_proxy_elect", "threefry")},
          "nvidia_smi": smi})
    return {k: counts[k] for k in BYZ_KERNELS + ("compartment_proxy_elect",)}


# --- the runs, side by side --------------------------------------------------

# The phases that drive the main path through the CLI, the runners, the
# benches and the sweeps. Their time is the host's: a run keeps about one
# CPU core busy and leaves the card idle most of the time. So they run in
# groups side by side, each group in a process of its own
# (`chip_smoke.py --worker I`, started by this script), the last group in
# this process. Every phase sets the launch counters to 0 just before its
# runs and reads them just after, in the process that drives them, and
# returns what it read. The groups hold about equal host time (NVIDIA H100
# 80GB HBM3, 700 W: the election group's phases one after another took
# 264 s, the others' 208 s, 199 s, 184 s, 202 s and 189 s; PR 13's
# byzantine runs alone: the bench 166 s, byz-eq, byz-eq1 and byz-armed
# 112 s, byz-stale and byz-forge 186 s, in two more groups). The profiles
# and the kernel times come after every group has ended, with the card
# to themselves.
# --- the fleet slice ---------------------------------------------------------
#
# `--fleet N`: N clusters in lockstep through the fleet scan (K32 holds the
# lanes that must not move, K5's fleet form keeps a reply log a lane), the
# cluster axis under faults (K1/K2/K9 with [F] rounds, K3 over rows, K7 over
# [F, 2] keys, K8 F-led), the fleet's [F] quiescence flags (K6's fleet
# form) and its session table's wave pass (K33, from 64 clusters on).

FLEET_KERNELS = ("fleet_hold", "wave_reduce", "reply_log_fleet",
                 "quiet_probe_fleet")
FLEET_PATH_KERNELS = ("fleet_hold", "reply_log_fleet", "edge_read",
                      "edge_write", "reply_compact", "threefry")
# the runs go through `core.run` (broadcast's recovery wait cut to 1 s,
# which the CLI has no flag for; lin-kv's RPC timeouts to 1 s)
FLEET_B = {"workload": "broadcast", "node": "tpu:broadcast",
           "node_count": 5, "rate": 10.0, "seed": 7, "recovery_s": 1.0}
FLEET_L = {"workload": "lin-kv", "node": "tpu:lin-kv", "node_count": 3,
           "rate": 10.0, "seed": 11, "timeout_ms": 1000.0}
FLEET_SOUP = {"nemesis": {"kill", "pause", "partition", "duplicate"},
              "nemesis_interval": 0.4, "timeout_ms": 1000.0}
CLI_FLEET = [
    # uniform latency at 50 ops/s: each cluster's draws are its seed's,
    # and reads catch values in flight, so the histories differ
    ("bcast64-seed", {**FLEET_B, "rate": 50.0, "time_limit": 1.0,
                      "latency": {"mean": 5, "dist": "uniform"},
                      "fleet": 64}),
    ("linkv8-nemesis-partition",
     {**FLEET_L, "time_limit": 1.0, "fleet": 8, "fleet_sweep": "nemesis",
      "nemesis": {"partition"}, "nemesis_interval": 0.3}),
    ("bcast4-soup", {**FLEET_B, **FLEET_SOUP, "time_limit": 1.2,
                     "fleet": 4}),
    ("linkv4-soup", {**FLEET_L, **FLEET_SOUP, "time_limit": 1.2,
                     "fleet": 4}),
    ("bcast4-capacity", {**FLEET_B, "time_limit": 1.0, "fleet": 4,
                         "fleet_sweep": "capacity"}),
]
# the cluster of a run whose standalone run the card runs too (the
# broadcast soup's clusters are held to the JAX fleet's pins here, and to
# their solos by tests/test_torch_fleet_faults.py on the CPU: its solo
# would make the fleet's group the smoke's longest)
FLEET_SOLOS = {"bcast64-seed": 63, "linkv8-nemesis-partition": 7,
               "linkv4-soup": 2, "bcast4-capacity": 3}
# every cluster's history.jsonl: the first 16 hex digits of its sha256, from
# the JAX package's fleet runner (`maelstrom_tpu.core.run` with the audit
# and the overlap pipeline off) on the CPU:
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fleet_faults.py \
#       -m slow -k pins
PINNED_FLEET = {
    # 60 of the 64 clusters give one history; clusters 5, 14, 21, 45
    # their own
    "bcast64-seed": [{5: "8b5228a848fc315d", 14: "8b5228a848fc315d",
                      21: "8b5228a848fc315d", 45: "b28d4a0ad2519e43"}.get(
                          i, "a6cf57f21d4ef881") for i in range(64)],
    "linkv8-nemesis-partition": [
        "1d802e9d1ae63cc1", "519913c5bd41f69f", "424c27d6586058a3",
        "d748d7b93f7c3c92", "be4c40a7948bf230", "dc8a9fdca187e421",
        "cf82403e232c8d4c", "9b6e4076d7407c5a"],
    "bcast4-soup": [
        "0bf4dc3c053e5717", "d51f3c8ac5c3002f", "bccde50f30018ad3",
        "e84acaeb4ba63e45"],
    "linkv4-soup": [
        "e00cfad3fd72ea30", "f5bb320fe74d6476", "626949c1e5203f32",
        "34a32872fcc8a979"],
    "bcast4-capacity": [
        "2f50ee75b4013750", "504fc9007ae87bda", "1c7b18a3ea607df9",
        "f9f0ce6f6d34b941"],
}
# bench.py's `bench_fleet_record`: messages delivered over the fleet at
# the sizes the CPU pins (the same 5-node grid, 8 dispatches of 64 rounds),
# from `maelstrom_tpu` on the CPU (the same slow test)
PINNED_FLEET_BENCH = {1: 176, 8: 1_408, 64: 11_264}
FLEET_SHAPE = {"clusters": 10_000, "nodes": 5}
WAVE_SHAPES = (64, 512, 10_000)
WAVE_CONCURRENCY = 5


def _fleet_digests(d, F):
    import hashlib
    out = []
    for i in range(F):
        with open(os.path.join(d, f"cluster-{i:04d}", "history.jsonl"),
                  "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest()[:16])
    return out


def _fleet_run(opts, store):
    """A run (a fleet, or one cluster alone) through `core.run` in this
    process; returns (results, store dir, timing, wall s)."""
    import contextlib
    from maelstrom_tpu_torch import core
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = core.run({**opts, "store_root": store})
    wall = time.perf_counter() - t0
    d = os.path.realpath(os.path.join(store, "latest"))
    with open(os.path.join(d, "timing.json")) as f:
        timing = json.load(f)
    return res, d, timing, wall


def phase_cli_fleet(smi):
    """The port's fleets on the card (`core.run` with `fleet`, as `test
    --fleet N` runs them), launch counters set to 0 just before and read
    just after: every cluster's history must hash to the JAX fleet
    runner's (`PINNED_FLEET`), the 64-cluster run must launch K33 (its
    session table's wave pass) once a wave, and one cluster of each run
    must equal its standalone run on the card (`FLEET_SOLOS`)."""
    import hashlib
    import shutil
    from maelstrom_tpu_torch import core
    from maelstrom_tpu_torch import kernels as K
    store = os.path.join(ROOT, "store", "chip_smoke_fleet")
    shutil.rmtree(store, ignore_errors=True)
    K.reset_launches()
    runs, digests = {}, {}
    for name, opts in CLI_FLEET:
        F = opts["fleet"]
        k32, k33 = K.FLEET_HOLD.launches, K.WAVE_REDUCE.launches
        res, d, tm, wall = _fleet_run(opts, store)
        got = _fleet_digests(d, F)
        digests[name] = got
        check(res["fleet"] == F, f"cli {name}: {res.get('fleet')} clusters")
        check(got == PINNED_FLEET[name],
              f"cli {name}: cluster histories {got}, the JAX fleet's "
              f"{PINNED_FLEET[name]}")
        for c in res["clusters"]:
            check(c["net"]["dropped-overflow"] == 0,
                  f"cli {name}: pool overflow in cluster {c['cluster']}")
        waves = tm["waves"]
        check(waves > 0 and tm["scan-rounds"] > 0, f"cli {name}: {tm}")
        # host reads: a packed fetch a wave and the scan's live-lane
        # reads, never one a cluster-round
        check(tm["drains"] < tm["lane-rounds"] / 2,
              f"cli {name}: {tm['drains']} drains for "
              f"{tm['lane-rounds']} cluster-rounds")
        runs[name] = {
            "fleet": F, "wall_s": wall, "valid": res["valid"],
            "cluster_valid": sum(bool(c["valid"]) for c in res["clusters"]),
            "waves": waves, "poll_passes": tm["poll-passes"],
            "dispatches": tm["dispatches"],
            "scan_rounds": tm["scan-rounds"],
            "lane_rounds": tm["lane-rounds"],
            "max_final_round": max(res["final-rounds"]),
            "scan_host_syncs": tm["scan-host-syncs"],
            "hold_row_bytes": tm["hold-row-bytes"],
            "quiet_probes": tm["quiet-probes"], "bumps": tm["bumps"],
            "session_device_waves": tm["session-device-waves"],
            "fleet_hold_launches": K.FLEET_HOLD.launches - k32,
            "wave_reduce_launches": K.WAVE_REDUCE.launches - k33,
            "host_ms_per_wave": 1e3 * tm["run-s"] / waves,
            "ms_per_scan_round": 1e3 * tm["run-s"] / tm["scan-rounds"],
            "drains": tm["drains"],
            "history_sha256_equal": True}
        check(runs[name]["fleet_hold_launches"] == 2 * tm["scan-rounds"],
              f"cli {name}: K32 launched "
              f"{runs[name]['fleet_hold_launches']} times for "
              f"{tm['scan-rounds']} lockstep rounds")
        if F >= 64:
            # the session table's wave pass: once a poll pass (the waves
            # and the last pass, which finds every cluster done)
            check(runs[name]["wave_reduce_launches"] == tm["poll-passes"],
                  f"cli {name}: K33 launched "
                  f"{runs[name]['wave_reduce_launches']} times for "
                  f"{tm['poll-passes']} poll passes")
    launches = K.launch_counts()
    for k in FLEET_PATH_KERNELS + FLEET_KERNELS + (
            "raft_step", "broadcast_step", "broadcast_step_stall",
            "edge_faults", "edge_write_spill"):
        check(launches[k] > 0, f"the fleet runs did not launch {k}: "
              f"{launches}")
    # one cluster of each run alone on the card: its standalone run
    for name, opts in CLI_FLEET:
        if name not in FLEET_SOLOS:
            continue
        i = FLEET_SOLOS[name]
        solo = core.FleetSpec.from_test(opts).cluster_opts(opts, i)
        _res, d, _tm, wall = _fleet_run(solo, store)
        with open(os.path.join(d, "history.jsonl"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        check(digest == digests[name][i],
              f"cli {name}: cluster {i} {digests[name][i]}, its "
              f"standalone run {digest}")
        runs[name]["solo"] = {"cluster": i, "wall_s": wall,
                              "history_sha256_equal": True}
    shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "cli_fleet", "runs": runs, "launches": launches,
          "nvidia_smi": smi})
    return launches


def phase_bench_fleet(smi):
    """The port's fleet record (`python -m maelstrom_tpu_torch.bench
    --fleet`) at 1, 8, 64, 512 and 10,000 clusters: every size
    converged with nothing dropped, and the messages delivered equal to
    the JAX package's record at the sizes the CPU pins."""
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch.bench import bench_fleet_record
    K.reset_launches()
    rec = bench_fleet_record(device="cuda")
    launches = K.launch_counts()
    check(rec["valid"], f"bench_fleet: {rec}")
    for r in rec["sizes"]:
        pin = PINNED_FLEET_BENCH.get(r["fleet"])
        if pin is not None:
            check(r["messages_delivered"] == pin,
                  f"bench_fleet {r['fleet']}: {r['messages_delivered']} "
                  f"messages, JAX's {pin}")
            r["messages_equal_jax"] = True
    for k in ("fleet_hold", "reply_log_fleet", "broadcast_step"):
        check(launches[k] > 0, f"bench_fleet did not launch {k}")
    emit({"phase": "bench_fleet", **rec, "launches": launches,
          "nvidia_smi": smi})
    return launches


def _fleet_carry(kind, F):
    """A fleet's batched state at F clusters: Raft lin-kv's (5 nodes, the
    CLI's pool and client widths) or the fleet bench's broadcast grid."""
    from maelstrom_tpu_torch.net import tpu as T
    from maelstrom_tpu_torch.parallel import make_fleet_sims
    from maelstrom_tpu_torch.nodes import get_program
    n = FLEET_SHAPE["nodes"]
    nodes = [f"n{i}" for i in range(n)]
    if kind == "lin-kv":
        prog = get_program("lin-kv", {"latency": {"mean": 0}}, nodes,
                           device="cuda")
        cfg = T.NetConfig(n_nodes=n, n_clients=n, pool_cap=64,
                          inbox_cap=prog.inbox_cap, client_cap=2 * n)
    else:
        prog = get_program("broadcast", {"topology": "grid",
                                         "max_values": 8,
                                         "latency": {"mean": 0},
                                         "eager_resend": True}, nodes,
                           device="cuda")
        cfg = T.NetConfig(n_nodes=n, n_clients=1, pool_cap=64,
                          inbox_cap=prog.inbox_cap, client_cap=0)
    return prog, cfg, make_fleet_sims(prog, cfg, list(range(F)),
                                      device="cuda")


def _cli_fleet_carry(name):
    """The initial fleet state of `CLI_FLEET`'s run `name`, as its fleet
    runner builds it (`FleetRunner`: every cluster row its standalone
    state, the channels at the run's ring)."""
    from maelstrom_tpu_torch import core
    from maelstrom_tpu_torch.runner.fleet_runner import FleetRunner
    store = os.path.join(ROOT, "store", "chip_smoke_carry")
    test = core.build_test({**dict(CLI_FLEET)[name], "store_root": store})
    return FleetRunner(test).sim


def fleet_kernel_checks(timed):
    """K32 at 10,000 clusters over the lin-kv carry and the fleet bench's
    and at the 64-cluster CLI run's (`bcast64-seed`),
    K33 at 64, 512 and 10,000 clusters of 5 clients, and the fleet forms
    of K1/K2/K9 ([F] rounds), K3 (rows, with the stall mask), K5, K6, K7
    ([F, 2] keys, [F] probabilities and scales) and K8 (F-led) at 10,000
    x 5 nodes, each against its plain version on the card. Returns
    {kernel@shape: {max_abs_err, bound_ms, bound_by[, ms, plain_ms]}}."""
    import torch
    from maelstrom_tpu_torch import kernels as K
    from maelstrom_tpu_torch import parallel as PP
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch import sim as S
    from maelstrom_tpu_torch.net import static
    from maelstrom_tpu_torch.net import tpu as T
    from maelstrom_tpu_torch.nodes import get_program
    from maelstrom_tpu_torch.runner.sessions import wave_reduce
    from maelstrom_tpu_torch.runner.tpu_runner import quiet_probe_fleet
    from maelstrom_tpu_torch.tree import leaves, tree_map
    g = torch.Generator(device="cuda")
    g.manual_seed(15)
    out = {}
    F, n = FLEET_SHAPE["clusters"], FLEET_SHAPE["nodes"]

    def record(name, got, ref, n_bytes, n_ops, fn_k, fn_p, extra=None,
               kernel=(), reset=None):
        """`reset`: what each call of fn_k and fn_p does first (restoring
        the inputs a write fills in place); the kernel's time is then its
        own, `kernel` naming it in the trace, and the plain version's
        less reset's."""
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        check(err == 0, f"{name} differs from its plain version (max abs "
              f"err {err})")
        b, by = bound_of(n_bytes, n_ops)
        r = {"max_abs_err": err, "bound_ms": b, "bound_by": by,
             **(extra or {})}
        if timed:
            r["ms"] = cuda_ms(fn_k, only=kernel)
            with K.forced_plain():
                r["plain_ms"] = cuda_ms(fn_p)
            if reset is not None:
                r["plain_ms"] -= cuda_ms(reset)
        out[name] = r

    def both(fn):
        got = fn()
        with K.forced_plain():
            ref = fn()
        return got, ref

    # K32 over the two 10,000-cluster carries and the 64-cluster CLI
    # run's: 30% of the lanes held
    for kind in ("lin-kv", "broadcast", "bcast64"):
        if kind == "bcast64":
            old = _cli_fleet_carry("bcast64-seed")
        else:
            _prog, _cfg, old = _fleet_carry(kind, F)
        Fk = old.key.shape[0]
        live = torch.rand(Fk, generator=g, device="cuda") >= 0.3
        held = int((~live).sum())
        parts = [old.net, old.nodes, old.key, old.channels]
        olds = [t for p in parts for _q, t in leaves(p)]

        def bump(t):
            return ~t if t.dtype == torch.bool else (
                t.view(torch.int32) + 1).view(t.dtype) \
                if t.element_size() == 4 else t + 1
        news = {d: [bump(t) for t in olds] for d in ("k", "p")}
        S.fleet_hold(live, list(zip(news["k"], olds)))
        with K.forced_plain():
            S.fleet_hold(live, list(zip(news["p"], olds)))
        row = sum(t.numel() // Fk * t.element_size() for t in olds)
        node_row = sum(t.numel() // Fk * t.element_size()
                       for _q, t in leaves(old.nodes))
        name = "fleet_hold@bcast64" if kind == "bcast64" else \
            f"fleet_hold@{kind}10k"
        record(name, tuple(news["k"]), tuple(news["p"]),
               2 * held * row + Fk, 0,
               lambda: S.fleet_hold(live, list(zip(news["k"], olds))),
               lambda: S.fleet_hold(live, list(zip(news["p"], olds))),
               {"clusters": Fk, "held": held, "row_bytes": row,
                "node_row_bytes": node_row, "carry_bytes": row * Fk,
                "leaves": len(olds)})
        del old, olds, news

    # K33 at the fleet sizes, C = 5: S = 10 pending slots, R = 8 requeue
    C = WAVE_CONCURRENCY
    Sl, Rl = max(2 * C, 8), max(C, 8)
    for Fw in WAVE_SHAPES:
        p_mid = torch.where(
            torch.rand((Fw, Sl), generator=g, device="cuda") < 0.4,
            torch.randint(0, 10**6, (Fw, Sl), generator=g, device="cuda"),
            -1).to(torch.int32)
        p_dl = torch.randint(0, 2**31 - 1, (Fw, Sl), generator=g,
                             device="cuda", dtype=torch.int32)
        r_valid = torch.rand((Fw, Rl), generator=g, device="cuda") < 0.2
        r_due = torch.randint(0, 2**31 - 1, (Fw, Rl), generator=g,
                              device="cuda", dtype=torch.int32)

        def k33(a=(p_mid, p_dl, r_valid, r_due)):
            return wave_reduce(*a)
        got, ref = both(k33)
        # bytes: p_mid and p_dl (8 a pending slot), r_valid and r_due (5
        # a requeue slot), dl and due written (8 a cluster)
        record(f"wave_reduce@{Fw}", got, ref, Fw * (8 * Sl + 5 * Rl + 8),
               Fw * (2 * Sl + 2 * Rl), k33, k33, {"clusters": Fw,
                                                   "S": Sl, "R": Rl})

    # the cluster axis under faults at 10,000 x 5: a faulted fleet state
    # whose channels a few rounds filled
    nodes = [f"n{i}" for i in range(n)]
    for dist in ("constant", "uniform"):
        prog = get_program("broadcast", {"topology": "grid",
                                         "max_values": 32,
                                         "latency": {"mean": 2,
                                                     "dist": dist},
                                         "nemesis": {"duplicate"}},
                           nodes, device="cuda")
        cfg = T.NetConfig(n_nodes=n, n_clients=5, pool_cap=64,
                          inbox_cap=prog.inbox_cap, client_cap=10,
                          latency_mean_rounds=2.0, latency_dist=dist,
                          partition_groups=n, enable_stall=True,
                          enable_duplication=True)
        sims = PP.make_fleet_sims(prog, cfg, list(range(F)), device="cuda")
        net = sims.net
        comp = torch.zeros_like(net.component)
        comp[:, :n] = torch.randint(0, 2, (F, n), generator=g,
                                    device="cuda")
        sims = sims.replace(net=net.replace(
            round=torch.randint(0, 99, (F,), generator=g, device="cuda",
                                dtype=torch.int32),
            p_loss=torch.full((F,), 0.03, device="cuda"),
            p_dup=torch.full((F,), 0.25, device="cuda"),
            latency_scale=torch.rand(F, generator=g, device="cuda") + 0.5,
            component=comp,
            down=torch.rand((F, n), generator=g, device="cuda") < 0.2,
            paused=torch.rand((F, n), generator=g, device="cuda") < 0.15))
        fn = PP.make_cluster_round_fn(prog, cfg, device="cuda")
        for _ in range(4):
            sims = fn(sims, T.Msgs.empty((F, 5), "cuda"))[0]
        axis = PP.cluster_axis(prog, F)
        ecfg = axis.ecfg
        rnd = sims.net.round
        ch = sims.channels
        rows = (F * n, prog.D, ecfg.ring, ecfg.lanes)
        ch_rows = ch.replace(**{f: getattr(ch, f).reshape(rows)
                                for f in ("valid", "type", "a", "b", "c")})
        tag = "spill" if ecfg.spill else "fixed"
        if dist == "constant":
            # K1 with [F] rounds, timed in place: each call first
            # restores the valid plane its clear empties
            got, ref = both(lambda: static.edge_read(
                ecfg, clone(ch_rows), axis.neighbors, axis.rev, rnd))
            ck1 = clone(ch_rows)
            valid1 = ck1.valid.clone()

            def reset1(c=ck1):
                c.valid.copy_(valid1)

            def k1(c=ck1):
                reset1()
                return static.edge_read(ecfg, c, axis.neighbors, axis.rev,
                                        rnd)
            lanes = F * n * prog.D * ecfg.lanes
            record("edge_read@fleet10k", got, ref, lanes * 2 * 17 + F * 4,
                   0, k1, k1, {"rows": F * n, "lanes": lanes},
                   kernel=("route_kernel", "clear_kernel"), reset=reset1)
            del ck1, valid1
        eo = _random_edge_msgs(g, (F * n, prog.D, prog.lanes), 32,
                               prog.n_windows)
        lat = torch.randint(0, 4, (F * n, prog.D, prog.lanes), generator=g,
                            device="cuda", dtype=torch.int32)
        mask = torch.rand((F * n, prog.D, 1), generator=g,
                          device="cuda") < 0.8

        got, ref = both(lambda: static.edge_write(ecfg, clone(ch_rows), eo,
                                                  rnd, lat, mask))
        # timed in place, no copy of the channels: each call first
        # restores the valid plane, so K9 finds its cells as the rounds
        # left them (a cell filled by the last call would drop its lanes)
        ck2 = clone(ch_rows)
        valid0 = ck2.valid.clone()

        def reset(c=ck2):
            c.valid.copy_(valid0)

        def k2(c=ck2):
            reset()
            return static.edge_write(ecfg, c, eo, rnd, lat, mask)
        lanes = F * n * prog.D * prog.lanes
        # bytes: every out lane's valid and latency, the [F * n, D] mask
        # and the [F] rounds; for each delivered lane its cell's valid
        # byte (K2's overwrite count) or Lc valid bytes (K9's occupancy);
        # for each written lane its 4 fields read and 17 bytes written
        ok_lanes = int((eo.valid & mask).sum())
        written = ok_lanes if not ecfg.spill else int(
            got.valid.sum() - ch_rows.valid.sum())
        record(f"edge_write{'_spill' if ecfg.spill else ''}@fleet10k",
               got, ref, lanes * (1 + 4) + F * n * prog.D + F * 4
               + ok_lanes * (ecfg.lanes if ecfg.spill else 1)
               + written * (16 + 17), 0, k2, k2,
               {"rows": F * n, "channel": tag, "delivered": ok_lanes,
                "written": written},
               kernel="spill_kernel" if ecfg.spill else "write_kernel",
               reset=reset)
        if dist == "constant":
            continue
        # K3 over the rows with the stall mask
        st = sims.nodes
        rows_state = {k: v.reshape((F * n,) + tuple(v.shape[2:]))
                      for k, v in st.items()}
        ein = _random_edge_msgs(g, (F * n, prog.D, ecfg.lanes), 32,
                                prog.n_windows)
        cin = _random_client(g, F * n, prog.inbox_cap, 32, 0.05)
        stall = (sims.net.down | sims.net.paused).reshape(-1)
        keys2 = prng.split(sims.key, 2)[:, 0].contiguous()

        def k3():
            return prog.step_rows(rows_state, ein, cin, rnd, keys2, stall)
        got, ref = both(k3)
        so, eo3, co = got
        io = (nbytes(*rows_state.values(), stall, rnd,
                     *[getattr(ein, f) for f in ("valid", "type", "a", "b",
                                                 "c")],
                     *[getattr(cin, f) for f in ("valid", "src", "due",
                                                 "mid", "type", "a", "b",
                                                 "c")])
              + nbytes(*so.values(), *[getattr(eo3, f) for f in
                                       ("valid", "type", "a", "b", "c")],
                       *[getattr(co, f) for f in
                         ("valid", "src", "dest", "due", "mid", "reply_to",
                          "type", "a", "b", "c")]))
        record("broadcast_step_stall@fleet10k", got, ref, io, 0, k3, k3,
               {"rows": F * n, "stalled": int(stall.sum())})
        # K8 F-led over [F, N, D, L]
        valid = torch.rand((F, n, prog.D, prog.lanes), generator=g,
                           device="cuda") < 0.3
        keys7 = prng.split(sims.key, 7)

        def k8():
            return S.edge_faults(cfg, prog.neighbors, sims.net, valid,
                                 keys7)
        got, ref = both(k8)
        n_el = valid.numel()
        record("edge_faults@fleet10k", got, ref,
               n_el + F * (8 * 4 * 2 + 2 * n + 12 + 7 * 8 + 32)
               + n_el * 10, 4 * n_el * DRAW_OPS, k8, k8,
               {"lanes": n_el})
        # K7 over [F, 2] keys: the pool send's four draws of 5 rows a
        # cluster, [F] probabilities and scales
        ks4 = prng.split(keys7[:, 1].contiguous(), 4)
        lat_spec = ("latency", "uniform", 2.0, sims.net.latency_scale)

        def k7():
            return (ks4,) + tuple(prng.draws(
                ks4, 5, [lat_spec, ("mask", sims.net.p_loss),
                         ("mask", sims.net.p_dup), lat_spec]))
        got, ref = both(k7)
        record("threefry@fleet10k", got, ref, F * (16 + 5 * 10 + 12),
               F * 4 * 5 * DRAW_OPS, k7, k7, {"draws": F * 20})
        # K6's fleet form over the broadcast fleet's planes
        planes = [sims.net.pool.valid, sims.channels.valid] \
            + prog.quiet_planes(sims.nodes)

        def k6():
            return quiet_probe_fleet(planes)
        got, ref = both(k6)
        record("quiet_probe_fleet@fleet10k", got, ref,
               nbytes(*planes) + F, 0, k6, k6, {"clusters": F})
        # K5's fleet form: a round's client rows into every live log
        CW = 10 + 10
        cm = _random_client(g, F, CW, 32, 0.1)
        cm = cm.replace(src=torch.randint(0, n, (F, CW), generator=g,
                                          device="cuda", dtype=torch.int32),
                        dest=cm.dest, reply_to=cm.reply_to)
        seen = sims.nodes["seen"].reshape(F * n, -1)
        live5 = torch.rand(F, generator=g, device="cuda") < 0.8
        kmax = torch.randint(1, 9, (F,), generator=g, device="cuda",
                             dtype=torch.int32)
        stop = torch.rand(F, generator=g, device="cuda") < 0.5
        W = prog.reply_payload_words
        logs = {}

        def k5(which):
            def run():
                log = S.empty_fleet_log(F, 256, W, "cuda")
                exit_k = torch.full((F,), 2**31 - 1, dtype=torch.int32,
                                    device="cuda")
                lv, nl = S.append_replies_fleet(log, cm, seen, n, rnd, 3,
                                                kmax, stop, exit_k, live5)
                logs[which] = (log, exit_k, lv, nl)
                return logs[which]
            return run
        got = k5("k")()
        with K.forced_plain():
            ref = k5("p")()
        n_valid = int((cm.valid & live5[:, None]).sum())
        record("reply_log_fleet@fleet10k",
               tuple(x for x in got[0] if x is not None) + got[1:],
               tuple(x for x in ref[0] if x is not None) + ref[1:],
               F * CW + F * 14 + n_valid * (41 + 4 * W + 32), 0, k5("k"),
               k5("p"), {"lanes": F, "rows": n_valid})
        del sims
    return out


def phase_fleet_kernels(timed):
    t0 = time.perf_counter()
    r = fleet_kernel_checks(timed)
    emit({"phase": "fleet_kernels", "timed": timed,
          "fleet_shape": FLEET_SHAPE, "seconds": time.perf_counter() - t0,
          "kernels": r})
    return r


def phase_fleet_profile():
    """Where a fleet dispatch's time goes on the card: the fleet bench's
    dispatch at 64 and 10,000 clusters (`bench.profile_fleet`): host ms a
    dispatch, the device's busy ms and idle share, the top device
    functions."""
    import torch
    from maelstrom_tpu_torch.bench import profile_fleet
    for F in (64, 10_000):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rec = profile_fleet(F)
        PROFILER["traces"] += 1
        check(rec["device_busy_ms_per_dispatch"] > 0,
              f"fleet profile {F}: no device time ({rec['top']})")
        emit({"phase": "fleet_profile", **rec})


RUN_PHASES = {
    "cli_small": lambda smi: phase_cli_small(),
    "cli_100k": phase_cli_100k,
    "cli_faults_small": lambda smi: phase_cli_faults_small(),
    "cli_faults_100k": phase_cli_faults_100k,
    "raft_bench_10k": phase_raft_bench,
    "cli_linkv": phase_cli_linkv,
    "cli_pool": phase_cli_pool,
    "cli_crdt": phase_cli_crdt,
    "cli_kafka": phase_cli_kafka,
    "cli_batched": phase_cli_batched,
    "cli_ordered": phase_cli_ordered,
    "bench_batched": phase_bench_batched,
    "cli_txn": phase_cli_txn,
    "cli_stream": phase_cli_stream,
    "cli_services": phase_cli_services,
    "cli_compartment": phase_cli_compartment,
    "bench_compartment": phase_bench_compartment,
    "cli_election": phase_cli_election,
    "bench_failover": phase_bench_failover,
    "cli_byzantine": phase_cli_byzantine,
    "cli_byzantine_b": lambda smi: phase_cli_byzantine(smi,
                                                       "cli_byzantine_b"),
    "bench_byzantine": phase_bench_byzantine,
    "bench_checkers": phase_bench_checkers,
    "fuzz_kafka": phase_fuzz_kafka,
    "fuzz_100k": phase_fuzz_broadcast,
    "cli_fleet": phase_cli_fleet,
    "bench_fleet": phase_bench_fleet,
}
RUN_GROUPS = [
    ["bench_byzantine", "cli_byzantine"],
    ["cli_byzantine_b", "cli_fleet"],
    ["cli_election", "bench_failover", "bench_fleet"],
    ["cli_compartment", "bench_compartment"],
    ["cli_services", "cli_small", "fuzz_kafka", "bench_batched",
     "cli_ordered", "raft_bench_10k"],
    ["cli_linkv", "cli_faults_small", "cli_faults_100k"],
    ["cli_crdt", "cli_kafka", "cli_100k", "cli_batched"],
    # this process: `bench_checkers` returns the Elle kernels' inputs
    ["bench_checkers", "cli_stream", "cli_txn", "fuzz_100k", "cli_pool"],
]
WORKER_THREADS = 2            # torch's CPU threads in each process
RESULT_TAG = "chip_smoke_worker_returns"


def _run_group(i, smi):
    """The phases of group i in this process; {phase: what it returned}."""
    return {name: RUN_PHASES[name](smi) for name in RUN_GROUPS[i]}


def _die_with_parent() -> bool:
    """Asks Linux for SIGKILL when the smoke's process ends, however it
    ends (PR_SET_PDEATHSIG); False if it has ended already."""
    import ctypes
    import signal
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    return os.getppid() == int(os.environ["CHIP_SMOKE_PARENT"])


def run_groups(smi):
    """Starts a worker for each group but the last, runs the last here,
    waits for every worker, prints its phase lines and returns what every
    phase returned. A worker that fails fails the smoke; no worker
    outlives it."""
    import shutil
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(WORKER_THREADS)
    out_dir = os.path.join(ROOT, "store", "chip_smoke_workers")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    procs = []
    try:
        for i in range(len(RUN_GROUPS) - 1):
            out = open(os.path.join(out_dir, f"{i}.out"), "w")
            env = {**os.environ, "CHIP_SMOKE_T0": repr(T_START),
                   "CHIP_SMOKE_WORKER": str(i),
                   "CHIP_SMOKE_PARENT": str(os.getpid())}
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(i), smi], stdout=out, env=env, cwd=ROOT), out))
        ret = _run_group(len(RUN_GROUPS) - 1, smi)
        seconds = {len(RUN_GROUPS) - 1: time.perf_counter() - t0}
        while len(seconds) < len(RUN_GROUPS):
            for i, (p, _out) in enumerate(procs):
                if i not in seconds and p.poll() is not None:
                    seconds[i] = time.perf_counter() - t0
                    check(p.returncode == 0, f"worker {i} "
                          f"({', '.join(RUN_GROUPS[i])}) exited "
                          f"{p.returncode}")
            time.sleep(0.2)
        for i, (p, out) in enumerate(procs):
            out.close()
            with open(out.name) as f:
                lines = f.read().splitlines()
            got = None
            for line in lines:
                if line.startswith("{") and RESULT_TAG in line:
                    got = json.loads(line)[RESULT_TAG]
                else:
                    print(line, flush=True)
            check(got is not None, f"worker {i} returned nothing")
            ret.update(got)
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    torch.set_num_threads(threads)
    shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "runs_side_by_side", "groups": RUN_GROUPS,
          "group_s": [seconds[i] for i in range(len(RUN_GROUPS))],
          "wall_s": time.perf_counter() - t0, "nvidia_smi": smi})
    return ret


def worker(i: int, smi: str) -> int:
    """`chip_smoke.py --worker I SMI`: group I's phases, their lines, then
    one line of what they returned."""
    if not _die_with_parent():
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.set_num_threads(WORKER_THREADS)
    emit({RESULT_TAG: _run_group(i, smi)})
    return 0


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
    checks = phase_kernels([BENCH_SHAPE, GRAFT_SHAPE, CLI_SHAPE],
                           timed=False, with_scan=True)
    phase_graft()
    phase_bench_16k(smi)
    phase_main_path(smi)
    fchecks = phase_fault_kernels(timed=False)
    rchecks = phase_raft_kernels(timed=False)
    pchecks = phase_pool_kernels(timed=False)
    cchecks = phase_crdt_kernels(timed=False)
    kchecks = phase_kafka_kernels(timed=False)
    schecks = phase_stream_kernels(timed=False)
    vchecks = phase_services_kernels(timed=False)
    mchecks = phase_compartment_kernels(timed=False)
    echecks = phase_election_kernels(timed=False)
    zchecks = phase_byzantine_kernels(timed=False)
    flchecks = phase_fleet_kernels(timed=False)
    phase_prng_pins()
    ret = run_groups(smi)
    launches = dict(ret["cli_100k"])
    launches["edge_write_spill"] = ret["cli_faults_small"]["edge_write_spill"]
    launches.update({k: ret["cli_faults_100k"][k]
                     for k in FAULT_PATH_KERNELS})
    launches["raft_step"] = ret["raft_bench_10k"]["raft_step"]
    pool_launches = ret["cli_pool"]
    launches.update({k: v for k, v in pool_launches.items()
                     if k in ("echo_step", "unique_ids_step")})
    for name in ("cli_crdt", "cli_batched", "cli_txn", "cli_stream",
                 "cli_services"):
        launches.update(ret[name])
    # the compartment's kernels: the pinned runs' and the bench sweep's
    for k in COMPARTMENT_KERNELS:
        launches[k] = ret["cli_compartment"][k] + ret["bench_compartment"][k]
    # the elected tier's: the election runs' and the failover bench's (K26
    # runs on both paths)
    for k in ELECT_KERNELS:
        launches[k] = (launches.get(k, 0) + ret["cli_election"][k]
                       + ret["bench_failover"][k])
    # the adversary's: the byzantine runs' and the conviction bench's
    # (K24 and K28 ran their conviction lanes there too)
    for k in BYZ_KERNELS + ("compartment_proxy_step",
                            "compartment_proxy_elect"):
        launches[k] = (launches.get(k, 0) + ret["cli_byzantine"][k]
                       + ret["cli_byzantine_b"][k]
                       + ret["bench_byzantine"].get(k, 0))
    launches["kafka_step"] = ret["cli_kafka"]["kafka_step"]
    # the fleet's kernels: the CLI fleets' and the fleet bench's (K33 runs
    # only on the CLI's --fleet 64 run)
    for k in FLEET_KERNELS:
        launches[k] = ret["cli_fleet"][k] + ret["bench_fleet"][k]
    elle_inputs = ret["bench_checkers"]
    # profiles and kernel times last: the profiler they are read from
    # stays out of the runs' wall-clock timing
    phase_cli_profile()
    phase_cli_profile(faults=True)
    phase_raft_profile()
    phase_fleet_profile()
    phase_kernels([BENCH_SHAPE, GRAFT_SHAPE], timed=True)
    cli = phase_kernels([CLI_SHAPE], timed=True, with_scan=True)["cli100k"]
    cli.update(phase_fault_kernels(timed=True))
    raft = phase_raft_kernels(timed=True)
    cli["raft_step"] = raft["raft_step"]
    cli.update(phase_pool_kernels(timed=True))
    cli.update(phase_crdt_kernels(timed=True))
    ktimed = phase_kafka_kernels(timed=True)
    cli["kafka_step"] = ktimed["kafka_step@5b"]
    btimed = phase_batched_kernels(timed=True)
    for k in ("broadcast_batched_step", "broadcast_batched_step_stall"):
        cli[k] = btimed[f"{k}@stress100k"]
    etimed = phase_elle_kernels(True, elle_inputs)
    for k in ("elle_edges", "elle_screen"):
        cli[k] = etimed[f"{k}@full"]
    stimed = phase_stream_kernels(timed=True)
    cli["sched_inject"] = stimed["sched_inject@100000"]
    cli["ring_update"] = stimed["ring_update@cli100k"]
    vtimed = phase_services_kernels(timed=True)
    cli["tso_step"] = vtimed["tso_step@cli"]
    cli["seq_kv_step"] = vtimed["seq_kv_step@cli"]
    cli["lww_kv_step"] = vtimed["lww_kv_step@100k"]
    mtimed = phase_compartment_kernels(timed=True)
    for k in COMPARTMENT_KERNELS:
        cli[k] = mtimed[f"{k}@bench"]
    etimed2 = phase_election_kernels(timed=True)
    for k in ELECT_KERNELS[:3]:
        cli[k] = etimed2[f"{k}@failover"]
    ztimed = phase_byzantine_kernels(timed=True)
    cli["byz_corrupt_pool"] = ztimed["byz_corrupt_pool@bench"]
    cli["byz_corrupt_edge"] = ztimed["byz_corrupt_edge@forge"]
    fltimed = phase_fleet_kernels(timed=True)
    cli["fleet_hold"] = fltimed["fleet_hold@lin-kv10k"]
    cli["wave_reduce"] = fltimed["wave_reduce@10000"]
    cli["reply_log_fleet"] = fltimed["reply_log_fleet@fleet10k"]
    cli["quiet_probe_fleet"] = fltimed["quiet_probe_fleet@fleet10k"]
    phase_crdt_profile()
    phase_pool_profile(pool_launches["rounds_executed"])
    emit({"phase": "profiler", **PROFILER})
    errs = {}
    for r in (*checks.values(), fchecks, rchecks, raft, pchecks, cchecks,
              kchecks, ktimed, btimed, etimed, schecks, stimed, vchecks,
              vtimed, mchecks, mtimed, echecks, etimed2, zchecks, ztimed,
              flchecks, fltimed):
        for name, v in r.items():
            # a kernel's byz form ("+byz") counts as the kernel
            base = {"raft_step_stall": "raft_step",
                    "threefry_batched": "threefry",
                    "reply_compact_batched": "reply_compact"}.get(
                        name, name.split("@")[0].split("+")[0])
            errs[base] = max(errs.get(base, 0), v["max_abs_err"],
                             v.get("cli_max_abs_err", 0))

    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": errs[k.name],
         "ms": cli[k.name]["ms"], "plain_ms": cli[k.name]["plain_ms"],
         "bound_ms": cli[k.name]["bound_ms"],
         "bound_by": cli[k.name].get("bound_by", "bytes"),
         "library_ms": None} for k in K.KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        sys.exit(worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
