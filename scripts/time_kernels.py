"""Times the port's redesigned kernels on the card at the shapes
chip_smoke.py checks them, for one or more checkouts of the port in
turns, and with `--variants` the kernels' parts: K3 (broadcast_step: its
stall and row forms too), K2 (edge_write: its fleet form too), K15
(broadcast_batched_step, with and without the stall mask) and K32
(fleet_hold over the fleets' carries).

    python3 scripts/time_kernels.py [--roots ROOT,ROOT,...] [--variants]
                                    [--kernels k3,k2,k15,k32] [--profile]

ROOTs are directories holding `maelstrom_tpu_torch/` and `chip_smoke.py`
(default: this checkout). To compare a parent with a change on one card,
unpack the parent into a directory that .gitignore lists and pass
`--roots PARENT,.,.,PARENT`. Each root runs in its own process, since both
packages carry one name, and builds its own kernels. Each process prints
one JSON line: {root, nvidia_smi, kernels: {name@shape: {ms, bound_ms,
...}}}; times are device times from chip_smoke.cuda_ms (a torch.profiler
trace of 20 calls), bounds as chip_smoke.py counts them (the bytes each
input read once, each output written once, over 3.35 TB/s). The shapes
are this script's own, so a parent's chip_smoke.py serves as well.

`--variants` (in the first process of this checkout) builds the port's own
sources again with a part flag each (`VARIANTS`: MT_K3_PART,
MT_K3_CACHE_BUDGET, MT_K2_PART, MT_K15_PART, MT_K32_PART, which the
sources document), launches each through the port's wrappers in place of
the kernel, and times it at the same shapes as `name@shape+variant`. It
adds `copy@shape`: one torch copy of the bytes the kernel's planes or
rows move there (read and written), the rate at which this card streams
them. `--profile` adds `profile@cli_batched` and `profile@cli_fleet`:
host and device ms a round and the device's idle share of the smoke's
batched and 64-cluster fleet runs (`profile_runs`).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _smoke(root):
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _k3_io(cs, state, ein, cin, stall, got, extra=()):
    """K3's bytes as chip_smoke.py counts them."""
    so, eo, co = got
    fields = ("valid", "type", "a", "b", "c")
    cin_f = ("valid", "src", "due", "mid", "type", "a", "b", "c")
    cout_f = ("valid", "src", "dest", "due", "mid", "reply_to", "type",
              "a", "b", "c")
    return (cs.nbytes(*state.values(), *extra,
                      *[getattr(ein, f) for f in fields],
                      *[getattr(cin, f) for f in cin_f],
                      *([] if stall is None else [stall]))
            + cs.nbytes(*so.values(), *[getattr(eo, f) for f in fields],
                        *[getattr(co, f) for f in cout_f]))


def _state(g, N, D, V, W):
    import torch
    return {"seen": torch.rand((N, V), generator=g, device="cuda") < .3,
            "owed": torch.rand((N, D, W), generator=g, device="cuda") < .3,
            **{k: torch.rand((N, D, V), generator=g, device="cuda") < .2
               for k in ("pending", "inflight", "inflight_old")}}


def time_k3(cs, out, tag=""):
    import torch
    shapes = [cs.BENCH_SHAPE, cs.GRAFT_SHAPE, cs.CLI_SHAPE]
    for name, n, V, per_nb, _cc, p_client in shapes:
        g = torch.Generator(device="cuda")
        g.manual_seed(n + V)
        p = cs._program(n, V, per_nb)
        state = _state(g, n, p.D, V, p.n_windows)
        ein = cs._random_edge_msgs(g, (n, p.D, p.edge_cfg.lanes), V,
                                   p.n_windows)
        cin = cs._random_client(g, n, p.inbox_cap, V, p_client)
        ctx = {"round": torch.tensor(p.retry_rounds * 3, dtype=torch.int32,
                                     device="cuda")}

        def k3(p=p, state=state, ein=ein, cin=cin, ctx=ctx):
            return p.edge_step(state, ein, cin, ctx)
        io = _k3_io(cs, state, ein, cin, None, k3(), (p.neighbors,))
        out[f"broadcast_step@{name}{tag}"] = {"ms": cs.cuda_ms(k3),
                                         "bound_ms": cs.bound_ms(io)}
        del state, ein, cin
    # the fault shape: a third of the nodes stalled
    N, V = cs.FAULT_SHAPE["nodes"], cs.FAULT_SHAPE["values"]
    g = torch.Generator(device="cuda")
    g.manual_seed(31)
    p = cs._program(N, V, 4)
    state = _state(g, N, p.D, V, p.n_windows)
    ein = cs._random_edge_msgs(g, (N, p.D, p.edge_cfg.lanes), V,
                               p.n_windows)
    cin = cs._random_client(g, N, p.inbox_cap, V, 0.01)
    stall = torch.rand(N, generator=g, device="cuda") < 0.32
    ctx = {"round": torch.tensor(p.retry_rounds * 3, dtype=torch.int32,
                                 device="cuda"), "stall": stall}

    def k3s():
        return p.edge_step(state, ein, cin, ctx)
    io = _k3_io(cs, state, ein, cin, stall, k3s(), (p.neighbors,))
    out[f"broadcast_step_stall@faults{tag}"] = {
        "ms": cs.cuda_ms(k3s), "bound_ms": cs.bound_ms(io)}
    del state, ein, cin
    # the fleet's rows: 10,000 clusters of 5 at V 32, [F] rounds, stall
    from maelstrom_tpu_torch import parallel as PP
    from maelstrom_tpu_torch.nodes import get_program
    F, n = cs.FLEET_SHAPE["clusters"], cs.FLEET_SHAPE["nodes"]
    prog = get_program("broadcast", {"topology": "grid", "max_values": 32,
                                     "latency": {"mean": 2,
                                                 "dist": "uniform"},
                                     "nemesis": {"duplicate"}},
                       [f"n{i}" for i in range(n)], device="cuda")
    lanes = PP.cluster_axis(prog, F).ecfg.lanes
    state = _state(g, F * n, prog.D, 32, prog.n_windows)
    ein = cs._random_edge_msgs(g, (F * n, prog.D, lanes), 32,
                               prog.n_windows)
    cin = cs._random_client(g, F * n, prog.inbox_cap, 32, 0.05)
    rnd = torch.randint(0, 99, (F,), generator=g, device="cuda",
                        dtype=torch.int32)
    stall = torch.rand(F * n, generator=g, device="cuda") < 0.32

    def k3r():
        return prog.step_rows(state, ein, cin, rnd, None, stall)
    io = _k3_io(cs, state, ein, cin, stall, k3r(), (rnd,))
    out[f"broadcast_step_stall@fleet10k{tag}"] = {
        "ms": cs.cuda_ms(k3r), "bound_ms": cs.bound_ms(io)}


def _k2_main(cs):
    """K2's inputs at the 100,000-node CLI shape, as chip_smoke.py's
    kernel_checks makes them: ring 2 under uniform arrival, the scalar
    latency 0 and an [N, D] deliver mask as broadcast views."""
    import torch
    _name, n, V, per_nb, _cc, _p = cs.CLI_SHAPE
    g = torch.Generator(device="cuda")
    g.manual_seed(n + V + 1)
    p = cs._program(n, V, per_nb)
    cfg = p.edge_cfg
    N, D, L = n, p.D, cfg.lanes
    ch = cs._random_channels(g, cfg)
    eo = cs._random_edge_msgs(g, (N, D, L), V, p.n_windows)
    lat = torch.zeros((), dtype=torch.int32, device="cuda").expand(N, D, L)
    mask = (torch.rand((N, D, 1), generator=g, device="cuda")
            < 0.9).expand(N, D, L)
    rnd = torch.tensor(17, dtype=torch.int32, device="cuda")
    ok = int((eo.valid & mask).sum())
    n_bytes = N * D * L + N * D + 4 + ok * (16 + 1 + 17)
    return cfg, ch, eo, rnd, lat, mask, n_bytes


def time_k2(cs, out, tag=""):
    import torch
    from maelstrom_tpu_torch import parallel as PP
    from maelstrom_tpu_torch.net import static
    from maelstrom_tpu_torch.nodes import get_program
    cfg, ch, eo, rnd, lat, mask, n_bytes = _k2_main(cs)

    def k2():
        return static.edge_write(cfg, ch, eo, rnd, lat, mask)
    k2()
    out[f"edge_write@cli100k{tag}"] = {"ms": cs.cuda_ms(k2),
                                       "bound_ms": cs.bound_ms(n_bytes)}
    del ch, eo
    # the fleet form: 10,000 clusters of 5, [F] rounds and counters
    F, n = cs.FLEET_SHAPE["clusters"], cs.FLEET_SHAPE["nodes"]
    g = torch.Generator(device="cuda")
    g.manual_seed(15)
    prog = get_program("broadcast", {"topology": "grid", "max_values": 32,
                                     "latency": {"mean": 2,
                                                 "dist": "constant"},
                                     "nemesis": {"duplicate"}},
                       [f"n{i}" for i in range(n)], device="cuda")
    ecfg = PP.cluster_axis(prog, F).ecfg
    ch = cs._random_channels(g, ecfg)
    ch = ch.replace(overwrites=torch.zeros(F, dtype=torch.int32,
                                           device="cuda"),
                    lat_clipped=torch.zeros(F, dtype=torch.int32,
                                            device="cuda"))
    rows = (F * n, prog.D, ecfg.lanes)
    eo = cs._random_edge_msgs(g, rows, 32, prog.n_windows)
    lat = torch.randint(0, 4, rows, generator=g, device="cuda",
                        dtype=torch.int32)
    mask = torch.rand((F * n, prog.D, 1), generator=g, device="cuda") < 0.8
    rnd = torch.randint(0, 99, (F,), generator=g, device="cuda",
                        dtype=torch.int32)
    lanes = rows[0] * rows[1] * rows[2]
    ok = int((eo.valid & mask).sum())

    def k2f():
        return static.edge_write(ecfg, ch, eo, rnd, lat, mask)
    k2f()
    out[f"edge_write@fleet10k{tag}"] = {
        "ms": cs.cuda_ms(k2f), "ring": ecfg.ring, "lanes": ecfg.lanes,
        "spill": ecfg.spill,
        "bound_ms": cs.bound_ms(lanes * 5 + F * n * prog.D + F * 4
                                + ok * (16 + 17 + 1))}


# K15's timed shapes: name: (nodes, values, ranges an edge, eager, client
# batch span), chip_smoke.py's BATCHED_SHAPES entries of the same names
K15_SHAPES = {"cli5": (5, 1024, 2, False, 16),
              "bench": (4096, 512, 1, True, 32),
              "cli1024": (1024, 1024, 2, False, 16),
              "stress100k": (100_000, 1024, 2, False, 64)}


def time_k15(cs, out, tag=""):
    """K15 and its stall form (40% of the nodes stalled) on an ordinary
    round at `K15_SHAPES`, on chip_smoke.py's random inputs."""
    import torch
    for name, (n, V, per_nb, eager, span) in K15_SHAPES.items():
        g = torch.Generator(device="cuda")
        g.manual_seed(n + V)
        prog = cs._batched_program(n, V, per_nb, eager)
        state, ein, cin = cs._random_batched_inputs(g, prog, span)
        stall = torch.rand(n, generator=g, device="cuda") < 0.4
        io, ops = cs.batched_io_ops(prog, ein.valid.shape[2],
                                    cin.valid.shape[1])
        for st in (None, stall):
            ctx = {"round": torch.tensor(3 * prog.retry_rounds + 1,
                                         dtype=torch.int32, device="cuda")}
            if st is not None:
                ctx["stall"] = st

            def k15(ctx=ctx):
                return prog.edge_step(state, ein, cin, ctx)
            b, by = cs.bound_of(io, ops)
            kern = "broadcast_batched_step" + ("_stall" if st is not None
                                               else "")
            out[f"{kern}@{name}{tag}"] = {"ms": cs.cuda_ms(k15),
                                          "bound_ms": b, "bound_by": by}
        del state, ein, cin
        torch.cuda.empty_cache()


def _cli_fleet_carry(cs, name):
    """The initial fleet state of chip_smoke.CLI_FLEET's run `name`, as
    its fleet runner builds it."""
    from maelstrom_tpu_torch import core
    from maelstrom_tpu_torch.runner.fleet_runner import FleetRunner
    store = os.path.join(REPO, "store", "time_kernels_carry")
    test = core.build_test({**dict(cs.CLI_FLEET)[name],
                            "store_root": store})
    return FleetRunner(test).sim


def _k32_carries(cs):
    """(shape, carry) of K32's timed shapes: the 10,000-cluster lin-kv
    and fleet-bench carries, the 64-cluster CLI run's."""
    F = cs.FLEET_SHAPE["clusters"]
    yield "lin-kv10k", cs._fleet_carry("lin-kv", F)[2]
    yield "broadcast10k", cs._fleet_carry("broadcast", F)[2]
    yield "bcast64", _cli_fleet_carry(cs, "bcast64-seed")


def _held(F):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(32)
    live = torch.rand(F, generator=g, device="cuda") >= 0.3
    return live, int((~live).sum())


def _carry_leaves(old):
    from maelstrom_tpu_torch.tree import leaves
    return [t for p in (old.net, old.nodes, old.key, old.channels)
            for _q, t in leaves(p)]


def time_k32(cs, out, tag=""):
    """K32 over each carry of `_k32_carries` with 30% of the lanes held,
    as chip_smoke.py's fleet_kernel_checks times it."""
    import torch
    from maelstrom_tpu_torch import sim as S
    for shape, old in _k32_carries(cs):
        F = old.key.shape[0]
        live, held = _held(F)
        olds = _carry_leaves(old)
        pairs = [(t.clone(), t) for t in olds]
        row = sum(t.numel() // F * t.element_size() for t in olds)

        def k32():
            S.fleet_hold(live, pairs)
        k32()
        out[f"fleet_hold@{shape}{tag}"] = {
            "ms": cs.cuda_ms(k32), "bound_ms": cs.bound_ms(2 * held * row
                                                           + F),
            "clusters": F, "held": held, "row_bytes": row,
            "leaves": len(olds)}
        del old, olds, pairs
        torch.cuda.empty_cache()


def time_k32_copies(cs, out):
    """A torch copy of the bytes K32 moves over each carry (the held
    rows read and written)."""
    import torch
    for shape, old in _k32_carries(cs):
        F = old.key.shape[0]
        _live, held = _held(F)
        row = sum(t.numel() // F * t.element_size()
                  for t in _carry_leaves(old))
        del old
        src = torch.zeros(held * row, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        out[f"copy@fleet_hold@{shape}"] = {
            "ms": cs.cuda_ms(lambda: dst.copy_(src)),
            "bound_ms": cs.bound_ms(2 * held * row), "bytes": 2 * held * row}
        del src, dst
        torch.cuda.empty_cache()


# name: (source, flag); the sources say what each part leaves out
VARIANTS = {
    "nostores": ("broadcast.cu", "-DMT_K3_PART=1"),
    "noplanes": ("broadcast.cu", "-DMT_K3_PART=2"),
    "noitems": ("broadcast.cu", "-DMT_K3_PART=3"),
    "nocache": ("broadcast.cu", "-DMT_K3_CACHE_BUDGET=0"),
    "loads": ("edge.cu", "-DMT_K2_PART=1"),
    "stores": ("edge.cu", "-DMT_K2_PART=2"),
    "noread": ("edge.cu", "-DMT_K2_PART=3"),
    "k15nostores": ("broadcast_batched.cu", "-DMT_K15_PART=1"),
    "k15noplanes": ("broadcast_batched.cu", "-DMT_K15_PART=2"),
    "k15noitems": ("broadcast_batched.cu", "-DMT_K15_PART=3"),
    "k32loads": ("fleet.cu", "-DMT_K32_PART=1"),
    "k32stores": ("fleet.cu", "-DMT_K32_PART=2"),
    "k32flags": ("fleet.cu", "-DMT_K32_PART=3"),
}
# the kernel each source's variants time
TIMERS = {"broadcast.cu": "k3", "edge.cu": "k2",
          "broadcast_batched.cu": "k15", "fleet.cu": "k32"}


class _Overlay:
    """The port's library with a variant's entry points in place of its
    own (the variant library holds one source's)."""

    def __init__(self, base, variant):
        self._base, self._variant = base, variant

    def __getattr__(self, name):
        try:
            return getattr(self._variant, name)
        except AttributeError:
            return getattr(self._base, name)


def build_variants(K, kernels):
    """One library a variant of the `kernels` timed, from the port's own
    source and the flag, each compiled by its own nvcc, all started
    together."""
    build = os.path.join(K.BUILD, "variants")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for name, (src, flag) in VARIANTS.items():
        if TIMERS[src] not in kernels:
            continue
        lib = os.path.join(build, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [K._nvcc(), *K.ARCH, *K.NVCC_FLAGS, flag, "-shared", "-o", lib,
             os.path.join(K.CSRC, src)]))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed on variant {name}")
        libs[name] = ctypes.CDLL(lib)
        for k in K.KERNELS:
            fn = getattr(libs[name], f"mt_{k.name}", None)
            if fn is not None:
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
    return libs


def time_copies(cs, out):
    """A torch copy of the bytes K3's planes move (seen and three [N, D, V]
    planes, read and written) at the CLI shape (D 4) and the fleet rows'
    (the 5-node grid's D 3); K15's at its stress shape (D 4) are the same
    bytes as K3's at the CLI shape."""
    import torch
    _name, n, V, _per_nb, _cc, _p = cs.CLI_SHAPE
    rows = cs.FLEET_SHAPE["clusters"] * cs.FLEET_SHAPE["nodes"]
    for shape, N, V, D in (("cli100k", n, V, 4), ("fleet10k", rows, 32, 3)):
        src = torch.zeros((N, 3 * D * V + V), dtype=torch.uint8,
                          device="cuda")
        dst = torch.empty_like(src)
        moved = 2 * src.numel()
        out[f"copy@{shape}"] = {
            "ms": cs.cuda_ms(lambda: dst.copy_(src)),
            "bound_ms": cs.bound_ms(moved), "bytes": moved}
        del src, dst


# the runs `--profile` traces: (line, chip_smoke.py run list, run name,
# timing.json's host seconds and count of the rounds the card ran, as
# chip_smoke.py divides them)
PROFILE_RUNS = (("cli_batched", "CLI_BATCHED", "batched5-e2e", "scan-s",
                 "rounds-executed"),
                ("cli_fleet", "CLI_FLEET", "bcast64-seed", "run-s",
                 "scan-rounds"))


def profile_runs(cs, out):
    """Host and device ms a round and the idle share of the smoke's
    `cli_batched` and `cli_fleet` paths: each run once on the host clock
    (timing.json's scan seconds over its rounds, as chip_smoke.py reports
    them) and once under torch.profiler (the device functions' time over
    the same rounds; the profiler's own host cost does not reach the
    device time). Idle share = 1 - device ms / host ms a round."""
    import contextlib
    import shutil
    import torch
    from maelstrom_tpu_torch import core
    store = os.path.join(REPO, "store", "time_kernels_runs")
    for line, runs, name, secs, key in PROFILE_RUNS:
        opts = {**dict(getattr(cs, runs))[name], "store_root": store}
        with contextlib.redirect_stdout(sys.stderr):
            core.run(dict(opts))
        with open(os.path.join(store, "latest", "timing.json")) as f:
            tm = json.load(f)
        rounds = tm[key]
        host = 1e3 * tm[secs] / rounds
        # device records alone: host-side op records would slow every
        # round of the run
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof, \
                contextlib.redirect_stdout(sys.stderr):
            core.run(dict(opts))
            torch.cuda.synchronize()
        with open(os.path.join(store, "latest", "timing.json")) as f:
            rounds2 = json.load(f)[key]
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   ) / 1e3 / rounds2
        out[f"profile@{line}"] = {
            "run": name, "rounds": rounds, "host_ms_per_round": host,
            "device_busy_ms_per_round": busy,
            "device_idle_share": max(0.0, 1 - busy / host)}
        shutil.rmtree(store, ignore_errors=True)


def time_kernels(cs, out, kernels, tag=""):
    import torch
    for k in kernels:
        {"k3": time_k3, "k2": time_k2, "k15": time_k15,
         "k32": time_k32}[k](cs, out, tag)
        torch.cuda.empty_cache()


def time_variants(cs, K, out, kernels):
    libs = build_variants(K, kernels)
    base = K._library()
    try:
        for name, lib in libs.items():
            K._state["lib"] = _Overlay(base, lib)
            time_kernels(cs, out, [TIMERS[VARIANTS[name][0]]], f"+{name}")
    finally:
        K._state["lib"] = base
    if "k3" in kernels or "k15" in kernels:
        time_copies(cs, out)
    if "k32" in kernels:
        time_k32_copies(cs, out)


def worker(root, variants, kernels, profile):
    cs = _smoke(os.path.abspath(root))
    from maelstrom_tpu_torch import kernels as K
    K.build()
    out = {}
    time_kernels(cs, out, kernels)
    if variants:
        time_variants(cs, K, out, kernels)
    if profile:
        profile_runs(cs, out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": root, "nvidia_smi": smi, "kernels": out}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", default=".")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--kernels", default="k3,k2,k15,k32")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker")
    a = ap.parse_args()
    kernels = a.kernels.split(",")
    if a.worker:
        worker(a.worker, a.variants, kernels, a.profile)
        return 0
    rc, parts = 0, a.variants
    for root in a.roots.split(","):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root,
               "--kernels", a.kernels]
        if parts and os.path.abspath(root) == REPO:
            cmd.append("--variants")  # once, in this checkout's first
            parts = False
        if a.profile:
            cmd.append("--profile")
        rc |= subprocess.run(cmd, cwd=REPO).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
