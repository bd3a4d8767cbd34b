"""Times K3 (broadcast_step: its stall and row forms too) and K2
(edge_write: its fleet form too) on the card at the shapes chip_smoke.py
times them, for one or more checkouts of the port in turns, and with
`--variants` the kernels' parts.

    python3 scripts/time_k3_k2.py [--roots ROOT,ROOT,...] [--variants]

ROOTs are directories holding `maelstrom_tpu_torch/` and `chip_smoke.py`
(default: this checkout). To compare a parent with a change on one card,
unpack the parent into a directory that .gitignore lists and pass
`--roots PARENT,.,.,PARENT`. Each root runs in its own process, since both
packages carry one name, and builds its own kernels. Each process prints
one JSON line: {root, kernels: {name@shape: {ms, bound_ms, ...}}}; times
are device times from chip_smoke.cuda_ms (a torch.profiler trace of 20
calls), bounds as chip_smoke.py counts them (the bytes each input read
once, each output written once, over 3.35 TB/s).

`--variants` (in the processes of this checkout) builds the port's own
`csrc/broadcast.cu` and `csrc/edge.cu` again with a part flag each
(`VARIANTS`: MT_K3_PART, MT_K3_CACHE_BUDGET, MT_K2_PART, which the
sources document), launches each through the port's wrappers in place of
the kernel, and times it at the same shapes as `name@shape+variant`. It
adds `copy@shape`: one torch copy of the bytes K3's planes move there
(seen and the three [N, D, V] planes read and written), the rate at which
this card streams them.
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


# name: (source, flag); the sources say what each part leaves out
VARIANTS = {
    "nostores": ("broadcast.cu", "-DMT_K3_PART=1"),
    "noplanes": ("broadcast.cu", "-DMT_K3_PART=2"),
    "noitems": ("broadcast.cu", "-DMT_K3_PART=3"),
    "nocache": ("broadcast.cu", "-DMT_K3_CACHE_BUDGET=0"),
    "loads": ("edge.cu", "-DMT_K2_PART=1"),
    "stores": ("edge.cu", "-DMT_K2_PART=2"),
    "noread": ("edge.cu", "-DMT_K2_PART=3"),
}


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


def build_variants(K):
    """One library a variant, from the port's own source and the flag,
    each compiled by its own nvcc, all started together."""
    build = os.path.join(K.BUILD, "variants")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for name, (src, flag) in VARIANTS.items():
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
    (the 5-node grid's D 3)."""
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


def time_variants(cs, K, out):
    import torch
    libs = build_variants(K)
    base = K._library()
    try:
        for name, lib in libs.items():
            K._state["lib"] = _Overlay(base, lib)
            timer = time_k3 if VARIANTS[name][0] == "broadcast.cu" \
                else time_k2
            timer(cs, out, f"+{name}")
            torch.cuda.empty_cache()
    finally:
        K._state["lib"] = base
    time_copies(cs, out)


def worker(root, variants):
    import torch
    cs = _smoke(os.path.abspath(root))
    from maelstrom_tpu_torch import kernels as K
    K.build()
    out = {}
    time_k3(cs, out)
    torch.cuda.empty_cache()
    time_k2(cs, out)
    if variants:
        torch.cuda.empty_cache()
        time_variants(cs, K, out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": root, "nvidia_smi": smi, "kernels": out}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", default=".")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--worker")
    a = ap.parse_args()
    if a.worker:
        worker(a.worker, a.variants)
        return 0
    rc = 0
    for root in a.roots.split(","):
        same = os.path.abspath(root) == REPO
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root]
        if a.variants and same:
            cmd.append("--variants")
        rc |= subprocess.run(cmd, cwd=REPO).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
