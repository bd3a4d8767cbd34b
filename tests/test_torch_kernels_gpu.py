"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at shapes the chip smoke does not reach: several value windows
(V 100 and 1024), lines with missing edges, deep rings with the `sent`
plane, wide reply buffers, reply logs around the one-block and
two-pass boundary (4096 rows), and quiescence planes of odd lengths
and alignments. The plain version runs on the CPU from the same numpy inputs.
Tolerance: exact (int32 and bool).

The pool-path steps (K11, K12), the PN-counter step (K13, up to 1,500
origins and spill lanes), K5's int32 payload form, the kafka step (K14,
classic and group mode, up to 16 groups of 254 members) and the
batched-broadcast step (K15, from a 1-value table up to a 70,000-value
one whose proof sums wrap and a 300,256-value one, rows at every 16-byte
offset, crafted runs across tiles and on tile and lane edges, fewer runs
than per_nb and none), the fleet's held-lane copy (K32, leaves of 1 to
4,000 bytes a row, 1 to 10,000 lanes, 96 and 97 leaves) and the
device Elle checker's edge build and cycle screen (K16, K17: positions
past both ends of the writer table, cyclic graphs that hit the
iteration cap and acyclic ones that converge earlier, transaction
tables across the prefix max's block and carry-chunk boundaries) too,
and the continuous scan's select and fold (K18, up to 100,000 rows) and
the flight recorder's ring fold (K19: role slices, one or two send
planes, 100,000 clients over an 800,000-row pool, every latency bucket
from 1 to 2^17 rounds and a wrapping latency sum), and the service role
steps (K20-K22: every lane type, repeated and out-of-range keys, cas hits
and misses, merges older and newer than the stored stamp, INT32_MAX
words, wrapping clocks, dirty sets below, at and above G, up to 1,022
replicas, with and without the stall mask), and the compartment's role
steps (K23-K26 with one sequencer; K27-K29 and K26 at the elected learn
packing: every phase-1 lane type, QVAL ballot ties, prepares duplicate
and stale, a query of a slot written the same round, done_bits backlogs
past 8, ballots at the ballot-width limit), and the byzantine
adversary's kernels (K30, K31: every attack, the gate open and closed,
culprits out of range, both round parities; K24 and K28 with the
conviction lanes on: equivocating, stale-ballot and honest assigns, and
the sequencers' steps on E_BYZANTINE NACK lanes).

These tests need a CUDA device and skip without one. They import
nothing of JAX, so they run on a machine without it:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from maelstrom_tpu_torch import kernels as K
from maelstrom_tpu_torch.net import static
from maelstrom_tpu_torch.net.tpu import Msgs
from maelstrom_tpu_torch.nodes import get_program
from maelstrom_tpu_torch.nodes import raft as RAFT
from maelstrom_tpu_torch.runner.tpu_runner import (quiet_probe,
                                                   quiet_probe_plain)
from maelstrom_tpu_torch.sim import (append_replies, append_replies_plain,
                                     compact_replies, empty_reply_log)
from maelstrom_tpu_torch.testing.compartment import \
    random_compartment_inputs
from maelstrom_tpu_torch.tree import leaves, to, tree_map

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def _equal(got, ref):
    if isinstance(got, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _equal(g, r)
        return
    gl, rl = leaves(got), leaves(ref)
    assert [p for p, _ in gl] == [p for p, _ in rl]
    for (p, g), (_q, r) in zip(gl, rl):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy(),
                                      err_msg=p)


def _tensors(d, device):
    return {k: torch.tensor(v, device=device) for k, v in d.items()}


@pytest.mark.parametrize("topo,n,ring,uniform,views",
                         [("grid", 50, 2, True, False),
                          ("line", 9, 3, False, False),
                          ("tree3", 40, 8, False, False),
                          ("line", 33, 5, True, False),
                          ("grid", 50, 2, True, True),
                          ("tree3", 40, 4, False, True)])
@pytest.mark.parametrize("sent", [False, True], ids=["", "sent"])
def test_edge_kernels_match_plain(cuda, topo, n, ring, uniform, views,
                                  sent):
    """`views`: latency and deliver mask come as broadcast views, as the
    round passes them (a scalar or [N, 1, L] latency, an [N, D, 1]
    mask), and the kernel reads them through their strides. `sent`: the
    journaled runs' send-identity plane is tracked."""
    rng = np.random.default_rng(n * ring)
    prog = get_program("broadcast", {"topology": topo, "max_values": 8},
                       [f"n{i}" for i in range(n)], device="cpu")
    D, L = prog.D, 3
    cfg = static.EdgeConfig(n_nodes=n, degree=D, lanes=L, ring=ring,
                            uniform_arrival=uniform)
    shape = (n, D, ring, L)
    ch = {"valid": rng.random(shape) < 0.4,
          **{f: rng.integers(-99, 99, shape, dtype=np.int32)
             for f in ("type", "a", "b", "c")},
          "overwrites": np.int32(3), "lat_clipped": np.int32(1)}
    if sent:
        ch["sent"] = rng.integers(0, 9999, shape, dtype=np.int32)
    out = {"valid": rng.random((n, D, L)) < 0.6,
           **{f: rng.integers(-99, 99, (n, D, L), dtype=np.int32)
              for f in ("type", "a", "b", "c")}}
    lat_shape = ((() if uniform else (n, 1, L)) if views else (n, D, L))
    lat = rng.integers(0, ring + 2, lat_shape, dtype=np.int32)
    mask = rng.random((n, D, 1) if views else (n, D, L)) < 0.8
    rnd = np.int32(rng.integers(0, 40))
    results = []
    for dev in ("cpu", cuda):
        c = static.EdgeChannels(**_tensors(ch, dev))
        c = static.edge_write(cfg, c, static.EdgeMsgs(**_tensors(out, dev)),
                              torch.tensor(rnd, device=dev),
                              torch.tensor(lat, device=dev).expand(n, D, L),
                              torch.tensor(mask, device=dev).expand(n, D, L))
        c, inbox = static.edge_read(cfg, c, prog.neighbors.to(dev),
                                    prog.rev.to(dev),
                                    torch.tensor(rnd + 1, device=dev))
        results.append((c, inbox))
    torch.cuda.synchronize()
    _equal(results[1], results[0])


@pytest.mark.parametrize("V", [32, 100, 1024])
@pytest.mark.parametrize("mode", [{}, {"eager_resend": True},
                                  {"naive_broadcast": True},
                                  {"naive_broadcast": True,
                                   "skip_sender": False}])
@pytest.mark.parametrize("per_nb", [1, 4])
def test_broadcast_step_matches_plain(cuda, V, mode, per_nb):
    rng = np.random.default_rng(V + per_nb)
    nodes = [f"n{i}" for i in range(45)]
    opts = {"topology": "grid", "max_values": V,
            "gossip_per_neighbor": per_nb, **mode}
    progs = {d: get_program("broadcast", opts, nodes, device=d)
             for d in ("cpu", "cuda")}
    p = progs["cpu"]
    N, D, W, L, Kc = p.n_nodes, p.D, p.n_windows, p.edge_cfg.lanes, 4
    state = {"seen": rng.random((N, V)) < 0.3,
             "owed": rng.random((N, D, W)) < 0.3,
             **{k: rng.random((N, D, V)) < 0.2
                for k in ("pending", "inflight", "inflight_old")}}
    etype = rng.choice(np.array([14, 14, 15, 0], np.int32), (N, D, L))
    edge_in = {"valid": rng.random((N, D, L)) < 0.6, "type": etype,
               "a": np.where(etype == 15, rng.integers(0, W + 1, (N, D, L)),
                             rng.integers(-2, V + 3, (N, D, L))
                             ).astype(np.int32),
               **{f: rng.integers(-2**31, 2**31, (N, D, L), dtype=np.int64
                                  ).astype(np.int32) for f in ("b", "c")}}
    client = {"valid": rng.random((N, Kc)) < 0.5,
              "type": rng.choice(np.array([10, 12, 0], np.int32), (N, Kc)),
              "a": rng.integers(-1, V + 2, (N, Kc), dtype=np.int32),
              **{f: rng.integers(-5, 999, (N, Kc), dtype=np.int32)
                 for f in ("src", "dest", "due", "mid", "reply_to", "b",
                           "c")}}
    for rnd in (p.retry_rounds * 2, p.retry_rounds * 2 + 3):
        out = {}
        for d, prog in progs.items():
            out[d] = prog.edge_step(
                _tensors(state, d),
                static.EdgeMsgs(**_tensors(edge_in, d)),
                Msgs(**_tensors(client, d)),
                {"round": torch.tensor(rnd, dtype=torch.int32, device=d)})
        torch.cuda.synchronize()
        for g, r in zip(out["cuda"], out["cpu"]):
            _equal(g, r)


@pytest.mark.parametrize("NK,K_,CC,p_valid",
                         [(400, 4, 2, 0.01), (400, 4, 64, 0.05),
                          (5000, 5, 3000, 0.5), (3000, 3, 10, 0.0),
                          (64, 4, 100, 0.9)])
def test_reply_compact_matches_plain(cuda, NK, K_, CC, p_valid):
    rng = np.random.default_rng(NK + CC)
    flat = {"valid": rng.random(NK) < p_valid,
            **{f: rng.integers(-9, 999, NK, dtype=np.int32)
               for f in ("src", "dest", "due", "mid", "reply_to", "type",
                         "a", "b", "c")}}
    res = {d: compact_replies(Msgs(**_tensors(flat, d)), K_, CC,
                              torch.tensor(77, dtype=torch.int32, device=d))
           for d in ("cpu", cuda)}
    torch.cuda.synchronize()
    for g, r in zip(res[cuda], res["cpu"]):
        _equal(g, r)


def test_kernels_launch_on_cuda_tensors(cuda):
    before = K.launch_counts()
    flat = tree_map(lambda f: f.reshape(-1), Msgs.empty((8, 4), "cpu"))
    compact_replies(to(flat, cuda), 4, 2,
                    torch.tensor(0, dtype=torch.int32, device=cuda))
    assert K.launch_counts()["reply_compact"] == \
        before["reply_compact"] + 1


@pytest.mark.parametrize("CW,rcap,rn0,W,V,p_valid,stop",
                         [(37, 80, 0, 2, 50, 0.3, True),
                          (4096, 8192, 5000, 4, 100, 0.5, False),
                          (4097, 8194, 0, 0, 0, 0.5, False),
                          (20000, 40000, 39000, 32, 1024, 0.2, False),
                          (9000, 18000, 0, 0, 0, 0.01, True)])
def test_reply_log_append_matches_plain(cuda, CW, rcap, rn0, W, V,
                                        p_valid, stop):
    """rn0 near rcap drops the rows past the log's end; W 0: a program
    without a reply payload."""
    rng = np.random.default_rng(CW + rn0)
    n = 77
    cm = {"valid": rng.random(CW) < p_valid,
          **{f: rng.integers(-9, 999, CW, dtype=np.int32)
             for f in ("src", "dest", "due", "mid", "reply_to", "type",
                       "a", "b", "c")}}
    seen = rng.random((n, V)) < 0.5
    res = []
    for d, fn in (("cpu", append_replies_plain), (cuda, append_replies)):
        log = empty_reply_log(rcap, W, d)[:3] + (
            torch.tensor(rn0, dtype=torch.int32, device=d),)
        ek = torch.full((), 2**31 - 1, dtype=torch.int32, device=d)
        rn = fn(log, Msgs(**_tensors(cm, d)),
                torch.tensor(seen, device=d) if W else None, n,
                torch.tensor(321, dtype=torch.int32, device=d), 4, 6, stop,
                ek)
        res.append((log[:3], rn, ek))
    torch.cuda.synchronize()
    _equal(res[1], res[0])


@pytest.mark.parametrize("sizes,offset", [([1], 0), ([17, 33, 5000], 3),
                                          ([1 << 20, 15, 64], 1)])
def test_quiet_probe_matches_plain(cuda, sizes, offset):
    """Planes of odd lengths, some starting off a 16-byte boundary; one
    set byte at each plane's head, middle and tail in turn."""
    planes = [torch.zeros(n + offset, dtype=torch.bool,
                          device=cuda)[offset:] for n in sizes]
    assert bool(quiet_probe(planes)) and bool(quiet_probe_plain(planes))
    for p in planes:
        for at in (0, p.numel() // 2, p.numel() - 1):
            p[at] = True
            assert not bool(quiet_probe(planes))
            assert bool(quiet_probe(planes)) == bool(
                quiet_probe_plain(planes))
            p[at] = False


# --- the fault slice: K7 threefry, K8 edge_faults, K9 edge_write_spill and
# K3 with the stall mask ---------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 4097, 70_001])
def test_threefry_matches_plain(cuda, n):
    from maelstrom_tpu_torch import prng
    for seed in (0, 23, 2**31 - 1):
        keys = {d: prng.PRNGKey(seed, d) for d in ("cpu", cuda)}
        out = {}
        for d, key in keys.items():
            scale = torch.tensor(1.5, device=d)
            p = torch.tensor(0.3, device=d)
            out[d] = (prng.split(key, 7), prng.split(key, 3, base=n),
                      prng.random_bits(key, (n,)), prng.uniform(key, (n,)),
                      prng.bernoulli_below(key, (n,), p),
                      prng.latency_rounds(key, (n,), "uniform", 5.0, scale),
                      prng.latency_rounds(key, (n,), "exponential", 3.0,
                                          scale),
                      prng.randint(key, (n,), -3, 1000))
        torch.cuda.synchronize()
        for g, r in zip(out[cuda], out["cpu"]):
            np.testing.assert_array_equal(g.cpu().numpy(), r.numpy())


@pytest.mark.parametrize("dist,flags,atomic", [
    ("constant", {}, False),
    ("uniform", {"partition_groups": 33, "enable_stall": True}, False),
    ("exponential", {"enable_duplication": True, "enable_stall": True},
     False),
    ("uniform", {"enable_duplication": True, "partition_groups": 33},
     True),
    ("constant", {"enable_duplication": True}, False)])
def test_edge_faults_matches_plain(cuda, dist, flags, atomic):
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch import sim as S
    from maelstrom_tpu_torch.net import tpu as T
    rng = np.random.default_rng(len(dist) + len(flags))
    nodes = [f"n{i}" for i in range(33)]
    prog = get_program("broadcast", {"topology": "line",
                                     "max_values": 16}, nodes, device="cpu")
    N, D, L = prog.n_nodes, prog.D, 5
    cfg = T.NetConfig(n_nodes=N, n_clients=2, latency_mean_rounds=4.0,
                      latency_dist=dist, **flags)
    valid = rng.random((N, D, L)) < 0.7
    out = {}
    for d in ("cpu", cuda):
        net = T.make_net(cfg, d)
        net = T.flaky(T.set_duplication(net, 0.4), 0.2)
        net = T.set_latency_scale(net, 1.25)
        net = T.partition_components(net, np.arange(N) % 2 * (N > 20))
        if cfg.partition_groups > 1:
            net = T.partition_grudge(net, np.arange(N, dtype=np.int32),
                                     rng.random((N, N)) < 0.3)
        if cfg.enable_stall:
            net = T.set_down(T.set_paused(net, np.arange(N) % 7 == 1),
                             np.arange(N) % 5 == 2)
        keys = prng.split(prng.PRNGKey(5, d),
                          7 if cfg.enable_duplication else 5)
        out[d] = S.edge_faults(cfg, prog.neighbors.to(d), net,
                               torch.tensor(valid, device=d), keys, atomic)
    torch.cuda.synchronize()
    _equal(out[cuda], out["cpu"])


@pytest.mark.parametrize("ring,Lc,Lo,sent", [(6, 6, 3, False),
                                             (12, 4, 3, True),
                                             (404, 10, 5, True)])
def test_edge_write_spill_matches_plain(cuda, ring, Lc, Lo, sent):
    rng = np.random.default_rng(ring + Lc)
    nodes = [f"n{i}" for i in range(30)]
    prog = get_program("broadcast", {"topology": "grid"}, nodes,
                       device="cpu")
    N, D = prog.n_nodes, prog.D
    cfg = static.EdgeConfig(n_nodes=N, degree=D, lanes=Lc, ring=ring,
                            spill=True)
    shape = (N, D, ring, Lc)
    occ = rng.integers(0, Lc + 1, (N, D, ring, 1))
    ch = {"valid": np.arange(Lc)[None, None, None, :] < occ,
          **{f: rng.integers(-50, 50, shape, dtype=np.int32)
             for f in ("type", "a", "b", "c")},
          "overwrites": np.int32(2), "lat_clipped": np.int32(0)}
    if sent:
        ch["sent"] = rng.integers(0, 5000, shape, dtype=np.int32)
    out = {"valid": rng.random((N, D, Lo)) < 0.7,
           **{f: rng.integers(-999, 999, (N, D, Lo), dtype=np.int32)
              for f in ("type", "a", "b", "c")}}
    lat = rng.integers(0, min(ring, 8) + 2, (N, D, Lo), dtype=np.int32)
    mask = rng.random((N, D, 1)) < 0.8
    res = {}
    for d in ("cpu", cuda):
        c = static.EdgeChannels(**_tensors(ch, d))
        res[d] = static.edge_write(
            cfg, c, static.EdgeMsgs(**_tensors(out, d)),
            torch.tensor(77, dtype=torch.int32, device=d),
            torch.tensor(lat, device=d), torch.tensor(mask, device=d))
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])


@pytest.mark.parametrize("V", [32, 1024])
@pytest.mark.parametrize("mode", [{}, {"eager_resend": True},
                                  {"naive_broadcast": True}])
def test_broadcast_step_with_stall_matches_plain(cuda, V, mode):
    rng = np.random.default_rng(V + len(mode))
    nodes = [f"n{i}" for i in range(45)]
    opts = {"topology": "grid", "max_values": V, **mode}
    progs = {d: get_program("broadcast", opts, nodes, device=d)
             for d in ("cpu", "cuda")}
    p = progs["cpu"]
    N, D, W, L, Kc = p.n_nodes, p.D, p.n_windows, p.edge_cfg.lanes, 4
    state = {"seen": rng.random((N, V)) < 0.3,
             "owed": rng.random((N, D, W)) < 0.3,
             **{k: rng.random((N, D, V)) < 0.2
                for k in ("pending", "inflight", "inflight_old")}}
    edge_in = {"valid": rng.random((N, D, L)) < 0.6,
               "type": rng.choice(np.array([14, 15, 0], np.int32),
                                  (N, D, L)),
               "a": rng.integers(0, min(V, W + 1), (N, D, L),
                                 dtype=np.int32),
               **{f: rng.integers(-2**31, 2**31, (N, D, L), dtype=np.int64
                                  ).astype(np.int32) for f in ("b", "c")}}
    client = {"valid": rng.random((N, Kc)) < 0.5,
              "type": rng.choice(np.array([10, 12, 0], np.int32), (N, Kc)),
              "a": rng.integers(0, V, (N, Kc), dtype=np.int32),
              **{f: rng.integers(-5, 999, (N, Kc), dtype=np.int32)
                 for f in ("src", "dest", "due", "mid", "reply_to", "b",
                           "c")}}
    stall = rng.random(N) < 0.4
    before = K.launch_counts()["broadcast_step_stall"]
    out = {}
    for d, prog in progs.items():
        out[d] = prog.edge_step(
            _tensors(state, d), static.EdgeMsgs(**_tensors(edge_in, d)),
            Msgs(**_tensors(client, d)),
            {"round": torch.tensor(p.retry_rounds * 2, dtype=torch.int32,
                                   device=d),
             "stall": torch.tensor(stall, device=d)})
    torch.cuda.synchronize()
    assert K.launch_counts()["broadcast_step_stall"] == before + 1
    for g, r in zip(out["cuda"], out["cpu"]):
        _equal(g, r)


# --- the Raft slice: K10 raft_step, K7 on batched keys, K4 on batched
# segments, K2's per-cluster counters ---------------------------------------

def _entry_a(rng, shape, terms, keys):
    return ((rng.integers(0, terms, shape) << 16)
            | (rng.integers(0, keys + 3, shape) << 4)
            | rng.integers(0, 5, shape)).astype(np.int32)


def _entry_b(rng, shape):
    return ((rng.integers(0, 6, shape) << 16)
            | (rng.integers(0, 7, shape) << 8)
            | rng.integers(0, 7, shape)).astype(np.int32)


def random_raft_inputs(rng, prog, lead=(), rnd=40):
    """Random state, lanes and client slots for a program's step, every
    leaf with the leading axes `lead` (() for one cluster, (F,) for a
    batch) and then the node axis. Values stay in the ranges a run
    reaches (terms and indices small, logs of packed entries) with
    out-of-range corners mixed in, so every branch of the step fires."""
    N, D, C, E, KEYS = prog.n_nodes, prog.D, prog.cap, prog.E, prog.keys
    L, K = prog.lanes, prog.inbox_cap
    s = tuple(lead) + (N,)
    T = 6

    def ints(lo, hi, shape=()):
        return rng.integers(lo, hi, s + tuple(shape)).astype(np.int32)
    log_len = ints(0, C + 1)
    commit = np.minimum(ints(-1, C), log_len - 1)
    state = {
        "role": ints(0, 3), "term": ints(0, T),
        "voted_for": ints(-1, N), "votes": rng.random(s + (N,)) < 0.4,
        "log_a": _entry_a(rng, s + (C,), T, KEYS),
        "log_b": _entry_b(rng, s + (C,)),
        "log_c": ints(0, 1000, (C,)), "log_len": log_len,
        "commit": commit,
        "applied": np.maximum(commit - ints(0, 6), -1).astype(np.int32),
        "next": ints(0, C + 1, (D,)), "match": ints(-1, C, (D,)),
        "kv": ints(0, 7, (KEYS,)),
        "deadline": (rnd + ints(-6, 30)).astype(np.int32),
        "leader_hint": ints(-1, D), "log_overflow": ints(0, 3)}

    e = s + (D, L)
    lane_types = np.array([[RAFT.T_RV, RAFT.T_AE, 0], [RAFT.T_RV_REPLY,
                                                 RAFT.T_AE_REPLY, 0],
                           [RAFT.T_PROXY, RAFT.T_PROXY, 0]], np.int32)
    typ = np.full(e, RAFT.T_ENTRY, np.int32)
    for j in range(3):
        typ[..., j] = lane_types[j][rng.integers(0, 3, s + (D,))]
    typ[..., 3:] = np.where(rng.random(s + (D, E)) < 0.9, RAFT.T_ENTRY, 0)
    a = np.empty(e, np.int32)
    b = np.empty(e, np.int32)
    c = np.empty(e, np.int32)
    term = state["term"][..., None]
    drift = np.array([-1, 0, 0, 0, 1])       # mostly the current term
    a[..., 0] = term + drift[rng.integers(0, 5, s + (D,))]
    a[..., 1] = term + drift[rng.integers(0, 5, s + (D,))]
    prev = rng.integers(-1, C + 2, s + (D,))
    b[..., 0] = np.where(typ[..., 0] == RAFT.T_AE,
                         ((prev + 1) << 16) | rng.integers(0, T, s + (D,)),
                         rng.integers(-1, C + 1, s + (D,)))
    c[..., 0] = np.where(typ[..., 0] == RAFT.T_AE,
                         (rng.integers(-1, C, s + (D,)) + 1 << 4)
                         | rng.integers(0, E + 2, s + (D,)),
                         rng.integers(0, T, s + (D,)))
    b[..., 1] = rng.integers(0, 2, s + (D,))
    c[..., 1] = rng.integers(-2, C + 1, s + (D,))
    a[..., 2] = (rng.integers(0, KEYS + 3, s + (D,)) << 4) | rng.integers(
        0, 5, s + (D,))
    b[..., 2] = _entry_b(rng, s + (D,))
    c[..., 2] = rng.integers(0, 1000, s + (D,))
    a[..., 3:] = _entry_a(rng, s + (D, E), T, KEYS)
    b[..., 3:] = _entry_b(rng, s + (D, E))
    c[..., 3:] = rng.integers(0, 1000, s + (D, E))
    edge_in = {"valid": rng.random(e) < 0.6, "type": typ, "a": a, "b": b,
               "c": c}

    k = s + (K,)
    client_in = {
        "valid": rng.random(k) < 0.5,
        "src": (N + rng.integers(0, 6, k)).astype(np.int32),
        "dest": rng.integers(0, N, k).astype(np.int32),
        "due": rng.integers(0, 99, k).astype(np.int32),
        "mid": rng.integers(0, 9999, k).astype(np.int32),
        "reply_to": np.full(k, -1, np.int32),
        "type": np.array([RAFT.T_READ, RAFT.T_WRITE, RAFT.T_CAS, RAFT.T_TXN, 0],
                         np.int32)[rng.integers(0, 5, k)],
        "a": rng.integers(-1, KEYS + 2, k).astype(np.int32),
        "b": rng.integers(0, 5, k).astype(np.int32),
        "c": rng.integers(0, 5, k).astype(np.int32)}
    return state, edge_in, client_in



# --- the pool-path steps (K11, K12), the PN-counter step (K13) and K5's
# int32 payload form -------------------------------------------------------

def random_pool_inbox(rng, n, K, req, p_valid=0.6):
    """An [n, K] inbox as numpy fields: requests of type `req` and other
    type codes, random words in every field."""
    shape = (n, K)
    return {"valid": rng.random(shape) < p_valid,
            "src": rng.integers(0, n + 4, shape, dtype=np.int32),
            "dest": rng.integers(0, n, shape, dtype=np.int32),
            "due": rng.integers(0, 50, shape, dtype=np.int32),
            "mid": rng.integers(0, 1000, shape, dtype=np.int32),
            "reply_to": rng.integers(-1, 1000, shape, dtype=np.int32),
            "type": np.where(rng.random(shape) < 0.7, req,
                             rng.integers(0, 20, shape)).astype(np.int32),
            "a": rng.integers(-99, 99, shape, dtype=np.int32),
            "b": rng.integers(-99, 99, shape, dtype=np.int32),
            "c": rng.integers(-99, 99, shape, dtype=np.int32)}


def random_pn_inputs(rng, prog):
    """(state, edge_in, client_in) as numpy fields for a PN-counter step:
    contributions up to 40 (some near the int32 limit on the own
    origin), pending bits dense on some edges and absent or sparse on
    others (fewer pending origins than out lanes), entry lanes with
    origins past both ends (clipped), counts below -1 (the "no entry"
    sentinel), and adds with extreme deltas (the int32 sums wrap)."""
    N, D, M = prog.n_nodes, prog.D, prog.M
    L = prog.edge_cfg.lanes
    K = prog.inbox_cap
    dens = rng.choice(np.array([0.0, 0.002, 0.3]), (N, D, 1))
    pos = rng.integers(0, 40, (N, M), dtype=np.int32)
    pos[np.arange(min(N, 3)), np.arange(min(N, 3))] = 2**31 - 3
    state = {"pos": pos,
             "neg": rng.integers(0, 40, (N, M), dtype=np.int32),
             "pending": rng.random((N, D, M)) < dens,
             "synced": rng.random((N, D, M)) < 0.5}
    edge_in = {"valid": rng.random((N, D, L)) < 0.7,
               "type": rng.choice(np.array([14, 14, 14, 0], np.int32),
                                  (N, D, L)),
               "a": rng.integers(-2, M + 2, (N, D, L), dtype=np.int32),
               "b": rng.integers(-3, 45, (N, D, L), dtype=np.int32),
               "c": rng.integers(-3, 45, (N, D, L), dtype=np.int32)}
    ctype = rng.choice(np.array([10, 10, 12, 0], np.int32), (N, K))
    ca = rng.integers(-5, 5, (N, K), dtype=np.int32)
    ca[0, :2] = [-2**31, 2**31 - 1]
    client_in = {"valid": rng.random((N, K)) < 0.5, "type": ctype, "a": ca}
    for f in ("src", "dest", "due", "mid", "reply_to", "b", "c"):
        client_in[f] = rng.integers(-5, 1000, (N, K), dtype=np.int32)
    return state, edge_in, client_in


def _pn_program(n, fanout, device="cpu", **opts):
    return get_program("pn-counter", {"gossip_fanout": fanout, **opts},
                       [f"n{i}" for i in range(n)], device=device)


@pytest.mark.parametrize("prog", ["echo", "unique-ids"])
@pytest.mark.parametrize("n,p_valid", [(1, 0.6), (33, 0.6), (5000, 0.5),
                                       (100_000, 0.01)])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_pool_steps_match_plain(cuda, prog, n, p_valid, stalled):
    """K11 echo_step and K12 unique_ids_step, with and without the stall
    mask, counters near the int32 limit included."""
    rng = np.random.default_rng(n + stalled)
    progs = {d: get_program(prog, {}, [f"n{i}" for i in range(n)],
                            device=d) for d in ("cpu", cuda)}
    inbox = random_pool_inbox(rng, n, 8, 10, p_valid)
    key = "rounds" if prog == "echo" else "counter"
    counter = rng.integers(0, 1000, n).astype(np.int32)
    counter[:2] = 2**31 - 1
    stall = rng.random(n) < 0.3
    out = {}
    for d in ("cpu", cuda):
        ctx = {"round": torch.tensor(5, dtype=torch.int32, device=d)}
        if stalled:
            ctx["stall"] = torch.tensor(stall, device=d)
        out[d] = progs[d].step({key: torch.tensor(counter, device=d)},
                               Msgs(**_tensors(inbox, d)), ctx)
    _equal(out[cuda], out["cpu"])


@pytest.mark.parametrize("n,fanout,opts", [
    (5, None, {}), (64, 3, {}), (1000, 3, {}),
    (64, 3, {"latency": {"mean": 3, "dist": "uniform"}}),
    (1500, 2, {"gossip_per_neighbor": 3})])
@pytest.mark.parametrize("rnd", [40, 0])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_pn_counter_step_matches_plain(cuda, n, fanout, opts, rnd, stalled):
    """K13 against its plain version on every output field, invalid lanes
    included: the total graph at 5 nodes, fanout graphs at 64 and 1,000
    nodes, spill lanes (8 channel lanes) under uniform latency, and
    1,500 origins (more than a block's threads); round 0 is a retry
    round."""
    progs = {d: _pn_program(n, fanout, device=d, **opts)
             for d in ("cpu", cuda)}
    rng = np.random.default_rng(n + rnd + stalled)
    state, edge_in, client_in = random_pn_inputs(rng, progs["cpu"])
    stall = rng.random(n) < 0.3
    out = {}
    for d in ("cpu", cuda):
        ctx = {"round": torch.tensor(rnd, dtype=torch.int32, device=d)}
        if stalled:
            ctx["stall"] = torch.tensor(stall, device=d)
        out[d] = progs[d].edge_step(
            _tensors(state, d), static.EdgeMsgs(**_tensors(edge_in, d)),
            Msgs(**_tensors(client_in, d)), ctx)
    _equal(out[cuda], out["cpu"])


@pytest.mark.parametrize("CW,rcap,rn0,W,p_valid",
                         [(16, 64, 3, 1, 0.5), (4096, 8192, 0, 1, 0.3),
                          (5000, 2048, 100, 3, 0.4)])
def test_reply_log_append_i32_matches_plain(cuda, CW, rcap, rn0, W,
                                            p_valid):
    """K5's int32 form: each valid row's payload is the [N, W] int32 row
    of its clipped source node."""
    rng = np.random.default_rng(CW + W)
    N = 37
    cm = {"valid": rng.random(CW) < p_valid,
          "src": rng.integers(-3, N + 3, CW, dtype=np.int32)}
    for f in ("dest", "due", "mid", "reply_to", "type", "a", "b", "c"):
        cm[f] = rng.integers(-5, 99, CW, dtype=np.int32)
    rows = rng.integers(-2**31, 2**31, (N, W), dtype=np.int64).astype(
        np.int32)
    out = {}
    for d in ("cpu", cuda):
        log = empty_reply_log(rcap, W, d)
        log = log[:3] + (torch.tensor(rn0, dtype=torch.int32, device=d),)
        exit_k = torch.tensor(2**31 - 1, dtype=torch.int32, device=d)
        rn = append_replies(log, Msgs(**_tensors(cm, d)),
                            torch.tensor(rows, device=d), N,
                            torch.tensor(9, dtype=torch.int32, device=d),
                            3, 7, False, exit_k)
        out[d] = (log[0], log[1], log[2], rn, exit_k)
    _equal(out[cuda], out["cpu"])
    assert K.REPLY_LOG_APPEND_I32.launches > 0


def _raft_program(n, **opts):
    return get_program("lin-kv", {"latency": {"mean": 0}, **opts},
                       [f"n{i}" for i in range(n)], device="cpu")


def _raft_to(prog, device):
    """The program's tables on `device` (the step reads the neighbours)."""
    import copy
    p = copy.copy(prog)
    p.device = torch.device(device)
    p.neighbors, p.rev = prog.neighbors.to(device), prog.rev.to(device)
    return p


@pytest.mark.parametrize("n,C,keys,K_,F", [(5, 256, 256, 4, 1000),
                                          (3, 37, 16, 3, 1),
                                          (7, 100, 40, 6, 17),
                                          (5, 33, 8, 4, 1)])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_raft_step_matches_plain(cuda, n, C, keys, K_, F, stalled):
    """K10 at odd shapes: clusters of 3, 5 and 7 nodes, logs not a
    multiple of 32 long, one cluster and many, with and without the
    stall mask; the plain version on the CPU from the same inputs."""
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch.net.static import EdgeMsgs
    prog = _raft_program(n, log_cap=C, kv_keys=keys, inbox_cap=K_)
    rng = np.random.default_rng(n * C + F + stalled)
    state, edge_in, client_in = random_raft_inputs(rng, prog, lead=(F,))
    rnd = rng.integers(30, 60, F).astype(np.int32)
    stall = rng.random(F * n) < 0.3 if stalled else None
    res = {}
    for d in ("cpu", cuda):
        p = _raft_to(prog, d)
        keys_d = prng.split(prng.PRNGKey(F + n, d), F)

        def rows(t):
            t = torch.tensor(t, device=d)
            return t.reshape((F * n,) + tuple(t.shape[2:]))
        res[d] = p.step_rows(
            {k: rows(v) for k, v in state.items()},
            EdgeMsgs(**{k: rows(v) for k, v in edge_in.items()}),
            Msgs(**{k: rows(v) for k, v in client_in.items()}),
            torch.tensor(rnd, device=d), keys_d,
            None if stall is None else torch.tensor(stall, device=d))
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])


@pytest.mark.parametrize("F,n", [(1, 5), (7, 3), (10_000, 5)])
def test_threefry_batched_keys_matches_plain(cuda, F, n):
    from maelstrom_tpu_torch import prng
    out = {}
    for d in ("cpu", cuda):
        keys = prng.split(prng.PRNGKey(F, d), F)
        out[d] = (prng.split(keys, n), prng.split(keys, 1, base=17),
                  prng.random_bits(keys, (n,)),
                  prng.randint(keys, (n,), 0, 24))
    torch.cuda.synchronize()
    for g, r in zip(out[cuda], out["cpu"]):
        np.testing.assert_array_equal(g.cpu().numpy(), r.numpy())


@pytest.mark.parametrize("F,NK,K_,CC,p_valid",
                         [(10_000, 20, 4, 4, 0.1), (3, 10_000, 5, 5000, 0.4),
                          (5, 9000, 3, 7, 0.001), (2, 4096, 4, 4096, 0.5),
                          (1, 20, 4, 10, 0.3)])
def test_reply_compact_batched_matches_plain(cuda, F, NK, K_, CC, p_valid):
    """K4 with one segment a cluster (or several, past 4096 rows)."""
    rng = np.random.default_rng(F + NK)
    flat = {"valid": rng.random((F, NK)) < p_valid,
            **{f: rng.integers(-9, 999, (F, NK), dtype=np.int32)
               for f in ("src", "dest", "due", "mid", "reply_to", "type",
                         "a", "b", "c")}}
    nm = rng.integers(0, 1 << 20, F, dtype=np.int32)
    res = {d: compact_replies(Msgs(**_tensors(flat, d)), K_, CC,
                              torch.tensor(nm, device=d))
           for d in ("cpu", cuda)}
    torch.cuda.synchronize()
    for g, r in zip(res[cuda], res["cpu"]):
        _equal(g, r)


def test_edge_write_per_cluster_counters_match_plain(cuda):
    """K2 on F clusters' rows with [F] counters: each overwrite and
    clipped draw lands on its cluster's counter."""
    F, n, D, ring, L = 40, 5, 4, 3, 7
    rng = np.random.default_rng(3)
    cfg = static.EdgeConfig(n_nodes=F * n, degree=D, lanes=L, ring=ring)
    shape = (F * n, D, ring, L)
    ch = {"valid": rng.random(shape) < 0.5,
          **{f: rng.integers(-99, 99, shape, dtype=np.int32)
             for f in ("type", "a", "b", "c")}}
    out = {"valid": rng.random((F * n, D, L)) < 0.6,
           **{f: rng.integers(-99, 99, (F * n, D, L), dtype=np.int32)
              for f in ("type", "a", "b", "c")}}
    lat = rng.integers(0, 5, (F * n, D, 1), dtype=np.int32)
    res = {}
    for d in ("cpu", cuda):
        c = static.EdgeChannels(**_tensors(ch, d),
                                overwrites=torch.zeros(F, dtype=torch.int32,
                                                       device=d),
                                lat_clipped=torch.zeros(F, dtype=torch.int32,
                                                        device=d))
        res[d] = static.edge_write(
            cfg, c, static.EdgeMsgs(**_tensors(out, d)),
            torch.tensor(11, dtype=torch.int32, device=d),
            torch.tensor(lat, device=d),
            torch.ones((), dtype=torch.bool, device=d).expand(F * n, D, L))
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])
    assert int(res["cpu"].overwrites.sum()) > 0
    assert int(res["cpu"].lat_clipped.sum()) > 0


def test_raft_cluster_round_matches_plain(cuda):
    """The cluster round through the kernels on the card against the
    plain versions on the CPU: 120 rounds of 50 clusters with client
    requests through the per-cluster pools."""
    from maelstrom_tpu_torch import parallel as PP
    from maelstrom_tpu_torch.net import tpu as T
    F, R = 50, 120
    rng = np.random.default_rng(8)
    plan = [None if r % 4 or r < 30 else {
        "valid": np.ones((F, 1), bool),
        "src": np.full((F, 1), 5, np.int32),
        "dest": rng.integers(0, 5, (F, 1), dtype=np.int32),
        "type": rng.choice(np.array([10, 12, 14], np.int32), (F, 1)),
        "a": rng.integers(0, 4, (F, 1), dtype=np.int32),
        "b": rng.integers(0, 5, (F, 1), dtype=np.int32),
        "c": rng.integers(0, 5, (F, 1), dtype=np.int32),
        "mid": np.full((F, 1), r, np.int32)} for r in range(R)]
    res = {}
    for d in ("cpu", cuda):
        prog = get_program("lin-kv", {"latency": {"mean": 0}},
                           [f"n{i}" for i in range(5)], device=d)
        cfg = T.NetConfig(n_nodes=5, n_clients=1, pool_cap=64,
                          inbox_cap=prog.inbox_cap, client_cap=4)
        fn = PP.make_cluster_round_fn(prog, cfg, device=d)
        sims = PP.make_cluster_sims(prog, cfg, F, seed=4, device=d)
        empty = Msgs.empty((F, 1), d)
        for rows in plan:
            sims = fn(sims, empty if rows is None
                      else PP.injection_msgs(rows, d))[0]
        res[d] = sims
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])


def random_kafka_inputs(rng, prog, rnd):
    """(state, edge_in, client_in) as numpy fields for a kafka step:
    logs full on some keys and empty on others, offers at, below and
    above the receiver's length (duplicates on several edges), stray
    lane types, committed marks below the -1 of "none"; sends with keys
    past both ends and to other owners, packed commits and lists, and in
    group mode subscribes, fetches with cursors past the log, banked
    commits whose generation matches half the time (the rest fenced),
    lists of both banks, and members whose heartbeat is past the
    session timeout."""
    N, Kk, C, D, G, M = prog.n_nodes, prog.K, prog.cap, prog.D, prog.G, \
        prog.M
    A = prog.inbox_cap

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64)
    log_len = ints(0, C + 1, (N, Kk))
    log_len[rng.random((N, Kk)) < 0.15] = C
    log_len[rng.random((N, Kk)) < 0.15] = 0
    state = {"log": ints(0, 1000, (N, Kk, C)), "log_len": log_len,
             "peer_len": ints(-1, C + 2, (N, D, Kk)),
             "committed": ints(-3, 40, (N, Kk)),
             "log_overflow": ints(0, 3, N)}
    if G:
        state["gactive"] = rng.random((N, G, M)) < 0.5
        state["gseen"] = rnd - ints(0, 2 * prog.session_rounds + 2,
                                    (N, G, M))
        state["ggen"] = ints(0, 70_000, (N, G))
        state["gcommitted"] = ints(-3, 40, (N, G, Kk))
    ll = log_len[:, None, :]
    edge_in = {"valid": rng.random((N, D, Kk)) < 0.7,
               "type": np.where(rng.random((N, D, Kk)) < 0.85, 20,
                                ints(0, 40, (N, D, Kk))),
               "a": ll + ints(-2, 4, (N, D, Kk)),
               "b": ll + ints(-2, 3, (N, D, Kk)),
               "c": ints(0, 1000, (N, D, Kk))}
    types = np.array([10, 12, 14, 16, 30, 32, 34, 37, 0, 99])
    ty = types[ints(0, len(types), (N, A))]
    a, b, c = (ints(-2**31, 2**31 - 1, (N, A)) for _ in range(3))

    def packed():
        return ints(0, 40, (N, A)) | (ints(0, 40, (N, A)) << 16)
    send = ty == 10
    a = np.where(send, ints(-1, Kk + 1, (N, A)), a)
    b = np.where(send, ints(0, 1000, (N, A)), b)
    cm = ty == 14
    a, b, c = (np.where(cm, packed(), w) for w in (a, b, c))
    if G:
        g = ints(0, G + 1, (N, A))
        m = ints(0, M + 1, (N, A))
        a = np.where((ty == 30) | (ty == 32), (g << 10) | m, a)
        fetch = ty == 32
        b = np.where(fetch, (ints(-1, Kk + 1, (N, A)) << 16)
                     | ints(0, C + 3, (N, A)), b)
        c = np.where(fetch, ints(-2, 12, (N, A)), c)
        gen = state["ggen"][np.arange(N)[:, None], np.minimum(g, G - 1)]
        gen = np.where(rng.random((N, A)) < 0.6, gen & 0xFFFF,
                       ints(0, 0xFFFF, (N, A)))
        bank = ints(0, 2, (N, A))
        gc = ty == 34
        a = np.where(gc, (bank << 30) | (np.minimum(g, 15) << 26)
                     | (np.minimum(m, 1023) << 16) | gen, a)
        b, c = (np.where(gc, packed(), w) for w in (b, c))
        a = np.where(ty == 37, (bank << 30) | g, a)

    def i32(x):
        return (((np.asarray(x, np.int64) + 2**31) % 2**32)
                - 2**31).astype(np.int32)
    state = {k: v if v.dtype == bool else i32(v) for k, v in state.items()}
    edge_in = {k: v if v.dtype == bool else i32(v)
               for k, v in edge_in.items()}
    client_in = {"valid": rng.random((N, A)) < 0.6,
                 "src": i32(ints(N, 2 * N, (N, A))),
                 "dest": i32(np.tile(np.arange(N)[:, None], (1, A))),
                 "due": i32(ints(0, 99, (N, A))),
                 "mid": i32(ints(0, 1 << 30, (N, A))),
                 "reply_to": np.full((N, A), -1, np.int32),
                 "type": i32(ty), "a": i32(a), "b": i32(b), "c": i32(c)}
    return state, edge_in, client_in


def _kafka_program(n, device="cpu", **opts):
    return get_program("kafka", opts, [f"n{i}" for i in range(n)],
                       device=device)


# "fuzz-groups" is 5 nodes in 2 groups (the kafka5-groups2 run's node and
# group counts); the kafka fuzz itself runs classic
KAFKA_SHAPES = {
    "5b": (2, {"key_count": 4, "rate": 1000.0, "time_limit": 5.0}),
    "fuzz-groups": (5, {"kafka_groups": 2}),
    "classic6": (7, {"key_count": 6, "log_cap": 50}),
    "wide-groups": (9, {"key_count": 8, "kafka_groups": 16,
                        "concurrency": 254, "log_cap": 40,
                        "session_timeout_ms": 30.0}),
    "odd-groups": (5, {"key_count": 5, "kafka_groups": 3,
                       "concurrency": 40, "log_cap": 30,
                       "inbox_cap": 7}),
}


@pytest.mark.parametrize("shape", list(KAFKA_SHAPES))
@pytest.mark.parametrize("rnd", [64, 37, 0])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_kafka_step_matches_plain(cuda, shape, rnd, stalled):
    """K14 against its plain version on every output field: classic at
    the 5b shape and with 6 keys, group mode with 2, 3 and 16 groups and
    up to 254 members, 7 inbox slots; round 64 and 0 are beat rounds."""
    n, opts = KAFKA_SHAPES[shape]
    progs = {d: _kafka_program(n, device=d, **opts) for d in ("cpu", cuda)}
    rng = np.random.default_rng(n + rnd + stalled)
    state, edge_in, client_in = random_kafka_inputs(rng, progs["cpu"],
                                                    rnd)
    stall = rng.random(n) < 0.4
    out = {}
    for d in ("cpu", cuda):
        ctx = {"round": torch.tensor(rnd, dtype=torch.int32, device=d)}
        if stalled:
            ctx["stall"] = torch.tensor(stall, device=d)
        st = _tensors(state, d)
        out[d] = progs[d].edge_step(
            st, static.EdgeMsgs(**_tensors(edge_in, d)),
            Msgs(**_tensors(client_in, d)), ctx)
        # the step is out of place
        _equal(st, _tensors(state, d))
    _equal(out[cuda], out["cpu"])
    assert K.KAFKA_STEP.launches > 0


# --- K15: the batched-broadcast step -----------------------------------------

def random_batched_inputs(rng, prog, span=16):
    """A batched step's inputs (tests/test_torch_broadcast_batched.py's
    generator): pending planes of sparse, half and dense runs, range
    lanes at and past both ends, digests of every window, stray lane
    types; client batches of up to `span` ids (every node's first slot a
    whole-table batch when `span` >= V), reads and stray types."""
    N, D, V, W = prog.n_nodes, prog.D, prog.V, prog.n_windows
    L = prog.edge_cfg.lanes
    dens = np.array([0.02, 0.5, 0.97])[rng.integers(0, 3, (N, D, 1))]
    state = {"seen": rng.random((N, V)) < 0.3,
             "pending": rng.random((N, D, V)) < dens,
             "inflight": rng.random((N, D, V)) < 0.2,
             "inflight_old": rng.random((N, D, V)) < 0.2,
             "owed": rng.random((N, D, W)) < 0.3}
    shape = (N, D, L)
    typ = rng.choice(np.array([24, 24, 15, 14, 0], np.int32), shape)
    words = [rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
        np.int32) for _ in range(2)]
    a = np.where(typ == 15, rng.integers(0, W + 1, shape),
                 rng.integers(-2, V + 3, shape)).astype(np.int32)
    b = np.where(rng.random(shape) < 0.1, V + 5,
                 rng.integers(-2, max(V // 8, 4), shape))
    b = np.where(typ == 15, words[0], b).astype(np.int32)
    edge_in = {"valid": rng.random(shape) < 0.6, "type": typ, "a": a,
               "b": b, "c": words[1]}
    cs = (N, prog.inbox_cap)
    client_in = {
        "valid": rng.random(cs) < 0.5,
        "type": rng.choice(np.array([20, 20, 22, 10, 0], np.int32), cs),
        "a": np.where(rng.random(cs) < 0.1, 0,
                      rng.integers(-1, V + 2, cs)).astype(np.int32),
        "b": np.where(rng.random(cs) < 0.1, span,
                      rng.integers(-1, span + 2, cs)).astype(np.int32)}
    for f in ("src", "dest", "due", "mid", "reply_to", "c"):
        client_in[f] = rng.integers(-5, 1000, cs, dtype=np.int32)
    if span >= V:
        client_in["valid"][:, 0] = True
        client_in["type"][:, 0] = 20
        client_in["a"][:, 0] = 0
        client_in["b"][:, 0] = V
    return state, edge_in, client_in


# name: (nodes, values, ranges an edge, eager, batch span, topology); a
# V not a multiple of 16 puts the rows of 16 or more nodes at every
# 16-byte offset
BATCHED_SHAPES = {
    "grid5": (5, 1024, 2, False, 16, "grid"),
    "line7-missing-edges": (7, 100, 3, False, 8, "line"),
    "grid1000-eager": (1000, 512, 1, True, 32, "grid"),
    "tree4-odd-V": (50, 333, 4, False, 40, "tree4"),
    "wrap": (6, 70_000, 2, False, 70_000, "grid"),
    # the first design's global-scratch shape; one path at every V now
    "wideV-global-masks": (5, 300_256, 2, False, 300_256, "grid"),
    "V1": (16, 1, 1, False, 1, "grid"),
    "V17-offsets": (16, 17, 2, False, 4, "grid"),
    "V40-line": (20, 40, 3, False, 8, "line"),
    "V64-eager": (33, 64, 4, True, 16, "grid"),
    "V65-offsets": (17, 65, 2, False, 16, "tree4"),
    "V1024-offsets": (16, 1024, 3, False, 64, "grid"),
    "V4097": (9, 4097, 4, False, 600, "grid"),
}


@pytest.mark.parametrize("shape", list(BATCHED_SHAPES))
@pytest.mark.parametrize("tick", [True, False], ids=["retry", ""])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_broadcast_batched_step_matches_plain(cuda, shape, tick, stalled):
    """K15 against its plain version on every state leaf and every edge
    and client field, valid or not, on a retry-tick round and an
    ordinary one; the wrap shape's whole-table batches prove a checksum
    whose int32 id sum wraps. The inputs stay untouched."""
    n, V, per_nb, eager, span, topo = BATCHED_SHAPES[shape]
    progs = {d: get_program("broadcast-batched",
                            {"topology": topo, "max_values": V,
                             "gossip_per_neighbor": per_nb,
                             "eager_resend": eager},
                            [f"n{i}" for i in range(n)], device=d)
             for d in ("cpu", cuda)}
    rng = np.random.default_rng(n + V + tick + 2 * stalled)
    state, edge_in, client_in = random_batched_inputs(rng, progs["cpu"],
                                                      span)
    rnd = 3 * progs["cpu"].retry_rounds + (0 if tick else 1)
    stall = rng.random(n) < 0.4
    out = {}
    for d in ("cpu", cuda):
        ctx = {"round": torch.tensor(rnd, dtype=torch.int32, device=d)}
        if stalled:
            ctx["stall"] = torch.tensor(stall, device=d)
        st, ei = _tensors(state, d), _tensors(edge_in, d)
        ci = _tensors(client_in, d)
        out[d] = progs[d].edge_step(st, static.EdgeMsgs(**ei), Msgs(**ci),
                                    ctx)
        for got, ref in ((st, state), (ei, edge_in), (ci, client_in)):
            _equal(got, _tensors(ref, d))
    _equal(out[cuda], out["cpu"])
    if span >= V:
        co = out["cpu"][2]
        assert bool(((co.type[:, 0] == 21) & (co.b[:, 0] == V)).all())
    kern = K.BROADCAST_BATCHED_STEP_STALL if stalled else \
        K.BROADCAST_BATCHED_STEP
    assert kern.launches > 0


def _crafted_pending(case, N, D, V):
    """[N, D, V] pending planes of one run pattern: edge row r = n * D + d
    sits at byte offset s = r * V % 16 of its plane, so its tiles of 512
    values start at t * 512 - s."""
    v = np.arange(V)[None, None, :]
    s = (np.arange(N * D).reshape(N, D, 1) * V) % 16
    runs = {
        "dense": v >= 0,                  # one run across every tile
        "none": v < 0,
        # runs ending on the first two tile edges
        "tile-edges": (v < 512 - s) | ((v >= 515 - s) & (v < 1024 - s)),
        # runs of 16 on the lanes' 16-byte chunks
        "lane-edges": ((v + s) // 16) % 2 == 0,
        "one-run": (v >= V // 3) & (v < V // 3 + 7),  # fewer than per_nb
        "alternate": v % 2 == 0,          # a run of one at every other
    }[case]
    return np.broadcast_to(runs, (N, D, V)).copy()


@pytest.mark.parametrize("case", ["dense", "none", "tile-edges",
                                  "lane-edges", "one-run", "alternate"])
@pytest.mark.parametrize("V", [101, 1024, 1501])
@pytest.mark.parametrize("per_nb", [1, 4])
@pytest.mark.parametrize("eager", [False, True], ids=["", "eager"])
def test_broadcast_batched_runs_match_plain(cuda, case, V, per_nb, eager):
    """K15's run selection on crafted pending planes (runs across tiles,
    ending on tile and lane edges, fewer runs than per_nb, none, runs of
    one) at 17 nodes of a line (missing edges), rows at every 16-byte
    offset; no arrivals or batches, so the runs stay as crafted, and the
    digests in the last window or past it. Byte for byte against the
    plain version on an ordinary round, the inputs untouched."""
    n = 17
    progs = {d: get_program("broadcast-batched",
                            {"topology": "line", "max_values": V,
                             "gossip_per_neighbor": per_nb,
                             "eager_resend": eager},
                            [f"n{i}" for i in range(n)], device=d)
             for d in ("cpu", cuda)}
    p = progs["cpu"]
    rng = np.random.default_rng(V + per_nb)
    state, edge_in, client_in = random_batched_inputs(rng, p)
    state["pending"] = _crafted_pending(case, n, p.D, V)
    client_in["valid"][:] = False
    shape = edge_in["valid"].shape
    edge_in["valid"] = np.zeros(shape, bool)
    edge_in["valid"][:, :, 0] = True
    edge_in["type"][:, :, 0] = 15
    edge_in["a"][:, :, 0] = p.n_windows - rng.integers(0, 2, shape[:2])
    rnd = 3 * p.retry_rounds + 1
    out = {}
    for d in ("cpu", cuda):
        ctx = {"round": torch.tensor(rnd, dtype=torch.int32, device=d)}
        st, ei = _tensors(state, d), _tensors(edge_in, d)
        ci = _tensors(client_in, d)
        out[d] = progs[d].edge_step(st, static.EdgeMsgs(**ei), Msgs(**ci),
                                    ctx)
        for got, ref in ((st, state), (ei, edge_in), (ci, client_in)):
            _equal(got, _tensors(ref, d))
    _equal(out[cuda], out["cpu"])
    assert K.BROADCAST_BATCHED_STEP.launches > 0


@pytest.mark.parametrize("V", [17, 1024])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_broadcast_batched_unaligned_planes_match_plain(cuda, V, stalled):
    """K15 on planes whose base pointers are not 16-byte aligned (views a
    byte into their storage): the byte path, and seen's chunks read at
    any offset. The inputs stay untouched."""
    n = 20
    progs = {d: get_program("broadcast-batched",
                            {"topology": "grid", "max_values": V,
                             "gossip_per_neighbor": 3},
                            [f"n{i}" for i in range(n)], device=d)
             for d in ("cpu", cuda)}
    rng = np.random.default_rng(V + stalled)
    state, edge_in, client_in = random_batched_inputs(rng, progs["cpu"])
    stall = rng.random(n) < 0.4

    def offset(t):
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view
    out = {}
    for d in ("cpu", cuda):
        ctx = {"round": torch.tensor(3 * progs["cpu"].retry_rounds,
                                     dtype=torch.int32, device=d)}
        if stalled:
            ctx["stall"] = torch.tensor(stall, device=d)
        st = _tensors(state, d)
        if d != "cpu":
            st = {k: offset(v) for k, v in st.items()}
            assert st["pending"].data_ptr() % 16
        out[d] = progs[d].edge_step(
            st, static.EdgeMsgs(**_tensors(edge_in, d)),
            Msgs(**_tensors(client_in, d)), ctx)
        _equal(st, _tensors(state, d))
    torch.cuda.synchronize()
    _equal(out[cuda], out["cpu"])


def _elle_inputs(g, vp, rp, tp, n_txns, acyclic):
    """Random screen inputs: a writer table of per-key spans (some
    slots unwritten), reads at positions in and past both ends of the
    table, a ret order over the first n_txns ids (the rest padding) and
    each one's realtime predecessor index. `acyclic`: every edge runs
    from a lower txn id to a higher one, and the realtime order agrees."""
    writers = g.integers(-1, n_txns, vp)
    slot_key = np.sort(g.integers(-1, max(vp // 8, 2), vp))
    slot_idx = g.integers(0, 50, vp)
    r_tid = np.where(g.random(rp) < 0.9, g.integers(0, n_txns, rp), -1)
    wr_pos = g.integers(-2, vp + 3, rp)
    rw_pos = g.integers(-2, vp + 3, rp)
    r_n = g.integers(0, 60, rp)
    if acyclic:
        # sorted writers within a key, readers after their wr writer and
        # before their rw writer
        writers = np.sort(writers)
        wr_pos = np.clip(wr_pos, -1, vp - 1)
        rw_pos = np.clip(rw_pos, -1, vp - 1)
        lo = np.where(wr_pos >= 0, writers[np.maximum(wr_pos, 0)], -1)
        hi = np.where(rw_pos >= 0, writers[np.maximum(rw_pos, 0)], n_txns)
        ok = lo < hi - 1
        r_tid = np.where(ok, (lo + hi) // 2, -1)
        ret = np.arange(n_txns)
    else:
        ret = g.permutation(n_txns)
    ret_tid = np.full(tp, -1)
    ret_tid[:n_txns] = ret
    before = np.full(tp, -1)
    pos = g.integers(-1, n_txns, n_txns)
    before[ret] = np.minimum(pos, np.arange(n_txns) - 1) if acyclic \
        else pos
    return [torch.tensor(a, dtype=torch.int32) for a in
            (writers, slot_key, slot_idx, r_tid, r_n, wr_pos, rw_pos,
             ret_tid, before)]


@pytest.mark.parametrize("vp,rp,tp,acyclic", [
    (16, 16, 16, False), (256, 1024, 1024, True), (4096, 512, 2048, False),
    (1024, 4096, 4096, True), (8192, 8192, 1 << 21, False),
    (64, 64, (1 << 20) + 1024, True)])
@pytest.mark.parametrize("do_rt", [True, False])
def test_elle_kernels_match_plain(cuda, vp, rp, tp, acyclic, do_rt):
    from maelstrom_tpu_torch.checkers import elle_device as ed
    g = np.random.default_rng(vp * 7 + rp + tp)
    cpu = _elle_inputs(g, vp, rp, tp, min(tp, 3 * rp), acyclic)
    dev = [t.to(cuda) for t in cpu]
    e_idx = (0, 1, 3, 5, 6)
    n0, n1 = K.ELLE_EDGES.launches, K.ELLE_SCREEN.launches
    _equal(ed.elle_edges(*(dev[i] for i in e_idx)),
           ed.elle_edges(*(cpu[i] for i in e_idx)))
    got = ed.elle_screen(*dev, n_txns_pad=tp, do_rt=do_rt)
    ref = ed.elle_screen(*cpu, n_txns_pad=tp, do_rt=do_rt)
    assert got.cpu().tolist() == ref.tolist()
    assert (K.ELLE_EDGES.launches - n0, K.ELLE_SCREEN.launches - n1) == (1, 1)
    for a, b in zip(dev, cpu):       # inputs untouched
        assert torch.equal(a.cpu(), b)


# --- K18 sched_inject and K19 ring_update -------------------------------------

@pytest.mark.parametrize("Q", [1, 5, 255, 256, 257, 100_000])
@pytest.mark.parametrize("form", ["first", "fold", "last"])
def test_sched_inject_matches_plain(cuda, Q, form):
    """The continuous scan's select and fold: the first round (no im, no
    stamped view), a middle round, and the window's last fold (no
    select)."""
    from maelstrom_tpu_torch.sim import sched_select, sched_select_plain
    g = np.random.default_rng(Q)
    valid = g.random(Q) < 0.8
    at = g.integers(-1, 40, Q).astype(np.int32)
    im = g.integers(-1, 1 << 30, Q).astype(np.int32)
    sent = Msgs.empty(Q, "cpu").replace(
        valid=torch.tensor(g.random(Q) < 0.5),
        mid=torch.tensor(g.integers(0, 1 << 30, Q).astype(np.int32)))
    args = {"first": (None, None, 0), "fold": (im, sent, 7),
            "last": (im, sent, None)}[form]

    def call(fn, dev):
        m, s, off = args
        return fn(torch.tensor(valid, device=dev),
                  torch.tensor(at, device=dev),
                  None if m is None else torch.tensor(m, device=dev),
                  None if s is None else tree_map(lambda t: t.to(dev), s),
                  off)
    n0 = K.SCHED_INJECT.launches
    got = call(sched_select, cuda)
    ref = call(sched_select_plain, "cpu")
    assert K.SCHED_INJECT.launches - n0 == 1
    assert (got[0] is None) == (ref[0] is None) == (form == "last")
    if got[0] is not None:
        _equal(got[0], ref[0])
    _equal(got[1], ref[1])


def _ring_case(g, N, C, P, chan_shape, widths, RP, Q, roles, rnd=5000):
    """Random inputs of one ring fold on the CPU (see
    tests/test_torch_telemetry.py for the parity cases against JAX)."""
    from types import SimpleNamespace
    from maelstrom_tpu_torch import telemetry as TM
    from maelstrom_tpu_torch.net.tpu import NetConfig, NetStats

    def ri(lo, hi, shape=()):
        return torch.tensor(g.integers(lo, hi, shape), dtype=torch.int32)
    cfg = NetConfig(n_nodes=N, n_clients=C, pool_cap=P, telemetry=True,
                    telemetry_roles=roles)
    ring = TM.make_ring(cfg, "cpu")
    ring = ring.replace(**{f: ri(0, 1000, tuple(getattr(ring, f).shape))
                           for f in TM.MetricRing.__dataclass_fields__
                           if f != "req_round"})
    ring = ring.replace(req_round=torch.where(
        torch.tensor(g.random(C) < 0.3), -1, ri(rnd - 300, rnd, (C,))))
    stats = ("sent_all", "recv_all", "lost", "dropped_partition",
             "dropped_down", "dropped_overflow", "duplicated")
    st0 = NetStats.zeros("cpu").replace(
        **{f: ri(2**31 - 50, 2**31 - 1) for f in stats})
    st1 = st0.replace(**{f: getattr(st0, f) + ri(0, 100) for f in stats})
    net = SimpleNamespace(stats=st1, pool=SimpleNamespace(
        valid=torch.tensor(g.random(P) < 0.4)))
    chan = (None if chan_shape is None
            else torch.tensor(g.random(chan_shape) < 0.3))
    planes = tuple(torch.tensor(g.random((N, w)) < 0.3) for w in widths)
    reply = Msgs.empty(RP, "cpu").replace(
        valid=torch.tensor(g.random(RP) < 0.5),
        dest=ri(0, N + C + 3, (RP,)))
    inject = Msgs.empty(Q, "cpu").replace(
        valid=torch.tensor(g.random(Q) < 0.6), src=ri(0, N + C + 3, (Q,)))
    return [cfg, ring, st0, net, chan, torch.tensor(rnd, dtype=torch.int32),
            planes, inject, reply]


def _to_cuda(args, dev):
    """The fold's arguments on `dev` (the NetConfig as it is)."""
    from types import SimpleNamespace

    def move(a):
        if isinstance(a, SimpleNamespace):
            return SimpleNamespace(stats=move(a.stats), pool=SimpleNamespace(
                valid=a.pool.valid.to(dev)))
        return tree_map(lambda t: t.to(dev), a)
    return [args[0]] + [move(a) for a in args[1:]]


# (N, C, pool, channel shape or None, send plane widths, reply rows,
#  inject rows, role slices)
RING_CASES = {
    "pool-echo5": (5, 64, 4096, None, (8,), 128, 64, ((0, 5),)),
    "edge-linkv5": (5, 5, 64, (5, 4, 404, 1), (4, 8), 40, 5, ((0, 5),)),
    "roles": (7, 9, 100, (7, 2, 3, 2), (5, 1), 30, 9, ((0, 2), (2, 3),
                                                        (3, 7))),
    "wide-100k": (100_000, 100_000, 800_000, (100_000, 4, 2, 4), (16, 4),
                  400_000, 100_000, ((0, 100_000),)),
    "tiny": (1, 1, 1, None, (1,), 1, 1, ((0, 1),)),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_update_matches_plain(cuda, case):
    from maelstrom_tpu_torch import telemetry as TM
    N, C, P, ch, widths, RP, Q, roles = RING_CASES[case]
    g = np.random.default_rng(len(case) + N)
    cpu = _ring_case(g, N, C, P, ch, widths, RP, Q, roles)
    n0 = K.RING_UPDATE.launches
    got = TM.ring_update(*_to_cuda(cpu, cuda))
    ref = TM.ring_update_plain(*cpu)
    assert K.RING_UPDATE.launches - n0 == 1
    _equal(got, ref)


def test_ring_update_lat_buckets_exhaustive_and_wrap(cuda):
    """Every latency 1..2^17 in one fold, against the plain version's
    integer buckets, with lat_sum and lat_count wrapping past 2^31."""
    from maelstrom_tpu_torch import telemetry as TM
    C = 1 << 17
    rnd = C + 9
    g = np.random.default_rng(3)
    cpu = _ring_case(g, 5, C, 64, None, (4,), C, 4, ((0, 5),), rnd=rnd)
    ring = cpu[1].replace(
        req_round=torch.tensor(rnd - np.arange(1, C + 1), dtype=torch.int32),
        lat_sum=torch.tensor(2**31 - 7, dtype=torch.int32),
        lat_count=torch.tensor(2**31 - 3, dtype=torch.int32),
        lat_hist=torch.zeros(TM.LAT_BUCKETS, dtype=torch.int32))
    cpu[1] = ring
    cpu[8] = Msgs.empty(C, "cpu").replace(
        valid=torch.ones(C, dtype=torch.bool),
        dest=torch.arange(5, 5 + C, dtype=torch.int32))
    got = TM.ring_update(*_to_cuda(cpu, cuda))
    ref = TM.ring_update_plain(*cpu)
    _equal(got, ref)
    assert int(got.lat_sum) < 0 and int(got.lat_count) < 0
    assert got.lat_hist.cpu().tolist()[:4] == [1, 1, 2, 4]


# --- the service role steps (K20, K21, K22) ----------------------------------

# T_READ, T_WRITE, T_CAS, T_MERGE, T_TS and codes no role serves
SERVICE_TYPES = np.array([10, 12, 14, 45, 40, 0, 11, 41], np.int32)
INT32_MAX = 2**31 - 1


def random_services_inputs(rng, n, K, keys, G=8):
    """(inbox, state) as numpy fields for a service role step: every lane
    type, keys repeated across lanes and past both ends (clipped), cas
    `from` words that hit and miss the stored value+1, merges older and
    newer than the stored stamp, words at INT32_MAX (b + 1 wraps and
    clips to 0), clocks and timestamps that wrap, and per-replica dirty
    sets below, at and above G keys."""
    shape = (n, K)
    a = rng.integers(-2, 6, shape)
    a[rng.random(shape) < 0.05] = keys + 3
    b = rng.integers(-2, 9, shape)
    c = rng.integers(-2, 9, shape)
    for w in (b, c):
        w[rng.random(shape) < 0.04] = INT32_MAX
    inbox = {"valid": rng.random(shape) < 0.8,
             "src": rng.integers(0, n + 8, shape, dtype=np.int32),
             "dest": rng.integers(0, n, shape, dtype=np.int32),
             "due": rng.integers(0, 50, shape, dtype=np.int32),
             "mid": rng.integers(0, 1000, shape, dtype=np.int32),
             "reply_to": rng.integers(-1, 1000, shape, dtype=np.int32),
             "type": rng.choice(SERVICE_TYPES, shape).astype(np.int32),
             "a": a.astype(np.int32), "b": b.astype(np.int32),
             "c": c.astype(np.int32)}
    # node 0 holds every served type, valid, in its first lanes
    k = min(K, 5)
    inbox["type"][0, :k] = SERVICE_TYPES[[4, 0, 1, 2, 3]][:k]
    inbox["valid"][0, :k] = True
    dens = rng.choice(np.array([0.0, 0.01, G / keys, 0.3]), (n, 1))
    dirty = rng.random((n, keys)) < dens
    dirty[0] = False
    dirty[0, rng.choice(keys, min(G, keys), replace=False)] = True
    clock = rng.integers(0, 12, n).astype(np.int32)
    clock[n // 2] = INT32_MAX
    ts = rng.integers(0, 100, n).astype(np.int32)
    ts[0] = INT32_MAX - 2
    state = {"kv": rng.integers(0, 9, (n, keys), dtype=np.int32),
             "vts": rng.integers(-1, 12, (n, keys), dtype=np.int32),
             "clock": clock, "dirty": dirty, "ts": ts}
    return inbox, state


def _service_role(role, n, keys, G, device):
    from maelstrom_tpu_torch.nodes import services as S
    opts = {"kv_keys": keys, "gossip_keys": G}
    nodes = [f"n{i}" for i in range(n)]
    if role == "lin-tso":
        return S.TSORole(opts, nodes, device=device)
    if role == "seq-kv":
        return S.SeqKVRole(opts, nodes, device=device)
    return S.LWWKVRole(opts, nodes, base=2, device=device)


SERVICE_STATE = {"lin-tso": ("ts",), "seq-kv": ("kv",),
                 "lww-kv": ("kv", "vts", "clock", "dirty")}


@pytest.mark.parametrize("role,n,K_,keys,G", [
    ("lin-tso", 1, 8, 256, 8), ("lin-tso", 37, 40, 256, 8),
    ("seq-kv", 1, 8, 256, 8), ("seq-kv", 3, 17, 300, 8),
    ("lww-kv", 1, 8, 256, 8), ("lww-kv", 3, 8, 256, 8),
    ("lww-kv", 64, 8, 256, 8), ("lww-kv", 9, 5, 700, 3),
    ("lww-kv", 1022, 8, 256, 8)])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_service_steps_match_plain(cuda, role, n, K_, keys, G, stalled):
    rng = np.random.default_rng(n * 7 + K_ + int(stalled))
    inbox, state = random_services_inputs(rng, n, K_, keys, G)
    state = {k: state[k] for k in SERVICE_STATE[role]}
    stall = rng.random(n) < 0.4
    pc = _service_role(role, n, keys, G, "cpu")
    pg = _service_role(role, n, keys, G, cuda)
    kernel = {"lin-tso": K.TSO_STEP, "seq-kv": K.SEQ_KV_STEP,
              "lww-kv": K.LWW_KV_STEP}[role]

    def run(prog, dev):
        ctx = {"stall": torch.tensor(stall, device=dev)} if stalled else {}
        st = _tensors(state, dev)
        ib = Msgs(**_tensors(inbox, dev))
        return prog.step(st, ib, ctx), st

    before = kernel.launches
    (got, st_g), (ref, _st) = run(pg, cuda), run(pc, "cpu")
    assert kernel.launches == before + 1
    _equal(got, ref)
    _equal(st_g, _tensors(state, "cpu"))    # no input updated
    assert ref[1].valid.any() or stalled


# --- the compartment's role steps (K23-K26) ----------------------------------

def compartment_layout(roles, n_nodes=None, **opts):
    """A stable-leader `Layout` for `roles` (the cluster sized by it)."""
    from maelstrom_tpu_torch.nodes import compartment as C
    n = n_nodes or C.roles_node_count(roles)
    return C.Layout({"roles": roles, **opts}, n)


COMPARTMENT_ROLES = ("sequencers", "proxies", "acceptors", "replicas")


def compartment_role(role, lay, n, device, byz=False):
    """The role program over `n` nodes of `lay`'s cluster (with `byz`,
    under the byzantine adversary)."""
    from maelstrom_tpu_torch.nodes import compartment as C
    cls = {"sequencers": C.SequencerRole, "proxies": C.ProxyRole,
           "acceptors": C.GridAcceptors, "replicas": C.ReplicaRole}[role]
    opts = {"nemesis": {"byzantine"}} if byz else {}
    return cls(opts, [f"n{i}" for i in range(n)], lay, device=device)


# (roles spec, layout options, role, role nodes)
COMPARTMENT_CASES = {
    "seq-cli": ("proxies=2,acceptors=2x2,replicas=2", {}, "sequencers", 1),
    "seq-bench": ("proxies=8,acceptors=2x2,replicas=2",
                  {"leader_slots": 128, "compartment_inbox": 16},
                  "sequencers", 3),
    "seq-shed": ("proxies=2,acceptors=2x2,replicas=2",
                 {"leader_slots": 2, "concurrency": 16}, "sequencers", 4),
    "proxy-cli": ("proxies=2,acceptors=2x2,replicas=2", {}, "proxies", 2),
    "proxy-wide": ("proxies=8,acceptors=3x5,replicas=3",
                   {"proxy_slots": 40, "compartment_inbox": 16},
                   "proxies", 8),
    "proxy-r": ("proxies=3,acceptors=1x2,replicas=5", {}, "proxies", 3),
    "acc-cli": ("proxies=2,acceptors=2x2,replicas=2", {}, "acceptors", 4),
    "acc-odd": ("proxies=2,acceptors=3x7,replicas=2",
                {"log_cap": 1001, "compartment_inbox": 16}, "acceptors",
                21),
    "rep-cli": ("proxies=2,acceptors=2x2,replicas=2", {}, "replicas", 2),
    "rep-odd": ("proxies=2,acceptors=2x2,replicas=5",
                {"log_cap": 333, "kv_keys": 4095, "compartment_inbox": 16},
                "replicas", 5),
}


# the elected tier's cases: the CLI runs' ELECT shape (2 candidates, 1
# proxy, a 1x2 grid, 1 replica), bench.py's failover shape (3
# candidates, 4 proxies, a 2x2 grid, 2 replicas, QL 128, K 16, a
# 2,656-slot log) and odd ones (a 3x5 grid, 7 candidates at ballot width
# 3, 5 replicas)
_ELECT = "sequencers=2,proxies=1,acceptors=1x2,replicas=1"
_FAILOVER = "sequencers=3,proxies=4,acceptors=2x2,replicas=2"
_FAILOVER_LAY = {"leader_slots": 128, "proxy_slots": 8,
                 "compartment_inbox": 16, "kv_keys": 1024,
                 "concurrency": 48, "log_cap": 2656}
ELECT_CASES = {
    "eseq-elect": (_ELECT, {"election_timeout_rounds": 40}, "sequencers",
                   2),
    "eseq-failover": (_FAILOVER, _FAILOVER_LAY, "sequencers", 3),
    "eseq-odd": ("sequencers=7,proxies=2,acceptors=3x5,replicas=5",
                 {"ballot_width": 3, "leader_slots": 40,
                  "compartment_inbox": 12, "log_cap": 333},
                 "sequencers", 7),
    "eproxy-elect": (_ELECT, {}, "proxies", 1),
    "eproxy-failover": (_FAILOVER, _FAILOVER_LAY, "proxies", 4),
    "eproxy-odd": ("sequencers=5,proxies=6,acceptors=3x5,replicas=3",
                   {"proxy_slots": 40, "compartment_inbox": 16},
                   "proxies", 6),
    "eacc-elect": (_ELECT, {}, "acceptors", 2),
    "eacc-failover": (_FAILOVER, _FAILOVER_LAY, "acceptors", 4),
    "eacc-odd": ("sequencers=2,proxies=2,acceptors=3x7,replicas=2",
                 {"log_cap": 1001, "compartment_inbox": 16}, "acceptors",
                 21),
    "erep-elect": (_ELECT, {}, "replicas", 1),
    "erep-failover": (_FAILOVER, _FAILOVER_LAY, "replicas", 2),
    "erep-odd": ("sequencers=3,proxies=2,acceptors=2x2,replicas=5",
                 {"log_cap": 333, "kv_keys": 4095,
                  "compartment_inbox": 16}, "replicas", 5),
}


@pytest.mark.parametrize("case", list(COMPARTMENT_CASES))
@pytest.mark.parametrize("rnd", [0, 37, 1 << 20])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_compartment_steps_match_plain(cuda, case, rnd, stalled):
    roles, opts, role, n = COMPARTMENT_CASES[case]
    lay = compartment_layout(roles, rate=20.0, time_limit=2.0, **opts)
    rng = np.random.default_rng(n * 11 + rnd % 97 + int(stalled))
    inbox, state = random_compartment_inputs(rng, role, lay, n, rnd)
    stall = rng.random(n) < 0.4
    kernel = {"sequencers": K.COMPARTMENT_SEQUENCER_STEP,
              "proxies": K.COMPARTMENT_PROXY_STEP,
              "acceptors": K.COMPARTMENT_ACCEPTOR_STEP,
              "replicas": K.COMPARTMENT_REPLICA_STEP}[role]

    def run(dev):
        prog = compartment_role(role, lay, n, dev)
        ctx = {"round": torch.tensor(rnd, dtype=torch.int32, device=dev)}
        if stalled:
            ctx["stall"] = torch.tensor(stall, device=dev)
        st = _tensors(state, dev)
        ib = Msgs(**_tensors(inbox, dev))
        return prog.step(st, ib, ctx), st

    before = kernel.launches
    (got, st_g), (ref, _st) = run(cuda), run("cpu")
    assert kernel.launches == before + 1
    _equal(got, ref)
    _equal(st_g, _tensors(state, "cpu"))    # no input updated


@pytest.mark.parametrize("case", list(ELECT_CASES))
@pytest.mark.parametrize("rnd", [0, 37, 1 << 20])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_compartment_elect_steps_match_plain(cuda, case, rnd, stalled):
    """K27-K29 and K26 at the elected learn packing against their plain
    versions; the sequencer's election jitter comes from the same key."""
    from maelstrom_tpu_torch import prng
    roles, opts, role, n = ELECT_CASES[case]
    lay = compartment_layout(roles, rate=20.0, time_limit=2.0, **opts)
    rng = np.random.default_rng(n * 11 + rnd % 97 + int(stalled))
    inbox, state = random_compartment_inputs(rng, role, lay, n, rnd)
    stall = rng.random(n) < 0.4
    kernel = {"sequencers": K.COMPARTMENT_SEQUENCER_ELECT,
              "proxies": K.COMPARTMENT_PROXY_ELECT,
              "acceptors": K.COMPARTMENT_ACCEPTOR_ELECT,
              "replicas": K.COMPARTMENT_REPLICA_STEP}[role]

    def run(dev):
        prog = compartment_role(role, lay, n, dev)
        ctx = {"round": torch.tensor(rnd, dtype=torch.int32, device=dev),
               "key": prng.PRNGKey(rnd + n, dev)}
        if stalled:
            ctx["stall"] = torch.tensor(stall, device=dev)
        st = _tensors(state, dev)
        ib = Msgs(**_tensors(inbox, dev))
        return prog.step(st, ib, ctx), st

    before = kernel.launches
    (got, st_g), (ref, _st) = run(cuda), run("cpu")
    assert kernel.launches == before + 1
    _equal(got, ref)
    _equal(st_g, _tensors(state, "cpu"))    # no input updated


def test_replica_step_reads_the_elected_learn_word(cuda):
    """K26 with an elected tier: a learn from client 5 (not a multiple of
    8) at slot 3 lands at slot 3 with client 5, as the plain version
    stores it (the one-sequencer decode, a & 0x7FFF and a >> 16, would
    put it past the log with client 1)."""
    lay = compartment_layout("sequencers=2,proxies=1,acceptors=1x2,"
                             "replicas=1", rate=20.0, time_limit=2.0)
    prog_state = compartment_role("replicas", lay, 1, "cpu").init_state()
    state = {k: v.numpy() for k, v in prog_state.items()}
    inbox = {f: np.zeros((1, lay.K), np.int32) for f in (
        "src", "dest", "due", "mid", "reply_to", "type", "a", "b", "c")}
    inbox["valid"] = np.zeros((1, lay.K), bool)
    inbox["valid"][0, 0] = True
    inbox["type"][0, 0] = 33
    inbox["a"][0, 0] = (5 << 12) | 3
    inbox["b"][0, 0] = (7 << 18) | (1 << 16) | (4 << 8)
    outs = []
    for dev in (cuda, "cpu"):
        prog = compartment_role("replicas", lay, 1, dev)
        outs.append(prog.step(_tensors(state, dev), Msgs(**_tensors(
            inbox, dev)), {"round": torch.tensor(1, dtype=torch.int32,
                                                  device=dev)}))
    _equal(*outs)
    new = outs[1][0]
    assert bool(new["r_has"][0, 3]) and int(new["r_client"][0, 3]) == 5


# --- the byzantine adversary (K30, K31; K24 and K28's conviction lanes) -----

BYZ_CASES = {k: v for k, v in {**COMPARTMENT_CASES, **ELECT_CASES}.items()
             if k in ("seq-cli", "seq-bench", "proxy-cli", "proxy-wide",
                      "proxy-r", "eseq-elect", "eseq-failover",
                      "eproxy-elect", "eproxy-failover", "eproxy-odd")}


def _byz_role_run(case, rnd, stalled, dev, byz=True, zero_evidence=False):
    from maelstrom_tpu_torch import prng
    from maelstrom_tpu_torch.testing.compartment import (Z_KEYS,
                                                         random_byz_inputs)
    roles, opts, role, n = BYZ_CASES[case]
    lay = compartment_layout(roles, rate=20.0, time_limit=2.0, **opts)
    rng = np.random.default_rng(n * 13 + rnd % 89 + int(stalled))
    inbox, state = random_byz_inputs(rng, role, lay, n, rnd)
    if not byz:
        state = {k: v for k, v in state.items() if k not in Z_KEYS}
    if zero_evidence:
        inbox["valid"] &= inbox["type"] != 30     # nothing to convict
    stall = rng.random(n) < 0.4
    prog = compartment_role(role, lay, n, dev, byz=byz)
    ctx = {"round": torch.tensor(rnd, dtype=torch.int32, device=dev),
           "key": prng.PRNGKey(rnd + n, dev)}
    if stalled:
        ctx["stall"] = torch.tensor(stall, device=dev)
    st = _tensors(state, dev)
    return prog.step(st, Msgs(**_tensors(inbox, dev)), ctx), st, state


@pytest.mark.parametrize("case", list(BYZ_CASES))
@pytest.mark.parametrize("rnd", [0, 37, 1 << 20])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_compartment_byz_steps_match_plain(cuda, case, rnd, stalled):
    """K24 and K28 with the conviction lanes (and K23 and K27 on NACK
    lanes) against their plain versions, no input updated."""
    (got, st_g, state), (ref, _st, _s) = (
        _byz_role_run(case, rnd, stalled, cuda),
        _byz_role_run(case, rnd, stalled, "cpu"))
    _equal(got, ref)
    _equal(st_g, _tensors(state, "cpu"))


@pytest.mark.parametrize("case", ["proxy-cli", "proxy-wide", "eproxy-elect",
                                  "eproxy-failover"])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_proxy_flag_off_launch_is_the_flag_on_one_without_evidence(
        cuda, case, stalled):
    """K24 and K28 with the flag off against the flag-on launch on the
    same lanes when no assign is there to convict: the same table and
    lanes, the NACK lanes all invalid and the evidence unchanged."""
    (off, _s1, _st1) = _byz_role_run(case, 37, stalled, cuda, byz=False,
                                     zero_evidence=True)
    (on, _s2, st_on) = _byz_role_run(case, 37, stalled, cuda,
                                     zero_evidence=True)
    L = off[1].valid.shape[1]
    assert not on[1].valid[:, L:].any()
    _equal(tree_map(lambda t: t[:, :L], on[1]), off[1])
    _equal({k: v for k, v in on[0].items() if k in off[0]}, off[0])
    _equal({k: v for k, v in on[0].items() if k not in off[0]},
           {k: torch.tensor(v) for k, v in st_on.items()
            if k not in off[0]})


def _byz_carry(rng, dev, attack, culprit, rate_q, active=1):
    return {"active": torch.tensor(active, dtype=torch.int32, device=dev),
            "attack": torch.tensor(attack, dtype=torch.int32, device=dev),
            "culprit": torch.tensor(culprit, dtype=torch.int32, device=dev),
            "delta": torch.tensor(int(rng.integers(1, 0x8000)),
                                  dtype=torch.int32, device=dev),
            "rate_q": torch.tensor(rate_q, dtype=torch.int32, device=dev),
            "injected": torch.tensor(rng.integers(0, 1 << 20, 3),
                                     dtype=torch.int32, device=dev)}


def _byz_batch(rng, n, L, msg_type, dev):
    return Msgs(**_tensors({
        "valid": rng.random((n, L)) < 0.8,
        "src": rng.integers(0, n, (n, L)).astype(np.int32),
        "dest": rng.integers(0, n, (n, L)).astype(np.int32),
        "due": np.zeros((n, L), np.int32),
        "mid": rng.integers(0, 1000, (n, L)).astype(np.int32),
        "reply_to": np.full((n, L), -1, np.int32),
        "type": np.where(rng.random((n, L)) < 0.7, msg_type,
                         rng.integers(0, 45, (n, L))).astype(np.int32),
        "a": rng.integers(-2**31, 2**31 - 1, (n, L)).astype(np.int32),
        "b": rng.integers(-2**31, 2**31 - 1, (n, L)).astype(np.int32),
        "c": rng.integers(-2**31, 2**31 - 1, (n, L)).astype(np.int32)},
        dev))


@pytest.mark.parametrize("edge", [False, True], ids=["pool", "edge"])
@pytest.mark.parametrize("n,L,S", [(1, 1, 1), (9, 44, 1), (6, 300, 2),
                                   (100_000, 8, 3), (4, 2000, 5)])
@pytest.mark.parametrize("attack", [0, 1, 2])
@pytest.mark.parametrize("rnd", [0, 1, 1 << 20, 2**31 - 1])
def test_byz_corrupt_matches_plain(cuda, edge, n, L, S, attack, rnd):
    """K30 and K31 against their plain versions: the rewritten batch and
    the new ledger, the carry unchanged; rates 0, 1, 999 and 1000
    permille, culprits -1, in range and past the rows, inactive."""
    from maelstrom_tpu_torch import byzantine as BZ
    from maelstrom_tpu_torch.nodes.broadcast_batched import T_BATCH_OK
    from maelstrom_tpu_torch.nodes.compartment import T_ASSIGN
    rng = np.random.default_rng(n + L + attack + rnd % 1000)
    wire = BZ.EdgeWire(T_BATCH_OK) if edge else BZ.PoolWire(T_ASSIGN, S)
    kern, plain = ((K.BYZ_CORRUPT_EDGE, BZ.corrupt_edge_plain) if edge
                   else (K.BYZ_CORRUPT_POOL, BZ.corrupt_pool_plain))
    fn = BZ.corrupt_edge if edge else BZ.corrupt_pool
    hook = "byz_wire_edge" if edge else "byz_wire"
    prog = type("P", (), {hook: lambda self: wire})()
    for rate_q in (0, 1, 999, 1000):
        for culprit, active in ((n - 1, 1), (0, 1), (-1, 1), (n, 1),
                                (n // 2, 0)):
            carry = _byz_carry(rng, cuda, attack, culprit, rate_q, active)
            batch = _byz_batch(rng, n, L, wire.msg_type, cuda)
            r = torch.tensor(rnd, dtype=torch.int32, device=cuda)
            ref = plain(wire, to(carry, "cpu"), to(batch, "cpu"), r.cpu())
            keep = tree_map(lambda t: t.clone(), carry)
            before = kern.launches
            got = fn(prog, carry, batch, r)
            assert kern.launches == before + 1
            _equal(got, ref)
            _equal(carry, keep)        # the carry is not updated


# --- the fleet slice: the cluster axis under faults, K32, K33 and the fleet
# forms of K5 and K6 ------------------------------------------------------

def _fleet_faults(sims, F, n, G, rng, device):
    """Per-cluster faults on a cluster-batched state: loss, latency
    scales, duplication, component and directional partitions, kill and
    pause, and clusters at rounds of their own."""
    net = sims.net
    C = net.component.shape[1]
    comp = np.zeros((F, C), np.int32)
    comp[:, :n] = rng.integers(0, 2, (F, n))
    bg = np.zeros((F, C), np.int32)
    bg[:, :n] = rng.integers(0, G, (F, n))
    bm = rng.random((F, G, G)) < 0.3
    bm[:, np.arange(G), np.arange(G)] = False
    upd = {"round": rng.integers(0, 50, F).astype(np.int32),
           "p_loss": np.full(F, 0.03, np.float32),
           "latency_scale": rng.choice(np.array([0.5, 1.0, 2.0], np.float32),
                                       F),
           "p_dup": rng.choice(np.array([0.0, 0.3], np.float32), F),
           "component": comp, "block_groups": bg, "block_matrix": bm,
           "down": rng.random((F, n)) < 0.2,
           "paused": rng.random((F, n)) < 0.2}
    return sims.replace(net=net.replace(**{
        k: torch.from_numpy(v).to(device) for k, v in upd.items()}))


@pytest.mark.parametrize("prog_name,dist,F", [
    ("broadcast", "uniform", 7), ("broadcast", "constant", 64),
    ("lin-kv", "exponential", 7), ("lin-kv", "constant", 64)])
def test_fleet_cluster_round_under_faults_matches_plain(cuda, prog_name,
                                                        dist, F):
    """The cluster round under per-cluster faults through the kernels
    (K1, K2, K9 with [F] rounds, K3 or K10 over rows with the stall
    mask, K7 over [F, 2] keys with [F] probabilities and scales, K8
    F-led, K4) against the plain versions on the CPU, 40 rounds with
    client requests."""
    from maelstrom_tpu_torch import parallel as PP
    from maelstrom_tpu_torch.net import tpu as T
    n, R = 5, 40
    nodes = [f"n{i}" for i in range(n)]
    opts = {"latency": {"mean": 2 if dist != "constant" else 1,
                        "dist": dist},
            "max_values": 32, "nemesis": {"duplicate"}}
    rng = np.random.default_rng(F)
    plan = [{"valid": rng.random((F, 2)) < 0.3,
             "src": (n + rng.integers(0, 2, (F, 2))).astype(np.int32),
             "dest": rng.integers(0, n, (F, 2), dtype=np.int32),
             "type": rng.choice(np.array([10, 12], np.int32), (F, 2)),
             "a": rng.integers(0, 8, (F, 2), dtype=np.int32),
             "b": rng.integers(0, 5, (F, 2), dtype=np.int32),
             "c": rng.integers(0, 5, (F, 2), dtype=np.int32)}
            for _r in range(R)]
    res = {}
    for d in ("cpu", cuda):
        prog = get_program(prog_name, opts, nodes, device=d)
        cfg = T.NetConfig(n_nodes=n, n_clients=2, pool_cap=64,
                          inbox_cap=prog.inbox_cap, client_cap=4,
                          latency_mean_rounds=float(
                              opts["latency"]["mean"]),
                          latency_dist=dist, partition_groups=n,
                          enable_stall=True, enable_duplication=True)
        fn = PP.make_cluster_round_fn(prog, cfg, device=d)
        sims = PP.make_fleet_sims(prog, cfg, list(range(F)), device=d)
        sims = _fleet_faults(sims, F, n, n, np.random.default_rng(3), d)
        for rows in plan:
            sims = fn(sims, PP.injection_msgs(rows, d))[0]
        res[d] = sims
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])
    st = res["cpu"].net.stats
    assert int(st.dropped_partition.sum()) > 0
    assert int(st.dropped_down.sum()) > 0


@pytest.mark.parametrize("prog_name", ["broadcast", "lin-kv"])
def test_fleet_scan_matches_plain(cuda, prog_name):
    """Two fleet-scan dispatches (K32 holds, K5's fleet form) on the card
    against the plain versions: per-lane k_max, stop on reply, an
    inactive lane."""
    from maelstrom_tpu_torch import parallel as PP
    from maelstrom_tpu_torch.net import tpu as T
    from maelstrom_tpu_torch.sim import make_fleet_scan_fn
    n, F = 5, 9
    nodes = [f"n{i}" for i in range(n)]
    rng = np.random.default_rng(1)
    rows = {"valid": rng.random((F, 2)) < 0.8,
            "src": (n + rng.integers(0, 2, (F, 2))).astype(np.int32),
            "dest": rng.integers(0, n, (F, 2), dtype=np.int32),
            "type": np.full((F, 2), 10 if prog_name == "broadcast" else 10,
                            np.int32),
            "a": rng.integers(0, 8, (F, 2), dtype=np.int32)}
    kmax = rng.integers(1, 60, F)
    stop = rng.random(F) < 0.5
    active = np.ones(F, bool)
    active[2] = False
    res = {}
    for d in ("cpu", cuda):
        prog = get_program(prog_name, {"max_values": 32}, nodes, device=d)
        cfg = T.NetConfig(n_nodes=n, n_clients=2, pool_cap=64,
                          inbox_cap=prog.inbox_cap, client_cap=4)
        sims = PP.make_fleet_sims(prog, cfg, list(range(F)), device=d)
        fn = make_fleet_scan_fn(prog, cfg, reply_cap=64, device=d)
        outs = []
        for j in range(2):
            inj = PP.injection_msgs(rows, d)
            sims, cm, k, log = fn(sims, inj, kmax + 40 * j, stop, active)
            outs.append((k, log))
        res[d] = (sims, outs)
    torch.cuda.synchronize()
    _equal(res[cuda][0], res["cpu"][0])
    for (kg, lg), (kr, lr) in zip(res[cuda][1], res["cpu"][1]):
        _equal(kg, kr)
        _equal(tuple(x for x in lg if x is not None),
               tuple(x for x in lr if x is not None))


@pytest.mark.parametrize("F,live_p", [(1, 0.0), (5, 0.5), (10_000, 0.3)])
def test_fleet_hold_matches_plain(cuda, F, live_p):
    """K32 over leaves of odd row sizes and alignments (bool, int32,
    uint32, float32; 16-byte, 4-byte and byte copies)."""
    from maelstrom_tpu_torch.sim import fleet_hold
    rng = np.random.default_rng(F)
    shapes = [((F,), np.int32), ((F, 3), np.bool_), ((F, 4, 4), np.int32),
              ((F, 7), np.float32), ((F, 2), np.uint32),
              ((F, 5, 4, 3), np.bool_)]
    new = [rng.integers(0, 100, s).astype(t) for s, t in shapes]
    old = [rng.integers(0, 100, s).astype(t) for s, t in shapes]
    live = rng.random(F) < live_p
    res = {}
    for d in ("cpu", cuda):
        dst = [torch.from_numpy(x.copy()).to(d) for x in new]
        src = [torch.from_numpy(x.copy()).to(d) for x in old]
        fleet_hold(torch.from_numpy(live).to(d), list(zip(dst, src)))
        res[d] = tuple(dst)
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])
    for x, y, z in zip(res["cpu"], new, old):
        want = np.where(live.reshape((-1,) + (1,) * (y.ndim - 1)), y, z)
        np.testing.assert_array_equal(x.numpy(), want)


# K32's leaves a row: widths of 1 to 4,000 bytes (bool and int32 rows,
# so 16-byte, 4-byte and byte copies and partial last chunks)
HOLD_WIDTHS = [((1,), np.bool_), ((2,), np.bool_), ((3,), np.bool_),
               ((5,), np.bool_), ((4,), np.int32), ((17,), np.bool_),
               ((1000,), np.int32)]


@pytest.mark.parametrize("F", [1, 64, 10_000])
@pytest.mark.parametrize("held", ["none", "all", "30%"])
def test_fleet_hold_leaf_widths_match_plain(cuda, F, held):
    """K32 over leaves of 1, 2, 3, 5, 16, 17 and 4,000 bytes a row, with
    no lane, every lane and 30% of the lanes held; the sources stay
    untouched."""
    from maelstrom_tpu_torch.sim import fleet_hold
    rng = np.random.default_rng(F + len(held))
    live = {"none": np.ones(F, bool), "all": np.zeros(F, bool),
            "30%": rng.random(F) >= 0.3}[held]
    new = [rng.integers(0, 100, (F,) + w).astype(t) for w, t in HOLD_WIDTHS]
    old = [rng.integers(0, 100, (F,) + w).astype(t) for w, t in HOLD_WIDTHS]
    res = {}
    for d in ("cpu", cuda):
        dst = [torch.from_numpy(x.copy()).to(d) for x in new]
        src = [torch.from_numpy(x.copy()).to(d) for x in old]
        fleet_hold(torch.from_numpy(live).to(d), list(zip(dst, src)))
        res[d] = tuple(dst)
        for x, y in zip(src, old):
            np.testing.assert_array_equal(x.cpu().numpy(), y)
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])


@pytest.mark.parametrize("leaves,launches", [(96, 1), (97, 2)])
def test_fleet_hold_leaf_table_launches(cuda, leaves, launches):
    """96 leaves take one K32 launch, 97 two; every leaf held right."""
    from maelstrom_tpu_torch.sim import fleet_hold
    F = 300
    rng = np.random.default_rng(leaves)
    live = rng.random(F) >= 0.3
    widths = [HOLD_WIDTHS[k % len(HOLD_WIDTHS)] for k in range(leaves)]
    new = [rng.integers(0, 100, (F,) + w).astype(t) for w, t in widths]
    old = [rng.integers(0, 100, (F,) + w).astype(t) for w, t in widths]
    res = {}
    for d in ("cpu", cuda):
        dst = [torch.from_numpy(x.copy()).to(d) for x in new]
        src = [torch.from_numpy(x.copy()).to(d) for x in old]
        before = K.FLEET_HOLD.launches
        fleet_hold(torch.from_numpy(live).to(d), list(zip(dst, src)))
        if d != "cpu":
            assert K.FLEET_HOLD.launches - before == launches
        res[d] = tuple(dst)
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])


@pytest.mark.parametrize("F,S,R", [(1, 8, 8), (64, 10, 8), (10_000, 10, 8),
                                   (3, 300, 129)])
def test_wave_reduce_matches_plain(cuda, F, S, R):
    """K33 on random session tables with empty rows, INT32_MAX-adjacent
    deadlines and slots past one warp."""
    from maelstrom_tpu_torch.runner.sessions import (wave_reduce,
                                                     wave_reduce_plain)
    rng = np.random.default_rng(S)
    p_mid = np.where(rng.random((F, S)) < 0.4,
                     rng.integers(0, 10**6, (F, S)), -1).astype(np.int32)
    p_mid[::3] = -1
    p_dl = rng.integers(0, 2**31 - 1, (F, S), dtype=np.int64).astype(
        np.int32)
    r_valid = rng.random((F, R)) < 0.3
    r_valid[1::4] = False
    r_due = rng.integers(-5, 2**31 - 1, (F, R), dtype=np.int64).astype(
        np.int32)
    args = [torch.from_numpy(a) for a in (p_mid, p_dl, r_valid, r_due)]
    ref = wave_reduce_plain(*args)
    got = wave_reduce(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    _equal(got, ref)


@pytest.mark.parametrize("F,CW,rcap,W", [(3, 9, 64, 2), (64, 20, 40, 0),
                                         (10_000, 10, 256, 2),
                                         (5, 600, 1300, 4)])
def test_reply_log_fleet_matches_plain(cuda, F, CW, rcap, W):
    """K5's fleet form: lanes live and held, logs near full, stop and
    k_max per lane."""
    from maelstrom_tpu_torch.sim import (append_replies_fleet,
                                         empty_fleet_log)
    rng = np.random.default_rng(F + CW)
    N, V = 5, 32 * W if W else 0
    cm = {"valid": rng.random((F, CW)) < 0.4,
          **{f: rng.integers(-5, 99, (F, CW), dtype=np.int32)
             for f in ("src", "dest", "due", "mid", "reply_to", "type", "a",
                       "b", "c")}}
    seen = rng.random((F * N, V)) < 0.5 if W else None
    rn0 = rng.integers(0, rcap, F).astype(np.int32)
    k_max = rng.integers(1, 9, F).astype(np.int32)
    stop = rng.random(F) < 0.5
    live = rng.random(F) < 0.7
    exit0 = np.where(rng.random(F) < 0.2, 3, 2**31 - 1).astype(np.int32)
    rnd = rng.integers(0, 999, F).astype(np.int32)
    res = {}
    for d in ("cpu", cuda):
        log = empty_fleet_log(F, rcap, W, d)
        log[3].copy_(torch.from_numpy(rn0))
        exit_k = torch.from_numpy(exit0.copy()).to(d)
        live2, n_live = append_replies_fleet(
            log, Msgs(**_tensors(cm, d)),
            None if seen is None else torch.from_numpy(seen).to(d), N,
            torch.from_numpy(rnd).to(d), 4, torch.from_numpy(k_max).to(d),
            torch.from_numpy(stop).to(d), exit_k,
            torch.from_numpy(live).to(d))
        res[d] = (tuple(x for x in log if x is not None), exit_k, live2,
                  n_live)
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])


@pytest.mark.parametrize("F,rows", [(1, [5, 3]), (7, [13, 64, 3]),
                                    (10_000, [16, 320, 5])])
def test_quiet_probe_fleet_matches_plain(cuda, F, rows):
    from maelstrom_tpu_torch.runner.tpu_runner import (
        quiet_probe_fleet, quiet_probe_fleet_plain)
    rng = np.random.default_rng(F)
    planes = [rng.random((F, r)) < 0.002 for r in rows]
    ref = quiet_probe_fleet_plain([torch.from_numpy(p) for p in planes])
    got = quiet_probe_fleet([torch.from_numpy(p).to(cuda) for p in planes])
    torch.cuda.synchronize()
    _equal(got, ref)
    if F >= 1000:
        assert 0 < int(ref.sum()) < F


@pytest.mark.parametrize("F,n", [(3, 7), (10_000, 40)])
def test_threefry_batched_masks_and_latency_match_plain(cuda, F, n):
    """K7 over [F, 2] keys with [F] probabilities and latency scales."""
    from maelstrom_tpu_torch import prng
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, (F, 2), dtype=np.uint64).astype(np.uint32)
    p = rng.random(F).astype(np.float32)
    scale = rng.choice(np.array([0.5, 1.0, 3.0], np.float32), F)
    res = {}
    for d in ("cpu", cuda):
        k = torch.from_numpy(keys.astype(np.int64)).to(torch.uint32).to(d)
        res[d] = (prng.bernoulli_below(k, (n,), torch.from_numpy(p).to(d)),
                  prng.latency_rounds(k, (n,), "uniform", 3.0,
                                      torch.from_numpy(scale).to(d)))
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])


# --- K3 and K2 redesigned: every V, the row form, the fleet's K2 ------------

K3_VALUES = [1, 17, 63, 64, 65, 100, 1000, 1024, 4097, 40_000, 65_536]
K3_MODES = {"efficient": {}, "eager": {"eager_resend": True},
            "naive": {"naive_broadcast": True},
            "naive-all": {"naive_broadcast": True, "skip_sender": False}}


def _k3_inputs(rng, p, N, Kc=4):
    """K3 inputs for N node rows of program `p`, with the hazards of the
    selection and the folds: edge rows with no pending value or one
    (fewer than per_nb) beside dense ones, many lanes and client rows
    carrying one value, values outside [0, V), digests of every window,
    of -1 and past the last."""
    D, V, W, L = p.D, p.V, p.n_windows, p.edge_cfg.lanes
    dens = rng.choice(np.array([0.0, 0.5 / V, 0.2, 0.9]), (N, D, 1))
    state = {"seen": rng.random((N, V)) < 0.3,
             "owed": rng.random((N, D, W)) < 0.3,
             "pending": rng.random((N, D, V)) < dens,
             "inflight": rng.random((N, D, V)) < 0.2,
             "inflight_old": rng.random((N, D, V)) < 0.2}
    etype = rng.choice(np.array([14, 14, 15, 0], np.int32), (N, D, L))
    a = np.where(etype == 15, rng.integers(-1, W + 2, (N, D, L)),
                 rng.integers(-3, V + 3, (N, D, L)))
    a = np.where((etype == 14) & (rng.random((N, D, L)) < 0.3), V // 2, a)
    edge_in = {"valid": rng.random((N, D, L)) < 0.7, "type": etype,
               "a": a.astype(np.int32),
               **{f: rng.integers(-2**31, 2**31, (N, D, L), dtype=np.int64
                                  ).astype(np.int32) for f in ("b", "c")}}
    ca = np.where(rng.random((N, Kc)) < 0.3, V // 2,
                  rng.integers(-2, V + 2, (N, Kc)))
    client = {"valid": rng.random((N, Kc)) < 0.6,
              "type": rng.choice(np.array([10, 10, 12, 0], np.int32),
                                 (N, Kc)),
              "a": ca.astype(np.int32),
              **{f: rng.integers(-5, 999, (N, Kc), dtype=np.int32)
                 for f in ("src", "dest", "due", "mid", "reply_to", "b",
                           "c")}}
    return state, edge_in, client


def _wrap_round(p):
    """A round off the retry tick whose rotation starts at the largest
    start it can, so the selection wraps past V."""
    return max((r for r in range(1, 2 * p.V + 2) if r % p.retry_rounds),
               key=lambda r: (r * p.per_nb) % p.V)


@pytest.mark.parametrize("V", K3_VALUES)
@pytest.mark.parametrize("mode", list(K3_MODES))
@pytest.mark.parametrize("per_nb", [1, 4])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_broadcast_step_every_v_matches_plain(cuda, V, mode, per_nb,
                                              stalled):
    """K3 at values not a multiple of 16, 64 or 512 (rows whose first and
    last 16 bytes are partial), at one value, and at 40,000 and 65,536
    values on 5 nodes (the bits in shared memory, and past it), in every
    mode, on the retry tick and on a round whose rotation wraps."""
    n = 5 if V >= 40_000 else 45
    rng = np.random.default_rng(V * 8 + per_nb * 2 + stalled)
    nodes = [f"n{i}" for i in range(n)]
    opts = {"topology": "grid", "max_values": V,
            "gossip_per_neighbor": per_nb, **K3_MODES[mode]}
    progs = {d: get_program("broadcast", opts, nodes, device=d)
             for d in ("cpu", "cuda")}
    p = progs["cpu"]
    assert int((p.neighbors < 0).sum()) > 0     # missing edges
    state, edge_in, client = _k3_inputs(rng, p, n)
    stall = rng.random(n) < 0.4 if stalled else None
    name = "broadcast_step_stall" if stalled else "broadcast_step"
    for rnd in (p.retry_rounds * 2, _wrap_round(p)):
        before = K.launch_counts()[name]
        out = {}
        for d, prog in progs.items():
            ctx = {"round": torch.tensor(rnd, dtype=torch.int32, device=d)}
            if stalled:
                ctx["stall"] = torch.tensor(stall, device=d)
            out[d] = prog.edge_step(
                _tensors(state, d), static.EdgeMsgs(**_tensors(edge_in, d)),
                Msgs(**_tensors(client, d)), ctx)
        torch.cuda.synchronize()
        assert K.launch_counts()[name] == before + 1
        for g, r in zip(out["cuda"], out["cpu"]):
            _equal(g, r)


@pytest.mark.parametrize("V", [17, 1024])
@pytest.mark.parametrize("mode", ["efficient", "naive"])
def test_broadcast_step_unaligned_planes_match_plain(cuda, V, mode):
    """K3 on planes whose base pointers are not 16-byte aligned (views a
    byte into their storage): the byte path."""
    rng = np.random.default_rng(V)
    nodes = [f"n{i}" for i in range(45)]
    opts = {"topology": "grid", "max_values": V, "gossip_per_neighbor": 4,
            **K3_MODES[mode]}
    progs = {d: get_program("broadcast", opts, nodes, device=d)
             for d in ("cpu", "cuda")}
    p = progs["cpu"]
    state, edge_in, client = _k3_inputs(rng, p, 45)

    def offset(t):
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view
    out = {}
    for d, prog in progs.items():
        st = _tensors(state, d)
        if d != "cpu":
            st = {k: offset(v) for k, v in st.items()}
            assert st["pending"].data_ptr() % 16
        out[d] = prog.edge_step(
            st, static.EdgeMsgs(**_tensors(edge_in, d)),
            Msgs(**_tensors(client, d)),
            {"round": torch.tensor(_wrap_round(p), dtype=torch.int32,
                                   device=d)})
    torch.cuda.synchronize()
    for g, r in zip(out["cuda"], out["cpu"]):
        _equal(g, r)


@pytest.mark.parametrize("V", [17, 64, 1000])
@pytest.mark.parametrize("mode", list(K3_MODES))
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_broadcast_step_rows_match_plain(cuda, V, mode, stalled):
    """K3's row form: F = 7 clusters of 5 nodes, each at its own round
    (one on its retry tick), row n reading neighbors[n % 5] and
    round[n // 5]."""
    F, n = 7, 5
    rng = np.random.default_rng(V + F + stalled)
    nodes = [f"n{i}" for i in range(n)]
    opts = {"topology": "grid", "max_values": V, "gossip_per_neighbor": 4,
            **K3_MODES[mode]}
    progs = {d: get_program("broadcast", opts, nodes, device=d)
             for d in ("cpu", "cuda")}
    p = progs["cpu"]
    state, edge_in, client = _k3_inputs(rng, p, F * n)
    rnd = rng.choice(10_000, F, replace=False).astype(np.int32)
    rnd[0] = p.retry_rounds * 3
    stall = rng.random(F * n) < 0.4 if stalled else None
    out = {}
    for d, prog in progs.items():
        out[d] = prog.step_rows(
            _tensors(state, d), static.EdgeMsgs(**_tensors(edge_in, d)),
            Msgs(**_tensors(client, d)), torch.tensor(rnd, device=d), None,
            None if stall is None else torch.tensor(stall, device=d))
    torch.cuda.synchronize()
    for g, r in zip(out["cuda"], out["cpu"]):
        _equal(g, r)


@pytest.mark.parametrize("form", ["uniform-ring2", "lanes-ring4",
                                  "fleet-uniform", "fleet-lanes-sent"])
def test_edge_write_forms_match_plain(cuda, form):
    """K2 over 10,000 node rows x 4 edges x 5 lanes (some 800 blocks), so
    the overwrite and clipped counts sum over many warps and blocks: at
    ring 2 under uniform arrival with the deliver mask an [N, D, 1]
    view, at ring 4 with a latency a lane, and on the fleet's rows (2,000
    clusters of 5) with [F] rounds and [F] counters, one with the sent
    plane."""
    N, D, L = 10_000, 4, 5
    fleet = form.startswith("fleet")
    ring = 2 if form == "uniform-ring2" else 4
    uniform = "uniform" in form
    F = 2_000 if fleet else 1
    rng = np.random.default_rng(len(form))
    cfg = static.EdgeConfig(n_nodes=N, degree=D, lanes=L, ring=ring,
                            uniform_arrival=uniform)
    shape = (N, D, ring, L)
    ch = {"valid": rng.random(shape) < 0.5,
          **{f: rng.integers(-99, 99, shape, dtype=np.int32)
             for f in ("type", "a", "b", "c")}}
    if form.endswith("sent"):
        ch["sent"] = rng.integers(0, 9999, shape, dtype=np.int32)
    out = {"valid": rng.random((N, D, L)) < 0.7,
           **{f: rng.integers(-99, 99, (N, D, L), dtype=np.int32)
              for f in ("type", "a", "b", "c")}}
    lat = rng.integers(0, ring + 3, (N, D, L), dtype=np.int32)
    mask = rng.random((N, D, 1)) < 0.8
    rnd = (rng.integers(0, 1000, F).astype(np.int32) if fleet
           else np.int32(17))
    res = {}
    for d in ("cpu", cuda):
        zero = torch.zeros(F if fleet else (), dtype=torch.int32, device=d)
        c = static.EdgeChannels(**_tensors(ch, d), overwrites=zero,
                                lat_clipped=zero.clone())
        res[d] = static.edge_write(
            cfg, c, static.EdgeMsgs(**_tensors(out, d)),
            torch.tensor(rnd, device=d), torch.tensor(lat, device=d),
            torch.tensor(mask, device=d).expand(N, D, L))
    torch.cuda.synchronize()
    _equal(res[cuda], res["cpu"])
    assert int(res["cpu"].overwrites.sum()) > 10_000
    assert int(res["cpu"].lat_clipped.sum()) > 10_000


@pytest.mark.parametrize("where", ["wrapper", "entry-channels",
                                   "entry-strides"])
def test_edge_write_refuses_past_int32(cuda, where):
    """K2 indexes in int32: the wrapper refuses channels of more than
    K2_MAX_ELEMENTS elements (here 2^27 nodes x 4 x 1 x 5, as zero-stride
    views: nothing is allocated), and the C entry point refuses, before
    any launch, channels or latency and mask strides past int32."""
    if where == "wrapper":
        N, D, ring, L = 2**27, 4, 1, 5
        assert N * D * ring * L > static.K2_MAX_ELEMENTS
        cfg = static.EdgeConfig(n_nodes=N, degree=D, lanes=L, ring=ring,
                                uniform_arrival=True)

        def view(shape, dtype):
            return torch.zeros((), dtype=dtype, device=cuda).expand(shape)
        ch = static.EdgeChannels(
            valid=view((N, D, ring, L), torch.bool),
            **{f: view((N, D, ring, L), torch.int32)
               for f in ("type", "a", "b", "c")},
            overwrites=torch.zeros((), dtype=torch.int32, device=cuda),
            lat_clipped=torch.zeros((), dtype=torch.int32, device=cuda))
        out = static.EdgeMsgs(valid=view((N, D, L), torch.bool),
                              **{f: view((N, D, L), torch.int32)
                                 for f in ("type", "a", "b", "c")})
        with pytest.raises(ValueError, match="int32"):
            static.edge_write(cfg, ch, out,
                              torch.tensor(3, dtype=torch.int32,
                                           device=cuda),
                              view((N, D, L), torch.int32),
                              view((N, D, L), torch.bool))
        return
    # four lanes of real tensors; the ints claim what the entry refuses
    t8 = torch.zeros(4, dtype=torch.uint8, device=cuda)
    t32 = torch.zeros(4, dtype=torch.int32, device=cuda)
    tensors = [t8, t32, t32, t32, t32, t8, t32, t32, t32, t32, t32, t8,
               t32[:1], t32[1:2], t32[2:3], None]
    if where == "entry-channels":  # 2^31 channel elements
        ints = [2**20, 4, 128, 4, 1, 0, 0, 0, 0, 0, 0, 0, 0]
    else:  # a latency stride whose last element passes int32
        ints = [4, 1, 1, 1, 0, 2**30, 0, 0, 0, 0, 0, 0, 0]
    n0 = K.EDGE_WRITE.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        K.EDGE_WRITE.launch(tensors, ints, t8.device)
    assert K.EDGE_WRITE.launches == n0


@pytest.mark.parametrize("V", [17, 64])
@pytest.mark.parametrize("mode", ["efficient", "naive"])
def test_broadcast_step_wide_items_match_plain(cuda, V, mode):
    """K3 on a 100-node total topology: 99 edges of 5 lanes, so a row
    folds a node's 499 items in many runs of its lanes."""
    n = 100
    rng = np.random.default_rng(V + n)
    nodes = [f"n{i}" for i in range(n)]
    opts = {"topology": "total", "max_values": V, "gossip_per_neighbor": 4,
            **K3_MODES[mode]}
    progs = {d: get_program("broadcast", opts, nodes, device=d)
             for d in ("cpu", "cuda")}
    p = progs["cpu"]
    assert p.D == n - 1
    state, edge_in, client = _k3_inputs(rng, p, n)
    out = {}
    for d, prog in progs.items():
        out[d] = prog.edge_step(
            _tensors(state, d), static.EdgeMsgs(**_tensors(edge_in, d)),
            Msgs(**_tensors(client, d)),
            {"round": torch.tensor(_wrap_round(p), dtype=torch.int32,
                                   device=d)})
    torch.cuda.synchronize()
    for g, r in zip(out["cuda"], out["cpu"]):
        _equal(g, r)
