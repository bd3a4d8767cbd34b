"""The port's in-cluster services (`--node tpu:services`) against the JAX
package's, on the CPU.

- The role steps: the plain versions of K20 (`TSORole.step`), K21
  (`SeqKVRole.step`) and K22 (`LWWKVRole.step`) against
  `maelstrom_tpu.nodes.services` on random inboxes
  (`test_torch_kernels_gpu.random_services_inputs`: every lane type,
  repeated and out-of-range keys, cas hits and misses, merges older and
  newer than the stored stamp, words at INT32_MAX, wrapping clocks and
  timestamps, dirty sets below, at and above G), with the stall mask on
  and off (JAX's freeze and output mask after the step). Tolerance:
  exact, on every state leaf and every outbox field, invalid lanes
  included.
- A 5-node services cluster's rounds and scan, every `SimState` leaf
  and `NetStats` counter equal.
- The lin-tso workload through `core.run`, byte-equal to the JAX
  runner's history (and `net.telemetry` with the ring on), the
  role-targeted nemesis included; the checker on its witness,
  real-time-violation and duplicate histories; the refusals and fault
  groups with JAX's messages.

`-m slow` re-derives `chip_smoke.PINNED_SERVICES` (the full-length
runs of the smoke's `cli_services` phase, some two minutes on the CPU):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_services.py -m slow
"""

from __future__ import annotations

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu import core as jcore
from maelstrom_tpu import nemesis as jnem
from maelstrom_tpu.checkers.tso import TSOChecker as JTSOChecker
from maelstrom_tpu.history import History as JHistory
from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.nodes import services as JS
from maelstrom_tpu.sim import _freeze as j_freeze
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_scan_fn as j_make_scan_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch import core as pcore
from maelstrom_tpu_torch import nemesis as pnem
from maelstrom_tpu_torch.checkers.tso import TSOChecker as PTSOChecker
from maelstrom_tpu_torch.history import History as PHistory
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.nodes import services as PS
from maelstrom_tpu_torch.sim import make_run_fn as p_make_run_fn
from maelstrom_tpu_torch.sim import make_scan_fn as p_make_scan_fn
from test_torch_faults import _install
from test_torch_kernels_gpu import (SERVICE_STATE, random_services_inputs)
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

ROLES = {"lin-tso": (JS.TSORole, PS.TSORole),
         "seq-kv": (JS.SeqKVRole, PS.SeqKVRole),
         "lww-kv": (JS.LWWKVRole, PS.LWWKVRole)}


# --- the role steps (K20, K21, K22's plain versions) ------------------------

# (JAX's eager ops compile once a shape: the cases share shapes)
@pytest.mark.parametrize("role,n,K_,keys,G", [
    ("lin-tso", 1, 8, 256, 8), ("lin-tso", 6, 40, 256, 8),
    ("seq-kv", 1, 8, 256, 8), ("seq-kv", 1, 24, 16, 8),
    ("lww-kv", 1, 8, 256, 8), ("lww-kv", 3, 8, 256, 8),
    ("lww-kv", 3, 8, 256, 3), ("lww-kv", 3, 8, 256, 0)])
@pytest.mark.parametrize("stalled", [False, True], ids=["", "stall"])
def test_role_steps_match_jax(role, n, K_, keys, G, stalled):
    rng = np.random.default_rng(3 * n + K_ + int(stalled))
    inbox, state = random_services_inputs(rng, n, K_, keys, G)
    state = {k: state[k] for k in SERVICE_STATE[role]}
    stall = rng.random(n) < 0.4
    opts = {"kv_keys": keys, "gossip_keys": G}
    nodes = [f"n{i}" for i in range(n)]
    kw = {"base": 2} if role == "lww-kv" else {}
    jcls, pcls = ROLES[role]
    jprog, pprog = jcls(opts, nodes, **kw), pcls(opts, nodes, device="cpu",
                                                 **kw)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    jnew, jout = jprog.step(jstate, JT.Msgs(**{
        k: jnp.asarray(v) for k, v in inbox.items()}), {"round": 0})
    ctx = {}
    if stalled:
        st = jnp.asarray(stall)
        jnew = j_freeze(st, jstate, jnew)
        jout = jout.replace(valid=jout.valid & ~st[:, None])
        ctx["stall"] = torch.tensor(stall)
    pnew, pout = pprog.step({k: torch.tensor(v) for k, v in state.items()},
                            convert.msgs_from_numpy(inbox, device="cpu"),
                            ctx)
    assert_trees_equal(jax_tree_to_numpy(jnew), as_numpy(pnew))
    assert_trees_equal(jax_tree_to_numpy(jout), as_numpy(pout))
    # the random inbox reaches what it is for
    got = as_numpy(pout)
    if not stalled:
        assert got["valid"].any()
    if role == "lww-kv" and n > 1 and G:
        # gossip lanes past the picked keys are invalid, zero-filled
        gl = got["valid"][:, K_:]
        assert gl.all(axis=1).any() and (~gl).any()


def test_lww_gossip_converges_and_quiesces():
    """Three replicas: writes at replicas 0 and 1 travel the ring by
    dirty-set gossip (the merge lanes routed by hand), every copy
    converges and the dirty sets drain (the quiescence planes)."""
    prog = PS.LWWKVRole({"kv_keys": 8, "gossip_keys": 4},
                        ["n0", "n1", "n2"], device="cpu")
    st = prog.init_state()
    rows = [(0, 12, 3, 7, 0), (1, 12, 5, 2, 0)]
    for _ in range(12):
        ib = {f: np.zeros((3, 8), np.int32) for f in
              ("src", "dest", "due", "mid", "reply_to", "type", "a", "b",
               "c")}
        ib["valid"] = np.zeros((3, 8), bool)
        lane = [0, 0, 0]
        for node, t, a, b, c in rows:
            k = lane[node]
            lane[node] += 1
            ib["valid"][node, k] = True
            for f, v in (("type", t), ("a", a), ("b", b), ("c", c)):
                ib[f][node, k] = v
        st, out = prog.step(st, convert.msgs_from_numpy(ib, device="cpu"),
                            {})
        o = as_numpy(out)
        rows = [(int(o["dest"][n, k]), PS.T_MERGE, int(o["a"][n, k]),
                 int(o["b"][n, k]), int(o["c"][n, k]))
                for n, k in zip(*np.nonzero(o["valid"]))
                if o["type"][n, k] == PS.T_MERGE]
    kv = st["kv"].numpy()
    assert (kv[:, 3] == 8).all() and (kv[:, 5] == 3).all()    # value+1
    assert not any(p.any() for p in prog.quiet_planes(st))


# --- the services cluster's rounds and scan ---------------------------------

def _cluster(n=5, roles=None, stall=True):
    opts = {} if roles is None else {"service_roles": roles}
    nodes = [f"n{i}" for i in range(n)]
    jprog = j_get_program("services", opts, nodes)
    pprog = p_get_program("services", opts, nodes, device="cpu")
    kw = dict(n_nodes=n, n_clients=3, pool_cap=512,
              inbox_cap=jprog.inbox_cap, client_cap=8,
              latency_mean_rounds=2.0, enable_stall=stall,
              partition_groups=n)
    return jprog, pprog, JT.NetConfig(**kw), PT.NetConfig(**kw)


def _services_plan(n, R, M, seed):
    """M client requests a round: timestamps to node 0, reads, writes
    and cas to the seq-kv node and the lww-kv replicas (keys repeated,
    cas words that hit and miss)."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, n, (R, M))
    kv_t = rng.choice(np.array([10, 12, 14]), (R, M))
    return {"valid": rng.random((R, M)) < 0.7,
            "src": (n + rng.integers(0, 3, (R, M))).astype(np.int32),
            "dest": dest.astype(np.int32),
            "due": np.zeros((R, M), np.int32),
            "mid": np.zeros((R, M), np.int32),
            "reply_to": np.full((R, M), -1, np.int32),
            "type": np.where(dest == 0, PS.T_TS, kv_t).astype(np.int32),
            "a": rng.integers(0, 4, (R, M), dtype=np.int32),
            "b": rng.integers(0, 4, (R, M), dtype=np.int32),
            "c": rng.integers(0, 4, (R, M), dtype=np.int32)}


@pytest.mark.parametrize("faults", [{}, {"down": 0.3, "p_loss": 0.05,
                                         "grudge": "split_half"}],
                         ids=["clean", "faults"])
def test_services_rounds_match_jax(faults):
    jprog, pprog, jcfg, pcfg = _cluster()
    n = jcfg.n_nodes
    jsim = j_make_sim(jprog, jcfg, seed=21)
    start = jax_tree_to_numpy(jsim)
    jsim = jsim.replace(net=_install(JT, jsim.net, faults, n, 3))
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    psim = psim.replace(net=_install(PT, psim.net, faults, n, 3))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    plan = _services_plan(n, 24, 4, seed=5)
    jsim, jmsgs = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in plan.items()}))
    psim, pmsgs = p_make_run_fn(pprog, pcfg, collect_client_msgs=True,
                                device="cpu")(
        psim, convert.msgs_from_numpy(plan, device="cpu"))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    assert_msgs_equal_on_valid(jmsgs, pmsgs)
    st = PT.stats_dict(psim.net)
    assert st["recv_all"] > 0 and st["sent_servers"] > 0   # gossip flew
    if faults:
        assert st["dropped_down"] > 0 and st["lost"] > 0
    else:
        assert (psim.nodes["lin-tso"]["ts"] > 0).all()


def test_services_scan_matches_jax():
    jprog, pprog, jcfg, pcfg = _cluster(stall=False)
    n = jcfg.n_nodes
    jsim = j_make_sim(jprog, jcfg, seed=2)
    start = jax_tree_to_numpy(jsim)
    inj = {k: v[0] for k, v in _services_plan(n, 1, 3, seed=8).items()}
    inj["valid"][:] = True
    kw = {"reply_cap": 16, "journal_cap": None}
    out_j = j_make_scan_fn(jprog, jcfg, **kw)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in inj.items()}),
        jnp.int32(30), False)
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    out_p = p_make_scan_fn(pprog, pcfg, device="cpu", chunk=8, **kw)(
        psim, convert.msgs_from_numpy(inj, device="cpu"), 30, False)
    assert out_p[2] == int(out_j[2]) == 30
    assert_trees_equal(jax_tree_to_numpy(out_j[0]), as_numpy(out_p[0]))
    for a, b in zip(out_j[3][:2], out_p[3][:2]):
        assert_trees_equal(as_numpy(a), as_numpy(b))
    assert int(out_p[3][3]) == int(out_j[3][3]) > 0


# --- the lin-tso workload, end to end ---------------------------------------

def _history(store):
    d = os.path.realpath(os.path.join(store, "latest"))
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        return f.read()


# tier 1: a second of virtual time at 5 ms a round
TSO_BASE = {"workload": "lin-tso", "node": "tpu:services", "seed": 7,
            "rate": 20.0, "ms_per_round": 5.0}
RUNS = {
    "tso5": {**TSO_BASE, "time_limit": 1.0},
    "tso5-targeted": {**TSO_BASE, "time_limit": 1.0,
                      "nemesis": {"kill", "pause", "partition"},
                      "nemesis_targets": "kill=lww-kv,pause=lin-tso",
                      "nemesis_interval": 0.3, "recovery_s": 0.3,
                      "timeout_ms": 1000, "telemetry": "auto"},
}


def _both(opts, tmp_path):
    jres = jcore.run({**opts, "store_root": str(tmp_path / "jax"),
                      "no_overlap": True, "audit": False,
                      "audit_trace": False})
    pres = pcore.run({**opts, "store_root": str(tmp_path / "port"),
                      "device": "cpu"})
    return jres, pres, _history(str(tmp_path / "jax")), \
        _history(str(tmp_path / "port"))


@pytest.mark.parametrize("name", list(RUNS))
def test_lin_tso_runs_match_jax(name, tmp_path):
    jres, pres, jh, ph = _both(RUNS[name], tmp_path)
    assert ph == jh
    assert pres["valid"] is jres["valid"] is True
    assert pres["workload"] == jres["workload"]
    w = pres["workload"]
    assert w["monotonic"] is True and "duplicate-ts" not in w
    assert w["granted-count"] > 5
    assert pres["net"].get("telemetry") == jres["net"].get("telemetry")
    if "nemesis_targets" in RUNS[name]:
        ops = [json.loads(x) for x in ph.decode().splitlines()]
        vals = [o["value"] for o in ops if o.get("process") == "nemesis"
                and o["type"] == "info"]
        killed = [v for v in vals if v.startswith("killed")]
        paused = [v for v in vals if v.startswith("paused")]
        assert killed and paused
        assert all("n0" not in v and "n1" not in v for v in killed)
        assert all(v == "paused ['n0']" for v in paused)
        assert set(pres["net"]["telemetry"]["role-sent"]) == {
            "lin-tso", "seq-kv", "lww-kv"}


def test_node_count_from_service_roles():
    opts = {"workload": "lin-tso", "node": "tpu:services",
            "service_roles": "lin-tso=1,lww-kv=6"}
    assert pcore.parse_nodes(opts) == jcore.parse_nodes(opts) == [
        f"n{i}" for i in range(7)]
    assert len(pcore.parse_nodes({"node": "tpu:services"})) == 5
    # an explicit count wins
    assert len(pcore.parse_nodes({**opts, "node_count": 3})) == 3


# --- refusals, fault groups and targets -------------------------------------

@pytest.mark.parametrize("spec,match", [
    ("tso=1", "unknown service"), ("lin-tso=1,seq-kv=2", "single-copy"),
    ("lin-tso=2", "single-copy"), ("lin-tso=1,lww-kv=0", "must be >= 1")])
def test_service_roles_refusals_match_jax(spec, match):
    msgs = []
    for mod in (JS, PS):
        with pytest.raises(ValueError, match=match) as e:
            mod.parse_service_roles(spec)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("spec", [None, "lin-tso=1,lww-kv=2",
                                  "lin-tso=1,seq-kv=1,lww-kv=1022"])
def test_parse_service_roles_matches_jax(spec):
    assert PS.parse_service_roles(spec) == JS.parse_service_roles(spec)
    assert PS.roles_node_count(spec) == JS.roles_node_count(spec)


def test_services_fault_groups_match_jax():
    nodes = [f"n{i}" for i in range(5)]
    jg = j_get_program("services", {}, nodes).fault_groups()
    pg = p_get_program("services", {}, nodes, device="cpu").fault_groups()
    assert pg == jg == {"lin-tso": ["n0"], "seq-kv": ["n1"],
                        "lww-kv": ["n2", "n3", "n4"]}


@pytest.mark.parametrize("spec", [
    "kill=lww-kv,pause=lin-tso", "partition=seq-kv+n0", "kill=n3",
    "pause=lww-kv+lww-kv,kill=n4+lww-kv", {"kill": ["lww-kv"]},
    "kill=nope", "duplicate=lww-kv", "kill=", "kill", "kill=@sequencer",
    "kill=sequencer"])
def test_resolve_targets_matches_jax(spec):
    nodes = [f"n{i}" for i in range(5)]
    groups = p_get_program("services", {}, nodes,
                           device="cpu").fault_groups()
    out = []
    for mod in (jnem, pnem):
        try:
            out.append(("ok", mod.resolve_targets(
                spec, groups, nodes, dynamic=("sequencer",)
                if spec == "kill=sequencer" else ())))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


def test_targeted_decisions_match_jax():
    """The decision streams under targets: kill and pause sample their
    minority of the pool, a targeted partition isolates it, and a
    dynamic group expands through the executor's resolver."""
    nodes = [f"n{i}" for i in range(7)]
    targets = {"kill": ["n2", "n3", "n4", "n5", "n6"], "pause": ["n0"],
               "partition": ["@sequencer", "n1"]}
    runs = []
    for mod in (jnem, pnem):
        d = mod.NemesisDecisions(nodes, seed=11, targets=targets)
        d.resolve_dynamic = lambda tok: ["n3"]
        runs.append([(d.next_kill_targets(), d.next_pause_targets(),
                      d.next_grudge()) for _ in range(6)])
    assert runs[0] == runs[1]
    d = pnem.NemesisDecisions(nodes, targets=targets)
    with pytest.raises(ValueError, match="needs a live runner"):
        d.next_grudge()


# --- the checker ------------------------------------------------------------

def _tso_history(H, rows):
    events = []
    for p, inv, comp, ts in rows:
        events.append((inv, "invoke", p, None))
        events.append((comp, "ok", p, ts))
    h = H()
    for t, kind, p, val in sorted(events, key=lambda e: e[0]):
        h.append_row(kind, "ts", val, p, t)
    return h


@pytest.mark.parametrize("rows", [
    [(0, 0, 10, 0), (1, 20, 30, 1), (0, 25, 40, 2)],     # a witness
    [(0, 0, 10, 5), (1, 20, 30, 1)],                     # real-time order
    [(0, 0, 10, 3), (1, 20, 30, 3)],                     # duplicates
    [(0, 0, 10, 4), (1, 5, 30, 2), (2, 31, 40, 9)],
    []], ids=["witness", "realtime", "duplicate", "overlap", "empty"])
def test_tso_checker_matches_jax(rows):
    ref = JTSOChecker().check({}, _tso_history(JHistory, rows), {})
    got = PTSOChecker().check({}, _tso_history(PHistory, rows), {})
    assert got == ref
    if len(rows) == 2:
        assert got["valid"] is False


# --- the smoke's pins (slow) ------------------------------------------------

def _service_runs():
    import chip_smoke
    return dict(chip_smoke.CLI_SERVICES)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_service_runs()))
def test_pinned_service_runs(name, tmp_path):
    """Re-derives chip_smoke.py's PINNED_SERVICES: the sha256 of the JAX
    runner's history.jsonl and of its `net.telemetry` block (None with
    the ring off) for each cli_services run, and checks the port's run
    on the CPU against them."""
    import chip_smoke
    opts = _service_runs()[name]
    jres, pres, jh, ph = _both(opts, tmp_path)
    pin = chip_smoke.PINNED_SERVICES[name]
    assert jres["valid"] is True and jres["workload"]["monotonic"] is True
    assert hashlib.sha256(jh).hexdigest() == pin["history"]
    tel = jres["net"].get("telemetry")
    assert (None if tel is None else hashlib.sha256(json.dumps(
        tel, sort_keys=True).encode()).hexdigest()) == pin["telemetry"]
    assert ph == jh
    assert pres["net"].get("telemetry") == tel
