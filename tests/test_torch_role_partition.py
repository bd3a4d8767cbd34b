"""The port's `RolePartition` (`maelstrom_tpu_torch.sim`) against the JAX
package's, on the CPU.

- A one-role partition is pure delegation: `--node tpu:solo:<program>`
  gives the unwrapped program's history byte for byte. Held here against
  the JAX runner's unwrapped runs of lin-kv (Raft, the edge path) and
  broadcast under the kill, pause, partition and duplicate nemeses (the
  JAX package's own pins, `tests/test_role_partition.py`, at a second of
  virtual time).
- A two-role partition of pool-path programs (echo and unique-ids): its
  rounds under stalls, partitions and loss, every `SimState` leaf and
  `NetStats` counter equal to JAX's (the per-role inbox slices, lane
  pads and outbox concatenation, the stall mask sliced per role, the
  durable views and restore per role).
- The constructor's refusals with JAX's messages, `fault_groups`,
  `state_row`, literal-node nemesis targets on a program that is not a
  partition, and the CLI's scope: an elected compartment (`--roles
  sequencers=S`, S > 1) and its options pass the scope check and reach
  the program, which builds it; a later slice's option beside them is
  still refused, naming that slice.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import pytest
import torch

from maelstrom_tpu import core as jcore
from maelstrom_tpu import nemesis as jnem
from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu.nodes import get_program as j_get_program
from maelstrom_tpu.sim import RolePartition as JRolePartition
from maelstrom_tpu.sim import make_run_fn as j_make_run_fn
from maelstrom_tpu.sim import make_sim as j_make_sim
from maelstrom_tpu_torch import cli as pcli
from maelstrom_tpu_torch import convert
from maelstrom_tpu_torch import core as pcore
from maelstrom_tpu_torch import telemetry as TM
from maelstrom_tpu_torch.net import tpu as PT
from maelstrom_tpu_torch.nodes import get_program as p_get_program
from maelstrom_tpu_torch.sim import RolePartition as PRolePartition
from maelstrom_tpu_torch.sim import make_run_fn as p_make_run_fn
from test_torch_faults import _install
from test_torch_pool_round import _plan
from test_torch_support import (as_numpy, assert_msgs_equal_on_valid,
                                assert_trees_equal, jax_tree_to_numpy)

NODES5 = [f"n{i}" for i in range(5)]


# --- the one-role partition: bit-identity -----------------------------------

def test_solo_wrapper_is_role_partition():
    prog = p_get_program("solo:lin-kv", {"rate": 5, "time_limit": 1},
                         NODES5, device="cpu")
    jprog = j_get_program("solo:lin-kv", {"rate": 5, "time_limit": 1},
                          NODES5)
    assert isinstance(prog, PRolePartition) and prog.is_edge
    assert prog.fault_groups() == jprog.fault_groups() == {"r0": NODES5}
    assert prog.quiet_planes is None           # raft is never quiescent
    assert TM.role_names(prog) == ["r0"]
    assert TM.role_bounds(prog) == ((0, 5),)
    echo = p_get_program("solo:echo", {}, NODES5, device="cpu")
    assert echo.quiet_planes(echo.init_state()) == []
    assert not echo.is_edge and echo.outbox_cap == 8


SOUP = {"kill", "pause", "partition", "duplicate"}
SOLO_RUNS = {
    "lin-kv-soup": {"workload": "lin-kv", "node": "tpu:lin-kv",
                    "node_count": 5, "time_limit": 1.0, "rate": 20.0,
                    "nemesis": SOUP, "nemesis_interval": 0.25,
                    "recovery_s": 0.5, "timeout_ms": 1000,
                    "ms_per_round": 5.0, "seed": 7},
    "broadcast-soup": {"workload": "broadcast", "node": "tpu:broadcast",
                       "node_count": 5, "topology": "grid",
                       "time_limit": 1.0, "rate": 20.0, "nemesis": SOUP,
                       "nemesis_interval": 0.25, "recovery_s": 0.5,
                       "timeout_ms": 1000, "max_values": 64,
                       "ms_per_round": 5.0, "seed": 7},
}


def _history(store):
    d = os.path.realpath(os.path.join(store, "latest"))
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", list(SOLO_RUNS))
def test_solo_runs_match_unwrapped_jax(name, tmp_path):
    opts = SOLO_RUNS[name]
    jres = jcore.run({**opts, "store_root": str(tmp_path / "jax"),
                      "no_overlap": True, "audit": False,
                      "audit_trace": False})
    solo = "tpu:solo:" + opts["node"][len("tpu:"):]
    pres = pcore.run({**opts, "node": solo, "device": "cpu",
                      "store_root": str(tmp_path / "port")})
    assert _history(str(tmp_path / "port")) == \
        _history(str(tmp_path / "jax"))
    # the short lin-kv run leaves an op kind with no ok, which the stats
    # checker fails in both packages
    assert pres["valid"] == jres["valid"]
    assert pres["workload"] == jres["workload"]
    assert pres["workload"]["valid"] is True
    net = pres["net"]
    # the combined nemesis reached the wrapped program
    assert net["dropped-down"] > 0 and net["dropped-partition"] > 0
    assert net["duplicated"] > 0


# --- a two-role partition's rounds ------------------------------------------

def _two_roles(pkg_get, device=None):
    kw = {} if device is None else {"device": device}
    echo = pkg_get("echo", {}, NODES5[:2], **kw)
    uid = pkg_get("unique-ids", {}, NODES5[2:], **kw)
    cls = PRolePartition if device is not None else JRolePartition
    return cls({}, NODES5, [("echo", echo), ("ids", uid)])


@pytest.mark.parametrize("faults", [
    {}, {"down": 0.4, "paused": 0.3, "p_loss": 0.05,
         "grudge": "split_half"}], ids=["clean", "faults"])
def test_two_role_rounds_match_jax(faults):
    jprog, pprog = _two_roles(j_get_program), _two_roles(p_get_program,
                                                         "cpu")
    kw = dict(n_nodes=5, n_clients=3, pool_cap=256,
              inbox_cap=jprog.inbox_cap, client_cap=8,
              latency_mean_rounds=2.0, enable_stall=True,
              partition_groups=5)
    jcfg, pcfg = JT.NetConfig(**kw), PT.NetConfig(**kw)
    jsim = j_make_sim(jprog, jcfg, seed=17)
    start = jax_tree_to_numpy(jsim)
    jsim = jsim.replace(net=_install(JT, jsim.net, faults, 5, 4))
    psim = convert.state_from_numpy(start, pprog, pcfg, device="cpu")
    psim = psim.replace(net=_install(PT, psim.net, faults, 5, 4))
    plan = _plan(5, 30, 6, 10, seed=3)      # echo and generate share 10
    jsim, jmsgs = j_make_run_fn(jprog, jcfg, collect_client_msgs=True)(
        jsim, JT.Msgs(**{k: jnp.asarray(v) for k, v in plan.items()}))
    psim, pmsgs = p_make_run_fn(pprog, pcfg, collect_client_msgs=True,
                                device="cpu")(
        psim, convert.msgs_from_numpy(plan, device="cpu"))
    assert_trees_equal(jax_tree_to_numpy(jsim), as_numpy(psim))
    assert_msgs_equal_on_valid(jmsgs, pmsgs)
    nodes = as_numpy(psim.nodes)
    assert set(nodes) == {"echo", "ids"}
    assert nodes["echo"]["rounds"].shape == (2,)
    assert nodes["ids"]["counter"].shape == (3,)
    assert (nodes["ids"]["counter"] > 0).any()
    if faults:
        assert PT.stats_dict(psim.net)["dropped_down"] > 0
        # restart: the stall mask is sliced per role (unique-ids keeps its
        # counter, a fully durable program)
        mask = torch.tensor([True, False, True, False, True])
        st = pprog.restore(pprog.init_state(), psim.durable, psim.nodes,
                           mask)
        jst = jprog.restore(jprog.init_state(), jsim.durable, jsim.nodes,
                            jnp.asarray(mask.numpy()))
        assert_trees_equal(jax_tree_to_numpy(jst), as_numpy(st))


def test_partition_host_boundary():
    prog = _two_roles(p_get_program, "cpu")
    jprog = _two_roles(j_get_program)
    st = prog.init_state()
    st["ids"]["counter"] = torch.tensor([4, 5, 6], dtype=torch.int32)
    tree = as_numpy(st)
    assert prog.state_row(tree, 3) == {"counter": 5}
    assert prog.state_row(tree, 1) == {"rounds": 0}
    with pytest.raises(IndexError, match="outside the partition"):
        prog.state_row(tree, 5)
    # an unrouted op goes to the client tier
    assert prog.node_for_op({"f": "echo"}) == jprog.node_for_op(
        {"f": "echo"}) == 0
    assert prog.fault_groups() == jprog.fault_groups() == {
        "echo": ["n0", "n1"], "ids": ["n2", "n3", "n4"]}
    assert prog.dynamic_fault_groups() == () == jprog.dynamic_fault_groups()
    assert prog.host_state() is None
    assert prog.request_for_op({"value": "x"}) == {"type": "echo",
                                                  "echo": "x"}
    assert TM.role_bounds(prog) == ((0, 2), (2, 5))


# --- refusals ---------------------------------------------------------------

def _refusal_cases(get, kw):
    def bad_sum():
        inner = get("echo", {}, ["n0", "n1", "n2"], **kw)
        return ({}, ["n0", "n1"], [("r0", inner)])

    def multi_edge():
        raft = get("lin-kv", {}, ["n0", "n1", "n2"], **kw)
        echo = get("echo", {}, ["n3", "n4"], **kw)
        return ({}, NODES5, [("kv", raft), ("echo", echo)])

    def edge_second():
        echo = get("echo", {}, ["n0", "n1"], **kw)
        raft = get("lin-kv", {}, ["n2", "n3", "n4"], **kw)
        return ({}, NODES5, [("echo", echo), ("kv", raft)])

    def nested():
        inner = get("solo:echo", {}, ["n0", "n1"], **kw)
        echo = get("echo", {}, ["n2", "n3", "n4"], **kw)
        return ({}, NODES5, [("p", inner), ("echo", echo)])

    def empty():
        return ({}, NODES5, [])

    def flagged(attr, value, second):
        def build():
            a = get("echo", {}, ["n0", "n1"], **kw)
            b = get("unique-ids", {}, ["n2", "n3", "n4"], **kw)
            setattr(b if second else a, attr, value)
            return ({}, NODES5, [("a", a), ("b", b)])
        return build
    return {"bad-sum": bad_sum, "multi-role-edge": multi_edge,
            "edge-not-client": edge_second, "nested": nested,
            "no-roles": empty,
            "unit-words-non-client": flagged("unit_words", ((20, 1),), True),
            "state-reads-non-client": flagged("needs_state_reads", True,
                                              True),
            "state-reads-multi-role": flagged("needs_state_reads", True,
                                              False)}


@pytest.mark.parametrize("case", list(_refusal_cases(None, {})))
def test_partition_refusals_match_jax(case):
    msgs = []
    for cls, get, kw in ((JRolePartition, j_get_program, {}),
                         (PRolePartition, p_get_program, {"device": "cpu"})):
        args = _refusal_cases(get, kw)[case]()
        with pytest.raises(ValueError) as e:
            cls(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --- targets, scope ---------------------------------------------------------

def test_literal_node_targets_on_a_plain_program(tmp_path):
    """`kill=n3` scopes the kill package of a program that is not a
    partition (echo has no fault groups: a literal node name); an unknown
    group fails with JAX's message. (The runner's targeted decisions are
    held against the JAX runner's by the lin-tso runs of
    `tests/test_torch_services.py`.)"""
    opts = {"workload": "echo", "node": "tpu:echo", "node_count": 5,
            "time_limit": 0.6, "rate": 20.0, "nemesis": {"kill"},
            "nemesis_interval": 0.1, "nemesis_targets": "kill=n3",
            "timeout_ms": 200, "ms_per_round": 5.0, "seed": 3}
    pres = pcore.run({**opts, "device": "cpu",
                      "store_root": str(tmp_path / "port")})
    assert pres["valid"] is True
    ops = [json.loads(x) for x in
           _history(str(tmp_path / "port")).decode().splitlines()]
    killed = [o["value"] for o in ops if o.get("f") == "start-kill"
              and o["type"] == "info"]
    assert killed and set(killed) == {"killed ['n3']"}
    with pytest.raises(ValueError) as e:
        pcore.run({**opts, "device": "cpu", "nemesis_targets": "kill=lww-kv",
                   "store_root": str(tmp_path / "bad")})
    with pytest.raises(ValueError) as je:
        jnem.resolve_targets("kill=lww-kv", {}, NODES5)
    assert str(e.value) == str(je.value)
    assert "unknown group 'lww-kv'" in str(e.value)


def _args(*extra):
    return pcli.build_parser().parse_args(["test", *extra])


def test_cli_scope(capsys, tmp_path):
    for extra in (["-w", "lin-tso", "--node", "tpu:services"],
                  ["-w", "lin-tso", "--node", "tpu:services",
                   "--service-roles", "lin-tso=1,seq-kv=1,lww-kv=1022"],
                  ["-w", "lin-kv", "--node", "tpu:solo:lin-kv"],
                  ["-w", "echo", "--node", "tpu:solo:echo", "--nemesis",
                   "kill", "--nemesis-targets", "kill=n0"]):
        pcli.check_scope(_args(*extra))
    opts = pcli.opts_from_args(_args(
        "-w", "lin-tso", "--node", "tpu:services", "--service-roles",
        "lin-tso=1,lww-kv=2", "--nemesis-targets", "kill=lww-kv"))
    assert opts["service_roles"] == "lin-tso=1,lww-kv=2"
    assert opts["nemesis_targets"] == "kill=lww-kv"
    for extra in (["--roles", "sequencers=2,proxies=2"],
                  ["--ordering", "compartment", "--roles", "sequencers=3"],
                  ["--leader-lease-ms", "5"]):
        pcli.check_scope(_args("-w", "lin-kv", "--node", "tpu:compartment",
                               *extra))
        assert pcli.main(["test", "-w", "lin-kv", "--node", "tpu:lin-kv",
                          "--device", "cpu", "--store", str(tmp_path),
                          *extra, "--checkpoint-every", "1"]) == 2
        err = capsys.readouterr().err
        assert "checkpoint and resume" in err and "does not run it yet" in err
    with pytest.raises(pcli.ScopeError, match="tpu:solo:lin-kv"):
        pcli.check_scope(_args("-w", "lin-kv", "--node", "tpu:solo:echo"))
    prog = p_get_program("compartment", {"roles": "sequencers=2"},
                         [f"n{i}" for i in range(10)], device="cpu")
    assert prog.lay.S == 2
    assert not any(tmp_path.iterdir())
