"""Batched echo node: every `echo` is answered with an `echo_ok` carrying
the same payload (the workload of `workloads/echo.py`).

Counterpart of `maelstrom_tpu/nodes/echo.py`, held against it by
`tests/test_torch_pool_round.py`. A pool-path program: the step is a
masked relabelling of the [N, K] inbox (dest = src, reply_to = mid, the
reply's type code, the payload word passed through), and the per-node
`rounds` counter, the one state row, grows by one. Killed and paused
nodes (`ctx["stall"]`) keep their state and send nothing.

`step` has a hand-written CUDA kernel, K11 `echo_step` (`csrc/pool.cu`),
and the plain PyTorch version `step_plain`."""

from __future__ import annotations

import torch

from .. import kernels as K
from ..net.tpu import I32
from ..tree import resolve_device
from . import NodeProgram, freeze_step, launch_pool_step, register

T_ECHO = 10
T_ECHO_OK = 11


@register
class EchoProgram(NodeProgram):
    name = "echo"

    def __init__(self, opts, nodes, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)

    def init_state(self):
        # no per-node state; a placeholder row keeps the tree non-empty
        return {"rounds": torch.zeros(self.n_nodes, dtype=I32,
                                      device=self.device)}

    def step_plain(self, state, inbox):
        out = inbox.replace(
            valid=inbox.valid & (inbox.type == T_ECHO),
            dest=inbox.src, reply_to=inbox.mid,
            type=torch.full_like(inbox.type, T_ECHO_OK))
        return {"rounds": state["rounds"] + 1}, out

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [N, K], ctx) -> (state', outbox Msgs [N,
        K]); ctx.get("stall") the [N] bool mask of stalled nodes."""
        stall = ctx.get("stall")
        if K.use_kernel(inbox.valid):
            rounds, out = launch_pool_step(K.ECHO_STEP, inbox,
                                           state["rounds"], stall, T_ECHO,
                                           T_ECHO_OK)
            return {"rounds": rounds}, out
        return freeze_step(stall, state, *self.step_plain(state, inbox))

    def quiet_planes(self, state):
        """No program state keeps it busy (the JAX program has no
        `quiescent`): the runner probes the flight pool alone."""
        return []

    # --- host boundary ---

    def request_for_op(self, op):
        return {"type": "echo", "echo": op["value"]}

    def encode_body(self, body, intern):
        assert body["type"] == "echo"
        return (T_ECHO, intern.id(body["echo"]), 0, 0)

    def decode_body(self, t, a, b, c, intern):
        if t == T_ECHO_OK:
            return {"type": "echo_ok", "echo": intern.value(a)}
        return super().decode_body(t, a, b, c, intern)

    def completion(self, op, body, read_state, intern):
        return {**op, "type": "ok",
                "value": {k: v for k, v in body.items() if k != "type"}}
