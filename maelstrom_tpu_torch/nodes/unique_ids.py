"""Batched unique-id node: ids are (node index, per-node counter) pairs
minted with no coordination (the workload of `workloads/unique_ids.py`).

Counterpart of `maelstrom_tpu/nodes/unique_ids.py`, held against it by
`tests/test_torch_pool_round.py`. A pool-path program: several
`generate` requests can reach one node in a round, so each is ranked
within its inbox row (a prefix count over the slots), minted counter + 1
+ rank, and the counter advances by the row's request count. Killed and
paused nodes (`ctx["stall"]`) keep their counter and send nothing.

`step` has a hand-written CUDA kernel, K12 `unique_ids_step`
(`csrc/pool.cu`), and the plain PyTorch version `step_plain`."""

from __future__ import annotations

import torch

from .. import kernels as K
from ..net.tpu import I32
from ..tree import resolve_device
from . import NodeProgram, freeze_step, launch_pool_step, register

T_GEN = 10
T_GEN_OK = 11


@register
class UniqueIdsProgram(NodeProgram):
    name = "unique-ids"

    def __init__(self, opts, nodes, device="cuda"):
        super().__init__(opts, nodes)
        self.device = resolve_device(device)

    def init_state(self):
        return {"counter": torch.zeros(self.n_nodes, dtype=I32,
                                       device=self.device)}

    def step_plain(self, state, inbox):
        is_gen = inbox.valid & (inbox.type == T_GEN)        # [N, K]
        # rank each request within its row so same-round requests at one
        # node mint distinct counters
        rank = torch.cumsum(is_gen, dim=1, dtype=I32) - 1
        n_idx = torch.arange(self.n_nodes, dtype=I32,
                             device=is_gen.device)[:, None]
        out = inbox.replace(
            valid=is_gen, dest=inbox.src, reply_to=inbox.mid,
            type=torch.full_like(inbox.type, T_GEN_OK),
            a=n_idx.expand(inbox.a.shape).contiguous(),
            b=state["counter"][:, None] + 1 + rank)
        return ({"counter": state["counter"]
                 + is_gen.sum(dim=1, dtype=I32)}, out)

    def step(self, state, inbox, ctx):
        """(state, inbox Msgs [N, K], ctx) -> (state', outbox Msgs [N,
        K]); ctx.get("stall") the [N] bool mask of stalled nodes."""
        stall = ctx.get("stall")
        if K.use_kernel(inbox.valid):
            counter, out = launch_pool_step(K.UNIQUE_IDS_STEP, inbox,
                                            state["counter"], stall, T_GEN,
                                            T_GEN_OK, mint=True)
            return {"counter": counter}, out
        return freeze_step(stall, state, *self.step_plain(state, inbox))

    def quiet_planes(self, state):
        """No program state keeps it busy (the JAX program has no
        `quiescent`): the runner probes the flight pool alone."""
        return []

    # --- host boundary ---

    def request_for_op(self, op):
        return {"type": "generate"}

    def encode_body(self, body, intern):
        assert body["type"] == "generate"
        return (T_GEN, 0, 0, 0)

    def decode_body(self, t, a, b, c, intern):
        if t == T_GEN_OK:
            return {"type": "generate_ok", "id": f"n{int(a)}-{int(b)}"}
        return super().decode_body(t, a, b, c, intern)

    def completion(self, op, body, read_state, intern):
        return {**op, "type": "ok", "value": body["id"]}
