"""OrderedStream: a pluggable ordering layer under the state machines.

Counterpart of `maelstrom_tpu/ordering/__init__.py` ("Stream-based
State-Machine Replication", arxiv 2106.13019): SMR split into an ordered
stream of opaque commands (the engine, a node program that needs a
cluster) and a deterministic applier replaying that stream (the
service). The port has three engines and three appliers:

    engines  (`engines.py`, adapters over the port's node programs)
      raft       the raft log (`nodes/raft.py`, kernel K10): commands
                 ride OP_TXN entries, the leader's reply carries the
                 commit position
      compartment  compartmentalized consensus, one sequencer or an
                 elected tier (`nodes/compartment.py`, kernels K23-K29):
                 commands ride WRITE slots, a completion replays the
                 best replica's applied prefix
      batched    batched atomic broadcast (`nodes/broadcast_batched.py`,
                 kernel K15): the distiller's contiguous id assignment is
                 the sequencer, id order the stream order

    appliers (`appliers.py`)
      lin-kv     read/write/cas over `services.PersistentKV` (lin-mutex
                 too: its locks ride the lin-kv RPCs)
      kafka      per-key append-only logs and committed offsets
      txn-list-append  the Raft transaction program's micro-op
                 interpreter (`nodes/txn_list_append.apply_txn`)

Selected with `--ordering raft|compartment|batched` beside the
workload's `-w`; the generator and the checker come from the workload
unchanged.

How a combination runs (`engines.StreamBoundary`): every workload op
becomes one command `[os, seq, cmd]` interned to a dense id (`seq` is
stamped on the op at its first encode, so a re-encode proposes the same
id); the engine's unchanged device program orders the id; the host
replays the committed prefix through the applier in slot order, a
command id applying at its first slot only, and completes each op with
its result. Capacity: one command per client op, bounded by the
engine's id space (raft 65,536, compartment `kv_keys` x 255, batched
`--max-values`); exhaustion
fails the op definitely (`EncodeCapacityError`)."""

from __future__ import annotations

ENGINES = ("raft", "compartment", "batched")


class Applier:
    """A deterministic state machine over an ordered command stream: the
    workload half of the SMR split, pure and host-side.

      - `command(op)` -> a JSON-serializable command for this generator
        op (called once per op; may read host session state);
      - `apply(state, cmd)` -> (state', result): pure;
      - `completed(op, result)` -> the completed history op (the op's
        single completion point);
      - `host_view()` / `restore(view)`: the session state."""

    name = "abstract"

    def __init__(self, opts: dict):
        self.opts = opts

    def init_state(self):
        raise NotImplementedError

    def command(self, op: dict):
        raise NotImplementedError

    def apply(self, state, cmd):
        raise NotImplementedError

    def completed(self, op: dict, result) -> dict:
        raise NotImplementedError

    def host_view(self):
        return None

    def restore(self, view):
        pass


def fail_completion(op: dict, code: int, text: str = "") -> dict:
    """An applier-level error result -> the completed history op, mapped
    through the error registry as a wire error is: definite codes fail,
    unknown codes stay indeterminate."""
    from ..errors import ERROR_REGISTRY
    err = ERROR_REGISTRY.get(code)
    definite = err.definite if err else False
    return {**op, "type": "fail" if definite else "info",
            "error": [err.name if err else code, text]}


def get_applier(workload: str, opts: dict) -> Applier:
    from .appliers import APPLIERS
    cls = APPLIERS.get(workload)
    if cls is None:
        raise ValueError(
            f"--ordering: no applier serves workload {workload!r}; "
            f"have {sorted(APPLIERS)}")
    return cls(opts)


def engine_program(opts: dict):
    """The engine adapter class opts['ordering'] names (raft by
    default); raises listing the engines for any other name."""
    from .engines import ENGINE_PROGRAMS
    engine = str(opts.get("ordering") or "raft")
    cls = ENGINE_PROGRAMS.get(engine)
    if cls is None:
        raise ValueError(f"--ordering {engine!r}: expected one of "
                         f"{list(ENGINES)}")
    return cls


def make_ordered(opts: dict, nodes: list, device="cuda"):
    """`--node tpu:ordered` (set by the ordering axis): the engine adapter
    named by opts['ordering'] composed with the applier serving
    opts['workload']."""
    cls = engine_program(opts)
    applier = get_applier(str(opts.get("workload") or "lin-kv"), opts)
    return cls(opts, nodes, applier, device=device)


def ordered_node_count(opts: dict) -> int | None:
    """Node count the composed program derives from its engine spec
    (`core.parse_nodes`): the compartment engine sizes the cluster from
    --roles; raft and batched leave the count to the user."""
    if str(opts.get("ordering") or "raft") == "compartment":
        from ..nodes.compartment import roles_node_count
        return roles_node_count(opts.get("roles"))
    return None
