"""Dataclass state containers and the helpers that walk them.

The JAX package builds its state from `flax.struct` pytrees
(`maelstrom_tpu/net/tpu.py`, `maelstrom_tpu/sim.py`). Here state is plain
`@dataclass` containers of tensors (`Struct` gives them `replace`), node
state is a plain `dict`, and absent parts are `None`. The functions below
map over such a tree, list its leaves by field path, move it between
devices and convert it to and from nested dicts of numpy arrays."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class Struct:
    """Mixin for the port's state dataclasses: `replace` returns a copy
    with some fields swapped, as `flax.struct` does."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere,
    and asking for it on a machine without a CUDA device raises: the port
    never drops to the CPU unless the caller names the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def tree_map(fn, tree, *rest):
    """Applies `fn` to every tensor leaf (and the matching leaves of
    `rest`, which share the structure) of dataclasses, dicts and tuples;
    `None` stays `None`."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *[r[i] for r in rest])
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """[(dotted field path, tensor)] in field order; `None` parts are
    skipped."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, tuple):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, value in items:
        out += leaves(value, f"{prefix}.{name}" if prefix else name)
    return out


def to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def to_numpy(tree):
    """Nested dicts of numpy arrays keyed by field name (`None` kept).
    The arrays are copies: a CPU tensor's numpy view would follow the
    channels, which rounds update in place."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return {f.name: to_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    return np.array(tree.detach().cpu().numpy())


def from_numpy(template, data, device):
    """Builds a tree shaped like `template` whose leaves come from the
    nested dict `data` (as `to_numpy` gives it), copied onto `device`.
    Every leaf must match the template's shape; the template's dtype is
    kept."""
    def put(path, t, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(t.shape)}")
        return torch.tensor(arr, device=device).to(t.dtype)

    def walk(path, tmpl, d):
        if tmpl is None:
            if d is not None:
                raise ValueError(f"{path}: the port holds no state here")
            return None
        if dataclasses.is_dataclass(tmpl):
            return type(tmpl)(**{
                f.name: walk(f"{path}.{f.name}", getattr(tmpl, f.name),
                             d[f.name])
                for f in dataclasses.fields(tmpl)})
        if isinstance(tmpl, dict):
            if set(d) != set(tmpl):
                raise ValueError(f"{path}: keys {sorted(d)} != "
                                 f"{sorted(tmpl)}")
            return {k: walk(f"{path}.{k}", v, d[k]) for k, v in tmpl.items()}
        return put(path, tmpl, d)

    return walk("", template, data)
