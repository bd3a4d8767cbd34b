"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`).

The JAX package is the reference: a test feeds the same numpy inputs to a
JAX function and to its counterpart in `maelstrom_tpu_torch` (on the CPU,
where the port runs its kernels' plain versions) and requires exact
equality, since every value is int32 or bool."""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import torch

from maelstrom_tpu_torch.tree import leaves, to_numpy

# torch's intra-op pool defaults to every CPU in each process: under
# pytest-xdist, workers x CPUs threads spin against each other (six
# workers on 8 CPUs ran a 25 s port test in 1,211 s). Each worker gets
# its share of the CPUs.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def jax_tree_to_numpy(x):
    """A JAX state (flax struct dataclasses, dicts, arrays) as nested
    dicts of numpy arrays keyed by field name, the form
    `maelstrom_tpu_torch.convert` reads."""
    if x is None:
        return None
    if dataclasses.is_dataclass(x):
        return {f.name: jax_tree_to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: jax_tree_to_numpy(v) for k, v in x.items()}
    return np.asarray(jax.device_get(x))


def as_numpy(x):
    """Either package's tree as nested numpy dicts."""
    lv = leaves(x)
    if lv and isinstance(lv[0][1], torch.Tensor):
        return to_numpy(x)
    return jax_tree_to_numpy(x)


def assert_trees_equal(ref, got, skip=(), path=""):
    """Exact leaf-for-leaf equality of two nested numpy dicts, naming the
    first differing leaf; top-level keys in `skip` are left out."""
    if ref is None or got is None:
        assert ref is None and got is None, f"{path}: {ref!r} vs {got!r}"
        return
    if isinstance(ref, dict):
        assert set(ref) == set(got), f"{path}: {sorted(ref)} vs {sorted(got)}"
        for k in ref:
            if not path and k in skip:
                continue
            assert_trees_equal(ref[k], got[k], (), f"{path}.{k}" if path
                               else k)
        return
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, f"{path}: {ref.shape} vs {got.shape}"
    assert ref.dtype == got.dtype, f"{path}: {ref.dtype} vs {got.dtype}"
    bad = np.argwhere(ref != got)
    assert bad.size == 0, (f"{path}: {len(bad)} differences, first at "
                           f"{tuple(bad[0])}: {ref[tuple(bad[0])]} vs "
                           f"{got[tuple(bad[0])]}")


def assert_msgs_equal_on_valid(ref, got, path="msgs"):
    """Message batches equal where valid (and the valid masks equal):
    the fields of invalid rows carry no meaning."""
    ref, got = as_numpy(ref), as_numpy(got)
    assert_trees_equal(ref["valid"], got["valid"], path=f"{path}.valid")
    m = np.asarray(ref["valid"])
    for k in ref:
        assert_trees_equal(np.asarray(ref[k])[m], np.asarray(got[k])[m],
                           path=f"{path}.{k}")
