"""Fault packages: the nemesis-free case.

A copy of `package()` from `maelstrom_tpu/nemesis.py` for the empty
fault set, the only one this slice runs. Every fault package (partition,
kill, pause, duplicate, weather, byzantine) is ported with the fault
slice; asking for one raises."""

from __future__ import annotations


def package(faults: set, interval_s: float = 10.0):
    """{generator, final_generator, faults} for the requested fault set:
    no generators and no faults for the empty set."""
    if faults:
        raise NotImplementedError(
            f"nemesis faults {sorted(faults)} are ported with the fault "
            f"slice")
    return {"generator": None, "final_generator": None, "faults": ()}
