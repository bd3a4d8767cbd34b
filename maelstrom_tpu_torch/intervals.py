"""Integer interval sets.

A dependency-free replacement for Guava's TreeRangeSet as used by the
pn-counter checker (reference `workload/pn_counter.clj:60-125`): a set of
disjoint *closed* integer ranges supporting union, shifting by a delta, and
membership. The reference uses open ranges (lower-1, upper+1) so adjacent
ranges coalesce on insert (`pn_counter.clj:72-77`); here we keep closed
ranges and merge when ranges overlap or touch (hi + 1 >= next lo), which is
equivalent.

A copy of `maelstrom_tpu/intervals.py`.
"""

from __future__ import annotations

from bisect import bisect_left


class IntervalSet:
    """A sorted set of disjoint closed integer intervals [lo, hi]."""

    def __init__(self, ranges=()):
        self.ranges: list[tuple[int, int]] = []
        for lo, hi in ranges:
            self.add(lo, hi)

    def add(self, lo: int, hi: int) -> "IntervalSet":
        """Insert closed range [lo, hi], coalescing overlapping or adjacent
        ranges (the TreeRangeSet open-range merge trick,
        `pn_counter.clj:72-77`)."""
        assert lo <= hi
        new = []
        placed = False
        for a, b in self.ranges:
            if b + 1 < lo:          # entirely left of new range
                new.append((a, b))
            elif hi + 1 < a:        # entirely right: emit pending new range
                if not placed:
                    new.append((lo, hi))
                    placed = True
                new.append((a, b))
            else:                   # overlaps/touches: absorb
                lo = min(lo, a)
                hi = max(hi, b)
        if not placed:
            new.append((lo, hi))
        self.ranges = new
        return self

    def shift(self, delta: int) -> "IntervalSet":
        """A new IntervalSet with every range translated by delta."""
        s = IntervalSet()
        s.ranges = [(a + delta, b + delta) for a, b in self.ranges]
        return s

    def union(self, other: "IntervalSet") -> "IntervalSet":
        s = IntervalSet()
        s.ranges = list(self.ranges)
        for a, b in other.ranges:
            s.add(a, b)
        return s

    def __contains__(self, x: int) -> bool:
        i = bisect_left(self.ranges, (x + 1,)) - 1
        if i < 0:
            return False
        a, b = self.ranges[i]
        return a <= x <= b

    def to_vecs(self) -> list[list[int]]:
        """Closed [lower, upper] pairs (reference `pn_counter.clj:66-70`)."""
        return [[a, b] for a, b in self.ranges]

    def __eq__(self, other):
        return isinstance(other, IntervalSet) and self.ranges == other.ranges

    def __repr__(self):
        return f"IntervalSet({self.ranges})"
